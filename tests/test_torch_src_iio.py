"""``tensor_src_iio`` in the port against the JAX package's, on the fake
sysfs trees of ``tests/test_src_iio.py``: every case there runs through
both packages' elements and the frames are equal, and the channel decode
(``[be|le]:[su]<bits>/<storage>[>><shift>]``, scale, offset) equals the
JAX decode and a numpy decode of the raw bytes over seeded random storage
words.  Tolerance: exact (float32 samples bit for bit, the sysfs writes
byte for byte).
"""

import os
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_src_iio import make_fake_iio  # noqa: E402
from nnstreamer_tpu.elements.src_iio import IIOChannel as JaxChannel  # noqa: E402
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse  # noqa: E402
from nnstreamer_tpu_torch.elements.src_iio import IIOChannel  # noqa: E402
from nnstreamer_tpu_torch.pipeline import parse_pipeline  # noqa: E402
from nnstreamer_tpu_torch.pipeline.element import ElementError  # noqa: E402

torch.set_num_threads(2)


def _capture(parse, text):
    pipe = parse(text)
    pipe.start()
    try:
        pipe.wait(timeout=30)
    finally:
        pipe.stop()
    return pipe["out"].frames


def _both(tmp_path, samples, props, tree=None):
    """The same fake tree (rebuilt per package: the element writes to it)
    captured by both packages; returns (port frames, JAX frames, base)."""
    out = []
    for name, parse in (("port", parse_pipeline), ("jax", jax_parse)):
        root = tmp_path / name
        root.mkdir()
        base, dev = (tree or make_fake_iio)(root, samples)
        out.append((_capture(parse, f"tensor_src_iio iio-base-dir={base} dev-dir={dev} "
                                    f"poll-timeout=500 {props} ! tensor_sink name=out"), base))
    (got, base), (want, _) = out
    assert len(got) == len(want)
    for g, w in zip(got, want):  # pts is the capture's wall clock: not compared
        assert len(g.tensors) == len(w.tensors)
        for a, b in zip(g.tensors, w.tensors):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    return got, base


# -- channel decode ------------------------------------------------------------------------

def test_signed_shift_mask():
    ch = IIOChannel("c", 0, "le:s12/16>>4", scale=1.0, offset=0.0)
    # raw 0xFFF0 >> 4 = 0xFFF -> signed 12-bit = -1
    assert ch.decode(np.array([0xFFF0], np.uint64))[0] == -1.0
    assert ch.decode(np.array([0x0150], np.uint64))[0] == 21.0


def test_scale_offset():
    ch = IIOChannel("c", 0, "le:u8/8", scale=0.5, offset=2.0)
    assert ch.decode(np.array([10], np.uint64))[0] == pytest.approx(6.0)


@pytest.mark.parametrize("bad", ["gibberish", "le:s12/12", "le:x/16", "le:s12/24>>0"])
def test_bad_type_string(bad):
    with pytest.raises(ElementError):
        IIOChannel("c", 0, bad)


@pytest.mark.parametrize("spec", ["le:s12/16>>4", "be:u16/16", "le:u8/8", "be:s24/32>>8",
                                  "le:s64/64", "le:u1/8>>7", "be:s10/16>>6"])
def test_decode_equals_jax_and_numpy(spec):
    """Seeded random storage words: the port's decode equals the JAX
    package's and a plain numpy decode (shift, keep `bits`, sign-extend,
    then (v + offset) * scale in float64, rounded to float32)."""
    port, jax = IIOChannel("c", 0, spec, 0.37, -3.0), JaxChannel("c", 0, spec, 0.37, -3.0)
    raw = np.random.default_rng(len(spec)).integers(
        0, 2 ** port.storage_bits, 256, dtype=np.uint64, endpoint=False) \
        if port.storage_bits < 64 else np.random.default_rng(0).integers(
            0, 2 ** 63, 256, dtype=np.uint64)
    got = port.decode(raw)
    np.testing.assert_array_equal(got, jax.decode(raw))
    v = [(int(r) >> port.shift) & ((1 << port.bits) - 1) for r in raw]
    if port.signed:
        v = [x - (1 << port.bits) if x >> (port.bits - 1) else x for x in v]
    want = ((np.array(v, np.float64) - 3.0) * 0.37).astype(np.float32)
    np.testing.assert_array_equal(got, want)


# -- the element ---------------------------------------------------------------------------

def test_merged_capture(tmp_path):
    # x raw: value v encoded as (v & 0xFFF) << 4 (12 bits shifted by 4)
    samples = [((i & 0xFFF) << 4, 100 + i) for i in range(4)]
    frames, base = _both(tmp_path, samples, "device=fake_accel buffer-capacity=2 num-buffers=2 "
                                            "frequency=200")
    assert len(frames) == 2
    t = frames[0].tensors[0]
    assert t.shape == (2, 2) and t.dtype == np.float32
    np.testing.assert_array_equal(t[0], [(0 + 2) * 0.5, (1 + 2) * 0.5])  # (raw + 2) * 0.5
    np.testing.assert_array_equal(t[1], [100, 101])
    dev = os.path.join(base, "iio:device0")
    assert open(os.path.join(dev, "sampling_frequency")).read() == "200"
    assert open(os.path.join(dev, "buffer", "enable")).read() == "0"  # stop() disables
    assert open(os.path.join(dev, "buffer", "length")).read() == "4"


def test_unmerged_per_channel(tmp_path):
    frames, _ = _both(tmp_path, [(0x10, 1), (0x20, 2)], "device-number=0 "
                      "merge-channels-data=false buffer-capacity=1 num-buffers=2")
    assert len(frames) == 2 and len(frames[0].tensors) == 2
    assert frames[0].tensors[0].shape == (1,)


def test_channel_selection(tmp_path):
    frames, base = _both(tmp_path, [(0x10, 7)], "device=fake_accel channels=in_accel_y "
                         "num-buffers=1")
    assert frames[0].tensors[0].shape == (1, 1)
    assert open(os.path.join(base, "iio:device0", "scan_elements",
                             "in_accel_x_en")).read() == "0"


def _padded_tree(root, samples):
    """s16 at 0, s64 timestamp at 8: a 16-byte record
    (iio_compute_scan_bytes' natural alignment)."""
    base = root / "sys"
    dev = base / "iio:device0"
    scan = dev / "scan_elements"
    scan.mkdir(parents=True)
    (dev / "buffer").mkdir()
    (dev / "name").write_text("padded\n")
    for name, idx, spec in (("in_accel_x", 0, "le:s16/16>>0"), ("in_timestamp", 1, "le:s64/64>>0")):
        (scan / f"{name}_en").write_text("1")
        (scan / f"{name}_index").write_text(str(idx))
        (scan / f"{name}_type").write_text(spec)
    (dev / "buffer" / "enable").write_text("0")
    devdir = root / "dev"
    devdir.mkdir()
    (devdir / "iio:device0").write_bytes(b"".join(
        struct.pack("<h", x) + b"\x00" * 6 + struct.pack("<q", t) for x, t in samples))
    return str(base), str(devdir)


def test_natural_alignment_padding(tmp_path):
    samples = [(100 + i, 10_000 + i) for i in range(3)]
    frames, _ = _both(tmp_path, samples, "device=padded buffer-capacity=3 num-buffers=1",
                      tree=_padded_tree)
    t = frames[0].tensors[0]
    np.testing.assert_array_equal(t[0], [100, 101, 102])
    np.testing.assert_array_equal(t[1], [10_000, 10_001, 10_002])


def _shared_scale_tree(root, samples):
    base, dev = make_fake_iio(root, samples)
    d = os.path.join(base, "iio:device0")
    os.remove(os.path.join(d, "in_accel_x_scale"))
    os.remove(os.path.join(d, "in_accel_x_offset"))
    with open(os.path.join(d, "in_accel_scale"), "w") as f:
        f.write("0.25")
    return base, dev


def test_shared_scale_fallback(tmp_path):
    frames, _ = _both(tmp_path, [(0x10, 4)], "device=fake_accel num-buffers=1",
                      tree=_shared_scale_tree)
    assert frames[0].tensors[0][0, 0] == 1 * 0.25  # x raw = 1, the shared scale


def test_missing_device_errors(tmp_path):
    base, dev = make_fake_iio(tmp_path, [(0, 0)])
    for parse in (parse_pipeline, jax_parse):
        pipe = parse(f"tensor_src_iio device=nope iio-base-dir={base} dev-dir={dev} "
                     "! tensor_sink name=out")
        with pytest.raises(Exception, match="IIO device not found"):
            pipe.start()
        pipe.stop()


def _two_channel_tree(root, raw):
    """``chip_smoke.py`` path p6's tree: ``le:s12/16>>4`` and ``be:u16/16`` at 2 bytes
    each, scale 0.5 / offset 2 on the first."""
    base = root / "sys"
    dev = base / "iio:device0"
    scan = dev / "scan_elements"
    scan.mkdir(parents=True)
    (dev / "buffer").mkdir()
    (dev / "name").write_text("card_accel\n")
    (dev / "in_accel_x_scale").write_text("0.5")
    (dev / "in_accel_x_offset").write_text("2")
    for name, idx, spec in (("in_accel_x", 0, "le:s12/16>>4"), ("in_accel_y", 1, "be:u16/16")):
        (scan / f"{name}_en").write_text("1")
        (scan / f"{name}_index").write_text(str(idx))
        (scan / f"{name}_type").write_text(spec)
    (dev / "buffer" / "enable").write_text("0")
    devdir = root / "dev"
    devdir.mkdir()
    (devdir / "iio:device0").write_bytes(raw.tobytes())
    return str(base), str(devdir)


def test_two_channel_tree_equals_a_numpy_decode(tmp_path):
    """Seeded raw records of path p6's tree, 64 frames of 4 samples,
    equal in both packages and to a numpy decode of the bytes."""
    rec = np.dtype([("x", "<u2"), ("y", ">u2")])
    raw = np.zeros(256, rec)
    rng = np.random.default_rng(11)
    raw["x"] = rng.integers(0, 2 ** 16, 256)
    raw["y"] = rng.integers(0, 2 ** 16, 256)
    frames, _ = _both(tmp_path, raw, "device=card_accel buffer-capacity=4 num-buffers=64",
                      tree=_two_channel_tree)
    x = (raw["x"].astype(np.int64) >> 4) & 0xFFF
    x = np.where(x >= 2048, x - 4096, x)
    want_x = ((x.astype(np.float64) + 2.0) * 0.5).astype(np.float32).reshape(64, 4)
    want_y = raw["y"].astype(np.float32).reshape(64, 4)
    assert len(frames) == 64
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(f.tensors[0], np.stack([want_x[i], want_y[i]]))
