"""Port parity: the media readers (``media/y4m.py``, ``wav.py``,
``image.py``), the file sources (``elements/media_src.py``) and the
flexible-tensor header against the JAX package's, on the CPU.

Mirrors ``tests/test_media_ingest.py``: video (RGB, BGRx and GRAY8 at
widths whose rows need 4-byte padding, ``frames-per-tensor``,
``num-buffers``, ``loop``), audio, text, octet and image sources through
``tensor_converter``.  Tolerance: exact everywhere (file bytes, RGB, PCM,
text and octet payloads are integers or raw bytes).
"""

import sys

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
from nnstreamer_tpu.core.types import TensorSpec as JaxSpec
from nnstreamer_tpu.core.types import pack_flex_header as jax_pack
from nnstreamer_tpu.media import image as jax_image
from nnstreamer_tpu.media import wav as jax_wav
from nnstreamer_tpu.media import y4m as jax_y4m
from nnstreamer_tpu.pipeline import make_element as jax_make
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.core.types import (
    FlexHeaderTruncated,
    TensorSpec,
    pack_flex_header,
    unpack_flex_header,
)
from nnstreamer_tpu_torch.media import image, wav, y4m
from nnstreamer_tpu_torch.pipeline import make_element, parse_pipeline
from torch_parity import both

torch.set_num_threads(2)


def _frames(h, w, n=3, seed=0):
    return list(np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8))


def _y4m(tmp_path, h, w, n=3, seed=0):
    path = str(tmp_path / f"v{h}x{w}.y4m")
    jax_y4m.write_y4m(path, _frames(h, w, n, seed))
    return path


def test_y4m_writer_and_reader_bytes_equal_jax(tmp_path):
    frames = _frames(6, 10, n=4, seed=1)
    jax_y4m.write_y4m(str(tmp_path / "j.y4m"), frames)
    y4m.write_y4m(str(tmp_path / "p.y4m"), iter(frames))
    assert (tmp_path / "j.y4m").read_bytes() == (tmp_path / "p.y4m").read_bytes()
    with y4m.Y4MReader(str(tmp_path / "p.y4m")) as r, \
            jax_y4m.Y4MReader(str(tmp_path / "p.y4m")) as j:
        assert (r.width, r.height, r.framerate) == (j.width, j.height, j.framerate)
        got, want = list(r.frames_rgb()), list(j.frames_rgb())
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(2)
    planes = (rng.integers(0, 256, (6, 10), dtype=np.uint8),
              rng.integers(0, 256, (3, 5), dtype=np.uint8),
              rng.integers(0, 256, (3, 5), dtype=np.uint8))
    np.testing.assert_array_equal(y4m.i420_to_rgb(*planes), jax_y4m.i420_to_rgb(*planes))
    for a, b in zip(y4m.rgb_to_i420(frames[0]), jax_y4m.rgb_to_i420(frames[0])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="even"):
        y4m.rgb_to_i420(frames[0][:5])


@pytest.mark.parametrize("dtype,channels", [(np.int16, 2), (np.uint8, 1), (np.int32, 1)])
def test_wav_bytes_equal_jax(tmp_path, dtype, channels):
    info = np.iinfo(dtype)
    pcm = np.random.default_rng(3).integers(info.min, info.max, (700, channels), dtype=dtype)
    wav.write_wav(str(tmp_path / "p.wav"), pcm, 8000)
    jax_wav.write_wav(str(tmp_path / "j.wav"), pcm, 8000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    rate, ch, fmt, data = wav.read_wav(str(tmp_path / "p.wav"))
    assert (rate, ch, fmt) == jax_wav.read_wav(str(tmp_path / "p.wav"))[:3]
    np.testing.assert_array_equal(data, pcm)


@pytest.mark.parametrize("fmt", ["RGB", "BGRx", "GRAY8"])
@pytest.mark.parametrize("width", [6, 10, 8])
def test_videofilesrc_formats_and_widths(tmp_path, fmt, width):
    path = _y4m(tmp_path, 4, width)
    (got, _), = both(f"videofilesrc location={path} format={fmt} ! tensor_converter "
                     "! tensor_sink name=out").values()
    channels = {"RGB": 3, "BGRx": 4, "GRAY8": 1}[fmt]
    assert len(got) == 3 and got[0].tensors[0].shape == (4, width, channels)
    assert "media" not in got[0].meta
    with jax_y4m.Y4MReader(path) as r:
        rgb = next(r.frames_rgb())
    if fmt == "RGB":
        np.testing.assert_array_equal(got[0].tensors[0], rgb)


def test_videofilesrc_frames_per_tensor_num_buffers_and_loop(tmp_path):
    path = _y4m(tmp_path, 4, 6, n=3)
    (got, _), = both(f"videofilesrc location={path} ! tensor_converter frames-per-tensor=2 "
                     "! tensor_sink name=out").values()
    assert len(got) == 1 and got[0].tensors[0].shape == (2, 4, 6, 3)
    (got, _), = both(f"videofilesrc location={path} num-buffers=2 ! tensor_converter "
                     "! tensor_sink name=out").values()
    assert len(got) == 2
    (got, _), = both(f"videofilesrc location={path} loop=true num-buffers=7 ! tensor_converter "
                     "! tensor_sink name=out").values()
    assert len(got) == 7 and [f.pts for f in got] == pytest.approx([i / 30 for i in range(7)])
    np.testing.assert_array_equal(got[3].tensors[0], got[0].tensors[0])


def test_videofilesrc_negotiates_the_static_schema(tmp_path):
    path = _y4m(tmp_path, 8, 6)
    pipe = parse_pipeline(f"videofilesrc location={path} ! tensor_converter name=c "
                          "! tensor_sink name=out")
    pipe.start()
    try:
        spec = pipe["c"].srcpads[0].spec
        assert spec.is_static and spec.tensors[0].shape == (8, 6, 3)
        pipe.wait(timeout=30)
    finally:
        pipe.stop()


def test_audiofilesrc_frames_the_pcm(tmp_path):
    t = np.arange(4096, dtype=np.float32)
    stereo = np.stack([np.sin(t / 9) * 12000, np.sin(t / 5) * 9000], axis=1).astype(np.int16)
    path = str(tmp_path / "a.wav")
    jax_wav.write_wav(path, stereo, 8000)
    (got, _), = both(f"audiofilesrc location={path} samples-per-buffer=512 num-buffers=6 "
                     "! tensor_converter ! tensor_sink name=out").values()
    assert len(got) == 6 and got[1].pts == 512 / 8000
    for i, f in enumerate(got):
        np.testing.assert_array_equal(f.tensors[0], stereo[i * 512:(i + 1) * 512])


def test_textfilesrc_fixed_framing(tmp_path):
    path = tmp_path / "t.txt"
    path.write_bytes(b"hello\nworld-is-long\r\nx\n")
    (got, _), = both(f"textfilesrc location={path} ! tensor_converter input-dim=8 "
                     "input-type=uint8 set-timestamp=false ! tensor_sink name=out").values()
    assert [bytes(f.tensors[0]) for f in got] == [b"hello\0\0\0", b"world-is", b"x" + b"\0" * 7]


def test_filesrc_octet_typed_reshape(tmp_path):
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    path = tmp_path / "o.bin"
    path.write_bytes(data.tobytes())
    (got, _), = both(f"filesrc location={path} blocksize=48 ! tensor_converter input-dim=4:3 "
                     "input-type=float32 set-timestamp=false ! tensor_sink name=out").values()
    np.testing.assert_array_equal(np.stack([f.tensors[0] for f in got]), data)
    path.write_bytes(b"\0" * 10)
    pipe = parse_pipeline(f"filesrc location={path} blocksize=10 ! tensor_converter "
                          "input-dim=3:4 input-type=float32 ! tensor_sink name=out")
    pipe.start()
    with pytest.raises(Exception, match="octet payload"):
        pipe.wait(timeout=30)
    pipe.stop()


def _pngs(tmp_path, n=3, size=(6, 10)):
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 255, (*size, 3), np.uint8) for _ in range(n)]
    for i, img in enumerate(imgs):
        jax_image.write_image(str(tmp_path / f"img_{i:02d}.png"), img)
    return imgs


@pytest.mark.parametrize("location", ["img_*.png", "img_%02d.png", "comma"])
@pytest.mark.parametrize("fmt", ["RGB", "GRAY8"])
def test_imagefilesrc_locations(tmp_path, location, fmt):
    imgs = _pngs(tmp_path)
    loc = (",".join(str(tmp_path / f"img_{i:02d}.png") for i in range(3)) if location == "comma"
           else str(tmp_path / location))
    (got, want), = both(f"imagefilesrc location={loc} format={fmt} ! tensor_converter "
                     "! tensor_sink name=out").values()
    assert len(got) == 3 and got[1].meta["filename"].endswith("img_01.png")
    assert [f.meta["filename"] for f in got] == [f.meta["filename"] for f in want]
    if fmt == "RGB":
        for f, img in zip(got, imgs):
            np.testing.assert_array_equal(f.tensors[0], img)
    else:
        assert got[0].tensors[0].shape == (6, 10, 1)


def test_image_codec_and_mixed_sizes(tmp_path):
    img = np.random.default_rng(0).integers(0, 255, (5, 7, 3), np.uint8)
    image.write_image(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(image.read_image(str(tmp_path / "x.png")), img)
    np.testing.assert_array_equal(image.read_image(str(tmp_path / "x.png"), "GRAY8"),
                                  jax_image.read_image(str(tmp_path / "x.png"), "GRAY8"))
    image.write_image(str(tmp_path / "y.png"), img[:4])
    pipe = parse_pipeline(f"imagefilesrc location={tmp_path}/*.png ! tensor_converter "
                          "! tensor_sink name=out")
    pipe.start()
    with pytest.raises(Exception, match="static schema"):
        pipe.wait(timeout=30)
    pipe.stop()


def test_image_paths_raise_without_pillow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="requires Pillow"):
        image.read_image(str(tmp_path / "x.png"))
    with pytest.raises(RuntimeError, match="requires Pillow"):
        jax_image.read_image(str(tmp_path / "x.png"))


@pytest.mark.parametrize("shape,dtype", [((2, 3), np.float32), ((), np.int64), ((5,), np.uint8)])
def test_flex_header_bytes_equal_jax_and_convert(shape, dtype):
    head = pack_flex_header(TensorSpec(shape, dtype))
    assert head == jax_pack(JaxSpec(shape, dtype))
    assert unpack_flex_header(head) == (TensorSpec(shape, dtype), len(head))
    x = np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
    got = []
    for make, frame in ((make_element, TensorFrame), (jax_make, JaxFrame)):
        el = make("tensor_converter")
        el.start()
        got.append(el.handle_frame(0, frame([head + x.tobytes()], pts=0.0))[0][1].tensors[0])
    for g in got:
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    with pytest.raises(FlexHeaderTruncated):
        unpack_flex_header(head[:-1])
    with pytest.raises(ValueError, match="magic"):
        unpack_flex_header(b"\0" + head[1:])


def test_flex_payload_beside_a_torch_tensor():
    """Only the byte payload is decoded; the torch tensor beside it passes
    as it is."""
    el = make_element("tensor_converter")
    el.start()
    frame = TensorFrame([pack_flex_header(TensorSpec((2,), np.int32)) + np.int32([4, 5]).tobytes(),
                         torch.ones(3)])
    out = el.handle_frame(0, frame)[0][1]
    np.testing.assert_array_equal(out.tensors[0], [4, 5])
    assert isinstance(out.tensors[1], torch.Tensor)
