"""Port parity: the wire codecs (``distributed/wire.py``,
``protobuf_codec.py``, ``flatbuf_codec.py``) and the serialize
decoders/converters against the JAX package's, on the CPU.

Tolerance: exact.  Encodings must be byte-equal in both directions, the
frames decoded by either package from either package's bytes equal
(tensors bit for bit, pts, seq and meta), and corrupt input must raise the
same error class in both (or decode to the same frame).
"""

import math

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
from nnstreamer_tpu.distributed import wire as jax_wire
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.distributed import wire
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_parity import both, run

torch.set_num_threads(2)

CODECS = ["flex", "protobuf", "flatbuf"]


def _cases():
    rng = np.random.default_rng(0)
    return [
        ([rng.normal(size=(2, 3)).astype(np.float32), np.int16([1, -2, 3, 4]),
          np.uint8(7)], 1.5, 7,
         {"a": 1, "deadline_ts": 5.0, "_nns_tl_rx": 1.0, "_nns_trace_src_ts": 2.0, "s": "x"}),
        ([], None, 0, {}),
        ([np.arange(6, dtype=np.int64).reshape(1, 2, 3), rng.normal(size=5).astype(np.float64)],
         0.0, 2**40, {"framerate": [30, 1], "tensor_name": "t0"}),
        ([rng.integers(0, 9, (3, 1)).astype(np.uint32), rng.normal(size=2).astype(np.float16)],
         -0.0, 1, {"nested": {"k": [1, 2]}}),
    ]


def _frames(case):
    tensors, pts, seq, meta = case
    frames = []
    for cls in (TensorFrame, JaxFrame):
        f = cls(list(tensors), pts=pts, meta=dict(meta, obj=object()))
        f.seq = seq
        frames.append(f)
    return frames


def _encoders(name):
    return wire.get_codec(name)[0], jax_wire.get_codec(name)[0]


def _same_frame(a, b, codec):
    assert len(a.tensors) == len(b.tensors)
    for x, y in zip(a.tensors, b.tensors):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert a.meta == b.meta
    if codec != "flatbuf":  # the fbs schema carries no pts or seq
        assert a.seq == b.seq
        assert (a.pts is None and b.pts is None) or math.copysign(1, a.pts) * a.pts == \
            math.copysign(1, b.pts) * b.pts


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("codec", CODECS)
def test_encodings_byte_equal_and_decode_across(codec, case):
    port_frame, jax_frame = _frames(_cases()[case])
    enc, jax_enc = _encoders(codec)
    got, want = _outcome(enc, port_frame), _outcome(jax_enc, jax_frame)
    if isinstance(want, str):  # float16 is not in nnstreamer.fbs: the same error
        assert (codec, got) == ("flatbuf", want) == ("flatbuf", "WireError")
        return
    assert isinstance(got, bytes) and got == want
    dec, jax_dec = wire.get_codec(codec)[1], jax_wire.get_codec(codec)[1]
    for a, b in ((dec(want), jax_dec(got)), (dec(got), jax_dec(want))):
        _same_frame(a, b, codec)
    if codec == "flex":
        assert wire.encode_frame(port_frame, version=1) == jax_wire.encode_frame(jax_frame, version=1)
        assert wire.frame_version(got) == 2


@pytest.mark.parametrize("codec", CODECS)
def test_torch_tensors_encode_as_their_host_arrays(codec):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    enc = wire.get_codec(codec)[0]
    f = TensorFrame([torch.from_numpy(x).t()], pts=2.0)  # a strided view
    g = TensorFrame([np.ascontiguousarray(x.T)], pts=2.0, seq=f.seq)
    assert enc(f) == enc(g)


def _outcome(dec, buf):
    try:
        return dec(buf)
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        return type(e).__name__


@pytest.mark.parametrize("codec", CODECS)
def test_corrupt_input_raises_the_same_errors(codec):
    port_frame, _ = _frames(_cases()[0])
    good = wire.get_codec(codec)[0](port_frame)
    bad = [good[:n] for n in (0, 1, 3, 5, 9, 17, len(good) // 2, len(good) - 1)]
    bad += [good + b"\0", b"\xff" * 40, bytes(range(64))]
    for pos in (0, 4, 7, 12, 20, 30, len(good) // 3, len(good) - 3):
        flipped = bytearray(good)
        flipped[pos] ^= 0x5A
        bad.append(bytes(flipped))
    dec, jax_dec = wire.get_codec(codec)[1], jax_wire.get_codec(codec)[1]
    errors = 0
    for buf in bad:
        got, want = _outcome(dec, buf), _outcome(jax_dec, buf)
        if isinstance(want, str):
            assert got == want, (codec, buf)
            errors += 1
        else:
            _same_frame(got, want, codec)
    assert errors >= 8


def test_unknown_codec_and_version():
    with pytest.raises(wire.WireError, match="unknown wire idl"):
        wire.get_codec("xml")
    with pytest.raises(wire.WireError, match="cannot encode wire version"):
        wire.encode_frame(TensorFrame([np.int8([1])]), version=3)
    assert issubclass(wire.WireCorruptionError, wire.WireError) and wire.WireCorruptionError.nns_transient


@pytest.mark.parametrize("mode", ["flexbuf", "protobuf", "flatbuf"])
def test_serialize_decoder_then_converter_round_trip(mode):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    y = np.int32([[1, 2]])
    (got, _), = both(f"appsrc name=src ! tensor_decoder mode={mode} ! tensor_converter "
                     f"mode=custom:{mode} set-timestamp=false ! tensor_sink name=out",
                     [([x, y], 0.0), ([x * 2, y], 1.0)]).values()
    assert len(got) == 2
    np.testing.assert_array_equal(got[1].tensors[0], x * 2)
    np.testing.assert_array_equal(got[0].tensors[1], y)
    # the port's encodings of numpy and torch payloads, read by the JAX decoder
    text = f"appsrc name=src ! tensor_decoder mode={mode} ! tensor_sink name=out"
    for payload in ([x, y], [torch.from_numpy(x), torch.from_numpy(y)]):
        enc = run(parse_pipeline, text, [(payload, 0.0)])["out"].frames[0]
        assert isinstance(enc.tensors[0], np.ndarray) and enc.tensors[0].dtype == np.uint8
        decoded = jax_wire.get_codec(mode.replace("flexbuf", "flex"))[1](enc.tensors[0].tobytes())
        for a, b in zip(decoded.tensors, (x, y)):
            np.testing.assert_array_equal(a, b)
