"""Port parity: the ``.tflite`` importer (``importers/tflite_reader.py``,
``importers/tflite_lower.py``, ``backends/tflite_import.py``) against the
JAX package's, on the CPU.

* readers: the port's ``struct`` reader and the JAX package's
  ``flatbuffers`` reader give the same model for the JAX tests' hand-built
  files, for every file ``tests/torch_model_files.py`` writes here, and for
  corrupted bytes (both refuse, or both read the same model);
* ops: one case per op of ``_OP_IMPLS``, written to a file, read and lowered
  by both packages, outputs within the JAX tests' ``rtol=1e-4, atol=1e-4``
  (integers exact), and the same case folded two frames deep against its
  frames one by one;
* the int8 route: the int32 accumulators equal the JAX package's exactly
  and the outputs too, on the JAX tests' models and on padded, strided,
  1 x 1, dense, depth-multiplier and MobileNet-v2 cases; dilation refused;
* pipelines: a 32x32, width-0.35 quantized MobileNet-v2 through
  ``framework=tflite`` with ``int8:true`` labels as the JAX pipeline does;
* C5: a lowered graph with ``SHAPE`` in it makes no host copy per call.
"""

import sys
import zlib
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import test_tflite_import as jt  # noqa: E402
import torch_model_files as mf  # noqa: E402

from nnstreamer_tpu.importers import tflite_lower as jl  # noqa: E402
from nnstreamer_tpu.importers.tflite_reader import read_tflite as jax_read  # noqa: E402
from nnstreamer_tpu_torch.backends import _importer_common as ic  # noqa: E402
from nnstreamer_tpu_torch.importers import tflite_lower as tl  # noqa: E402
from nnstreamer_tpu_torch.importers.tflite_reader import (  # noqa: E402
    QuantParams, TFLiteModel, TFLiteParseError, TFLOp, TFLTensor, read_tflite)

torch.set_num_threads(2)

RTOL = ATOL = 1e-4


def same_model(a, b) -> None:
    """Two readers' models field by field (their dataclasses differ)."""
    assert (a.version, a.description, a.inputs, a.outputs) == (
        b.version, b.description, b.inputs, b.outputs)
    assert len(a.tensors) == len(b.tensors) and len(a.ops) == len(b.ops)
    for s, t in zip(a.tensors, b.tensors):
        assert (s.index, s.name, s.shape, s.dtype, s.buffer) == (
            t.index, t.name, t.shape, t.dtype, t.buffer)
        assert (s.data is None) == (t.data is None)
        if s.data is not None:
            assert s.data.dtype == t.data.dtype and np.array_equal(s.data, t.data)
        assert (s.quant is None) == (t.quant is None)
        if s.quant is not None:
            assert np.array_equal(s.quant.scale, t.quant.scale)
            assert np.array_equal(s.quant.zero_point, t.quant.zero_point)
            assert s.quant.quantized_dimension == t.quant.quantized_dimension
    for s, t in zip(a.ops, b.ops):
        assert (s.opcode, s.inputs, s.outputs, s.options) == (
            t.opcode, t.inputs, t.outputs, t.options)


def read_both(blob: bytes):
    got, want = read_tflite(blob), jax_read(blob)
    same_model(got, want)
    return got, want


def assert_outputs(got, want, exact: bool = False) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if exact or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g.astype(np.float64), w.astype(np.float64))
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


# -- readers ---------------------------------------------------------------------


def test_readers_agree_on_the_jax_tests_files():
    read_both(jt.build_affine_tflite())
    rng = np.random.default_rng(1)
    for padding, stride in (("SAME", 2), ("VALID", 1)):
        w = rng.standard_normal((4, 3, 3, 3), np.float32)
        read_both(jt.build_conv_tflite((1, 9, 9, 3), w, np.ones(4, np.float32), padding, stride))


def test_writer_round_trips_the_jax_tests_file():
    """The struct writer's file of a model read from a flatbuffers-built
    file reads back the same."""
    m = read_tflite(jt.build_affine_tflite())
    same_model(read_tflite(mf.tflite_bytes(m)), m)


def test_rejects_garbage():
    for blob in (b"\x00" * 64, b"nope"):
        with pytest.raises(TFLiteParseError):
            read_tflite(blob)


def test_fuzzed_bytes_refused_or_read_alike():
    """Corrupted files: both readers refuse, or both read the same model;
    the port raises nothing but TFLiteParseError."""
    rng = np.random.default_rng(0)
    blob = jt.build_affine_tflite()
    for _ in range(300):
        buf = bytearray(blob)
        for _ in range(rng.integers(1, 10)):
            buf[rng.integers(8, len(buf))] = rng.integers(0, 256)
        try:
            got = read_tflite(bytes(buf))
        except TFLiteParseError:
            got = None
        try:
            want = jax_read(bytes(buf))
        except Exception:  # noqa: BLE001 -- the JAX reader's own refusal
            want = None
        assert (got is None) == (want is None)
        if got is not None:
            same_model(got, want)
    for n in (16, 64, 1024):
        buf = bytearray(rng.integers(0, 256, n, dtype=np.uint8))
        buf[4:8] = b"TFL3"
        try:
            read_tflite(bytes(buf))
        except TFLiteParseError:
            pass


# -- one case per op ------------------------------------------------------------------

def _q(scale, zp, dim=0):
    return QuantParams(np.atleast_1d(np.asarray(scale, np.float32)),
                       np.atleast_1d(np.asarray(zp, np.int64)), dim)


def A(shape, dtype="float32", quant=None, kind="normal"):
    """An activation input."""
    return ("x", tuple(shape), dtype, quant, kind)


def C(array, quant=None):
    """A constant input."""
    return ("c", np.asarray(array), quant)


def O(shape, dtype="float32", quant=None):  # noqa: E743 -- an output
    return (tuple(shape), dtype, quant)


def _rand(rng, shape, dtype, kind):
    if dtype in ("uint8", "int8"):
        lo, hi = (0, 256) if dtype == "uint8" else (-128, 128)
        return rng.integers(lo, hi, shape).astype(dtype)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "positive":
        return np.abs(x) + 0.5
    if kind == "round":  # small integers: EQUAL and FLOOR_DIV see ties
        return np.round(x * 2).astype(np.float32)
    return x


def case(opcode, ins, outs, extra=None, **options):
    """A one-op model: its tensors, then the graph inputs' data."""
    tensors, inputs, op_in, data = [], [], [], []
    rng = np.random.default_rng(zlib.crc32((extra or opcode).encode()))
    for spec in ins:
        if spec is None:
            op_in.append(-1)
            continue
        idx = len(tensors)
        if spec[0] == "x":
            _, shape, dtype, quant, kind = spec
            tensors.append(TFLTensor(idx, f"in{idx}", shape, dtype, 0, quant))
            inputs.append(idx)
            data.append(_rand(rng, shape, dtype, kind))
        else:
            arr, quant = spec[1], spec[2]
            tensors.append(TFLTensor(idx, f"c{idx}", arr.shape, arr.dtype.name, 0, quant, arr))
        op_in.append(idx)
    op_out = []
    for shape, dtype, quant in outs:
        op_out.append(len(tensors))
        tensors.append(TFLTensor(len(tensors), f"out{len(tensors)}", shape, dtype, 0, quant))
    model = TFLiteModel(3, opcode, tensors, inputs, op_out,
                        [TFLOp(opcode, op_in, op_out, dict(options))])
    return pytest.param(model, data, id=extra or opcode)


F32 = "float32"
RNG = np.random.default_rng(7)
_CONV = dict(padding="SAME", stride_w=2, stride_h=2, activation="relu6", dilation_w=1,
             dilation_h=1)
_POOL = dict(padding="SAME", stride_w=2, stride_h=2, filter_w=3, filter_h=3, activation=None)
_Q8 = _q(0.05, 128)

OPS = [
    case("CONV_2D", [A((1, 6, 6, 3)), C(RNG.standard_normal((4, 3, 3, 3)).astype(F32)),
                     C(RNG.standard_normal(4).astype(F32))], [O((1, 3, 3, 4))], **_CONV),
    case("DEPTHWISE_CONV_2D", [A((1, 5, 5, 3)), C(RNG.standard_normal((1, 3, 3, 6)).astype(F32)),
                               C(RNG.standard_normal(6).astype(F32))], [O((1, 5, 5, 6))],
         padding="SAME", stride_w=1, stride_h=1, depth_multiplier=2, activation="relu",
         dilation_w=1, dilation_h=1),
    case("TRANSPOSE_CONV", [C(np.array([1, 8, 8, 2], np.int32)),
                            C(RNG.standard_normal((2, 3, 3, 3)).astype(F32)), A((1, 4, 4, 3))],
         [O((1, 8, 8, 2))], padding="SAME", stride_w=2, stride_h=2, activation=None),
    case("FULLY_CONNECTED", [A((2, 6)), C(RNG.standard_normal((5, 6)).astype(F32)),
                             C(RNG.standard_normal(5).astype(F32))], [O((2, 5))],
         activation="relu", weights_format=0, keep_num_dims=False),
    case("AVERAGE_POOL_2D", [A((1, 5, 5, 2))], [O((1, 3, 3, 2))], **_POOL),
    case("MAX_POOL_2D", [A((1, 6, 6, 2))], [O((1, 3, 3, 2))], **dict(
        _POOL, padding="VALID", filter_w=2, filter_h=2)),
] + [
    case(op, [A((1, 4, 3), kind=kind), A((1, 4, 3), kind=kind2)], [O((1, 4, 3), dt)],
         **({"activation": None} if op in ("ADD", "SUB", "MUL", "DIV") else {}))
    for op, kind, kind2, dt in (
        ("ADD", "normal", "normal", F32), ("SUB", "normal", "normal", F32),
        ("MUL", "normal", "normal", F32), ("DIV", "normal", "positive", F32),
        ("MAXIMUM", "normal", "normal", F32), ("MINIMUM", "normal", "normal", F32),
        ("SQUARED_DIFFERENCE", "normal", "normal", F32), ("POW", "positive", "normal", F32),
        ("FLOOR_DIV", "round", "positive", F32), ("GREATER", "round", "round", "bool"),
        ("EQUAL", "round", "round", "bool"))
] + [
    case(op, [A((1, 4, 3), kind=kind)], [O((1, 4, 3))])
    for op, kind in (("RELU", "normal"), ("RELU6", "normal"), ("RELU_N1_TO_1", "normal"),
                     ("LOGISTIC", "normal"), ("TANH", "normal"), ("HARD_SWISH", "normal"),
                     ("EXP", "normal"), ("LOG", "positive"), ("SQRT", "positive"),
                     ("RSQRT", "positive"), ("SQUARE", "normal"), ("ABS", "normal"),
                     ("NEG", "normal"), ("SIN", "normal"))
] + [
    case("SOFTMAX", [A((1, 2, 5))], [O((1, 2, 5))], beta=0.5),
    case("RESHAPE", [A((1, 2, 6)), C(np.array([1, 3, -1], np.int32))], [O((1, 3, 4))],
         new_shape=[1, 3, 4]),
    case("CONCATENATION", [A((1, 2, 3)), A((1, 2, 2))], [O((1, 2, 5))], axis=2,
         activation=None),
    case("PAD", [A((1, 3, 3, 2)), C(np.array([[0, 0], [1, 2], [2, 1], [0, 0]], np.int32))],
         [O((1, 6, 6, 2))]),
    case("MIRROR_PAD", [A((1, 4, 4, 1)), C(np.array([[0, 0], [1, 2], [2, 1], [0, 0]], np.int32))],
         [O((1, 7, 7, 1))], mode="reflect"),
    case("MIRROR_PAD", [A((1, 4, 4, 1)), C(np.array([[0, 0], [1, 2], [2, 1], [0, 0]], np.int32))],
         [O((1, 7, 7, 1))], extra="MIRROR_PAD-symmetric", mode="symmetric"),
] + [
    case(op, [A((1, 3, 4, 2), kind="positive"), C(np.array([1, 2], np.int32))],
         [O((1, 1, 1, 2) if keep else (1, 2))], keep_dims=keep)
    for op, keep in (("MEAN", True), ("SUM", False), ("REDUCE_MAX", True),
                     ("REDUCE_MIN", False), ("REDUCE_PROD", True))
] + [
    case("STRIDED_SLICE", [A((1, 6, 5)), C(np.array([0, 1, 4], np.int32)),
                           C(np.array([0, 6, 0], np.int32)), C(np.array([1, 2, -2], np.int32))],
         [O((1, 3, 2))], begin_mask=1, end_mask=1, ellipsis_mask=0, new_axis_mask=0,
         shrink_axis_mask=0),
    case("SLICE", [A((1, 5, 4)), C(np.array([0, 1, 1], np.int32)),
                   C(np.array([-1, 3, 2], np.int32))], [O((1, 3, 2))]),
    case("TRANSPOSE", [A((1, 2, 3, 4)), C(np.array([0, 3, 1, 2], np.int32))],
         [O((1, 4, 2, 3))]),
    case("RESIZE_BILINEAR", [A((1, 3, 4, 2)), C(np.array([6, 7], np.int32))],
         [O((1, 6, 7, 2))], align_corners=False, half_pixel_centers=True),
    case("RESIZE_NEAREST_NEIGHBOR", [A((1, 3, 4, 2)), C(np.array([5, 9], np.int32))],
         [O((1, 5, 9, 2))], align_corners=False, half_pixel_centers=False),
    case("SQUEEZE", [A((1, 3, 1, 2))], [O((1, 3, 2))], squeeze_dims=[2]),
    case("EXPAND_DIMS", [A((1, 3, 2)), C(np.array([1], np.int32))], [O((1, 1, 3, 2))]),
    case("SHAPE", [A((1, 3, 2))], [O((3,), "int32")], out_dtype="int32"),
    case("BROADCAST_ARGS", [C(np.array([2, 1, 3], np.int32)), C(np.array([4, 1], np.int32))],
         [O((3,), "int32")]),
    case("BROADCAST_TO", [A((1, 1, 3)), C(np.array([1, 4, 3], np.int32))], [O((1, 4, 3))]),
    case("BATCH_MATMUL", [A((1, 2, 3, 4)), C(RNG.standard_normal((4, 5)).astype(F32))],
         [O((1, 2, 3, 5))]),
    case("CAST", [A((1, 4))], [O((1, 4), "int32")], in_dtype="float32", out_dtype="int32"),
    case("ARG_MAX", [A((1, 5, 3)), C(np.array([1], np.int32))], [O((1, 3), "int32")],
         output_type="int32"),
    case("ARG_MIN", [A((1, 5, 3)), C(np.array([1], np.int32))], [O((1, 3), "int64")],
         output_type="int64"),
    case("GATHER", [A((1, 5, 3)), C(np.array([4, 0, 2], np.int32))], [O((1, 3, 3))], axis=1,
         batch_dims=0),
    case("PACK", [A((1, 3)), A((1, 3))], [O((1, 2, 3))], values_count=2, axis=1),
    case("UNPACK", [A((1, 3, 2))], [O((1, 2)), O((1, 2)), O((1, 2))], num=3, axis=1),
    case("SPLIT", [C(np.array([2], np.int32)), A((1, 2, 6))], [O((1, 2, 2))] * 3,
         num_splits=3),
    case("SPLIT_V", [A((1, 7, 2)), C(np.array([2, 5], np.int32)), C(np.array([1], np.int32))],
         [O((1, 2, 2)), O((1, 5, 2))]),
    case("TILE", [A((1, 2, 3)), C(np.array([1, 2, 3], np.int32))], [O((1, 4, 9))]),
    case("SPACE_TO_DEPTH", [A((1, 4, 4, 2))], [O((1, 2, 2, 8))], block_size=2),
    case("DEPTH_TO_SPACE", [A((1, 2, 2, 8))], [O((1, 4, 4, 2))], block_size=2),
    case("L2_NORMALIZATION", [A((1, 3, 4))], [O((1, 3, 4))], activation=None),
    case("PRELU", [A((1, 3, 4)), C(RNG.standard_normal(4).astype(F32))], [O((1, 3, 4))]),
    case("LEAKY_RELU", [A((1, 3, 4))], [O((1, 3, 4))], alpha=0.2),
    case("DEQUANTIZE", [A((1, 6), "uint8", _Q8)], [O((1, 6))]),
    case("QUANTIZE", [A((1, 6))], [O((1, 6), "uint8", _Q8)]),
    # fake-quant boundaries: uint8 in and out of a quantized op
    case("ADD", [A((1, 4, 3), "uint8", _Q8), A((1, 4, 3), "uint8", _q(0.03, 100))],
         [O((1, 4, 3), "uint8", _q(0.07, 120))], extra="ADD-uint8-fake-quant", activation=None),
    case("CONV_2D", [A((1, 5, 5, 2), "uint8", _Q8),
                     C(RNG.integers(0, 256, (3, 3, 3, 2)).astype(np.uint8), _q(0.02, 131)),
                     C(RNG.integers(-300, 300, 3).astype(np.int32), _q(0.05 * 0.02, 0))],
         [O((1, 5, 5, 3), "uint8", _q(0.1, 7))], extra="CONV_2D-uint8-fake-quant",
         **dict(_CONV, stride_w=1, stride_h=1, activation=None)),
]


def test_op_cases_cover_every_op():
    ops = {p.values[0].ops[0].opcode for p in OPS}
    assert ops == set(jl._OP_IMPLS) == set(tl._OP_IMPLS)


@pytest.mark.parametrize("model,data", OPS)
def test_op_matches_jax(model, data):
    """Write the case, read it with both readers, lower it with both."""
    import jax

    got_m, want_m = read_both(mf.tflite_bytes(model))
    want = jax.jit(jl._Lowering(want_m))(*data)
    got = tl._Lowering(got_m)(*data)
    assert_outputs(got, want)


@pytest.mark.parametrize("model,data", OPS)
def test_op_folded_equals_frame_by_frame(model, data):
    """Two frames through the module folded (or, where the op mixes frames
    along axis 0, frame by frame) equal the frames one by one."""
    if not model.inputs:
        pytest.skip("no graph input to fold")
    lowering = tl._Lowering(model)
    module = ic.ImportedGraph(lowering, lowering.params(),
                              [len(model.tensors[i].shape) for i in model.inputs])
    frames = [[x, _rand(np.random.default_rng(3), x.shape, x.dtype.name, "positive")]
              for x in data]
    stacked = [torch.from_numpy(np.stack(f)) for f in frames]
    with torch.inference_mode():
        got = module(*stacked)
        for b in range(2):
            want = lowering.run(lowering.params(), *[f[b] for f in frames])
            assert_outputs([g[b] for g in got], want)


def test_folding_is_refused_where_an_op_mixes_frames():
    """A concatenation along axis 0 runs frame by frame, counted."""
    model = case("CONCATENATION", [A((1, 2)), A((1, 2))], [O((2, 2))], axis=0,
                 activation=None).values[0]
    lowering = tl._Lowering(model)
    module = ic.ImportedGraph(lowering, {}, [2, 2])
    xs = [torch.randn(3, 1, 2), torch.randn(3, 1, 2)]
    before = ic.FRAME_CALLS
    got = module(*xs)
    assert ic.FRAME_CALLS == before + 3 and not module.foldable
    assert torch.equal(got[0], torch.cat(xs, dim=1))


# -- the int8 route --------------------------------------------------------------------

def _capture(module, name, traced: bool = False):
    """Record the accumulators ``module.<name>`` (the epilogue) receives;
    ``traced``: inside a ``jax.jit`` trace, by a debug callback."""
    import jax

    accs = []
    real = getattr(module, name)

    def spy(L, env, op, acc, *args):
        if traced:
            jax.debug.callback(lambda a: accs.append(np.asarray(a)), acc, ordered=True)
        else:
            accs.append(acc.numpy())
        return real(L, env, op, acc, *args)

    return accs, mock.patch.object(module, name, spy)


def int8_both(model, x):
    """The model's int8 route in both packages (the JAX one jitted): equal
    int32 accumulators and outputs; returns the port's outputs."""
    import jax

    got_m, want_m = read_both(mf.tflite_bytes(model))
    want_acc, patch_j = _capture(jl, "_int8_epilogue", traced=True)
    got_acc, patch_t = _capture(tl, "_int8_epilogue")
    with patch_j:
        want = jax.jit(jl._Lowering(want_m, int8_compute=True))(x)
        jax.effects_barrier()
    with patch_t:
        got = tl._Lowering(got_m, int8_compute=True)(x)
    assert len(got_acc) == len(want_acc) > 0
    for g, w in zip(got_acc, want_acc):
        assert g.dtype == np.int32 and np.array_equal(g, w.astype(np.int32))
    assert_outputs(got, want, exact=True)
    return got


@pytest.mark.parametrize("name", ["_conv_model"])
def test_int8_uint8_conv_as_jax(name):
    model, q_x, *_ = getattr(jt.TestInt8Compute, name)()
    int8_both(model, q_x)


def _conv_case(kind, h, w, c, o, k, stride, padding, wdtype="uint8", zp_w=131, mult=1,
               act="relu6", in_dtype="uint8", keep=False):
    rng = np.random.default_rng(h * 100 + k * 10 + stride)
    lo, hi = (0, 256) if wdtype == "uint8" else (-127, 128)
    if kind == "DEPTHWISE_CONV_2D":
        wshape, oc = (1, k, k, c * mult), c * mult
    elif kind == "FULLY_CONNECTED":
        wshape, oc = (o, c), o
    else:
        wshape, oc = (o, k, k, c), o
    q_w = rng.integers(lo, hi, wshape).astype(wdtype)
    per_channel = wdtype == "int8"
    s_in, zp_in = 0.02, (120 if in_dtype == "uint8" else -5)
    if per_channel:
        s_w = (rng.random(oc).astype(np.float32) + 0.5) * 0.02
        wq = _q(s_w, np.zeros(oc), 3 if kind == "DEPTHWISE_CONV_2D" else 0)
    else:
        s_w = np.float32(0.05)
        wq = _q(s_w, zp_w)
    b = rng.integers(-500, 500, oc).astype(np.int32)
    bq = _q(np.float32(s_in) * np.atleast_1d(s_w), np.zeros(np.size(s_w)))
    if kind == "FULLY_CONNECTED":
        xshape = (1, h, c) if keep else (1, c)
        oshape = (1, h, oc) if keep else (1, oc)
        opts = dict(activation=act, weights_format=0, keep_num_dims=keep)
    else:
        ho = -(-h // stride) if padding == "SAME" else (h - k) // stride + 1
        wo = -(-w // stride) if padding == "SAME" else (w - k) // stride + 1
        xshape, oshape = (1, h, w, c), (1, ho, wo, oc)
        opts = dict(padding=padding, stride_w=stride, stride_h=stride, activation=act,
                    dilation_w=1, dilation_h=1)
        if kind == "DEPTHWISE_CONV_2D":
            opts["depth_multiplier"] = mult
    odt = in_dtype
    model = case(kind, [A(xshape, in_dtype, _q(s_in, zp_in)), C(q_w, wq), C(b, bq)],
                 [O(oshape, odt, _q(0.1, 7 if odt == "uint8" else -3))], **opts).values[0]
    return model, _rand(rng, xshape, in_dtype, "normal")


INT8_CASES = {
    "conv3x3-same-s1": ("CONV_2D", 7, 7, 5, 6, 3, 1, "SAME"),
    "conv3x3-same-s2-even": ("CONV_2D", 8, 8, 4, 6, 3, 2, "SAME"),
    "conv3x3-valid-s2-odd": ("CONV_2D", 9, 7, 4, 6, 3, 2, "VALID"),
    "conv1x1": ("CONV_2D", 5, 5, 16, 8, 1, 1, "SAME"),
    "conv1x1-s2": ("CONV_2D", 6, 6, 16, 8, 1, 2, "SAME"),
    "conv5x5-same-stem": ("CONV_2D", 9, 9, 3, 8, 5, 2, "SAME"),
    "dw3x3-same-s1": ("DEPTHWISE_CONV_2D", 7, 6, 5, 0, 3, 1, "SAME"),
    "dw3x3-same-s2-even": ("DEPTHWISE_CONV_2D", 8, 8, 6, 0, 3, 2, "SAME"),
    "dw3x3-valid": ("DEPTHWISE_CONV_2D", 7, 7, 6, 0, 3, 1, "VALID"),
    "dense": ("FULLY_CONNECTED", 1, 1, 12, 7, 1, 1, "SAME"),
}


@pytest.mark.parametrize("args", list(INT8_CASES.values()), ids=list(INT8_CASES))
@pytest.mark.parametrize("wdtype", ["uint8", "int8"])
def test_int8_route_accumulators_equal_jax(args, wdtype):
    """Per-tensor uint8 weights (zp_w != 0: the patch sums run) and
    per-channel symmetric int8 (zp 0) at padded, strided, 1 x 1 and dense
    shapes."""
    kind, h, w, c, o, k, s, padding = args
    model, x = _conv_case(kind, h, w, c, o, k, s, padding, wdtype=wdtype,
                          in_dtype="uint8" if wdtype == "uint8" else "int8")
    int8_both(model, x)


def test_int8_depth_multiplier_and_kept_dims():
    model, x = _conv_case("DEPTHWISE_CONV_2D", 6, 6, 3, 0, 3, 1, "SAME", mult=2)
    int8_both(model, x)
    model, x = _conv_case("FULLY_CONNECTED", 3, 1, 8, 5, 1, 1, "SAME", keep=True, act=None)
    int8_both(model, x)


def test_int8_dilation_names_the_roadmap():
    model, _ = _conv_case("CONV_2D", 7, 7, 4, 4, 3, 1, "SAME")
    model.ops[0].options.update(dilation_w=2, dilation_h=2)
    with pytest.raises(tl.TFLiteLowerError, match="ROADMAP A14"):
        tl._Lowering(model, int8_compute=True)
    tl._Lowering(model)  # the fake-quant route takes it


def test_int8_wrong_axis_per_channel_takes_fake_quant():
    model, _ = _conv_case("CONV_2D", 5, 5, 2, 2, 3, 1, "SAME", wdtype="int8", in_dtype="int8")
    model.tensors[1].quant.quantized_dimension = 3
    assert not tl._Lowering(model, int8_compute=True).int8_layers


# -- MobileNet-v2 files -------------------------------------------------------------------

@pytest.fixture(scope="module")
def mobilenet():
    from nnstreamer_tpu_torch.models import mobilenet_v2 as mv

    module, _, _ = mv.build({"dtype": "float32", "size": "32", "width": "0.35", "seed": "3"})
    frames = np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    return {spec: mf.mobilenet_v2_tflite(module.eval(), frames, spec)
            for spec in ("uint8", "int8")}


@pytest.mark.parametrize("spec", ["uint8", "int8"])
def test_mobilenet_file_int8_route_as_jax(mobilenet, spec):
    """The hosted file's op set and quantization (uint8) and TFLite's int8
    spec: the int8 route's output (53 int32 accumulators on the way)
    equals the JAX package's jitted lowering's."""
    m, want_m = read_both(mobilenet[spec])
    assert m.op_histogram() == {"CONV_2D": 36, "DEPTHWISE_CONV_2D": 17, "ADD": 10,
                                "AVERAGE_POOL_2D": 1, "RESHAPE": 1}
    x = np.random.default_rng(1).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    if spec == "int8":
        x = (x.astype(np.int16) - 128).astype(np.int8)
    accs, spy = _capture(tl, "_int8_epilogue")
    with spy:
        got = tl._Lowering(m, int8_compute=True)(x)
    assert len(accs) == 53 and all(a.dtype == np.int32 for a in accs)
    assert_outputs(got, jl.lower_tflite(want_m, int8_compute=True)(x), exact=True)
    assert got[0].dtype == (torch.uint8 if spec == "uint8" else torch.int8)


def _labels(parse, path, frames, extra="", dec=""):
    pipe = parse(f"appsrc name=src ! tensor_filter framework=tflite model={path} "
                 f"custom=int8:true max-batch=4 {extra} ! tensor_decoder mode=image_labeling "
                 f"{dec} ! tensor_sink name=out")
    pipe.start()
    try:
        for x in frames:
            pipe["src"].push(x)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
    finally:
        pipe.stop()
    return [f.meta["label_index"] for f in pipe["out"].frames]


def test_pipeline_labels_as_jax(mobilenet, tmp_path):
    """``framework=tflite custom=int8:true`` labels frames as the JAX
    package's pipeline does, the micro-batches folded (no frame-by-frame
    call).  The JAX side runs its decoder unfused: its fused device half
    labels a (1, C) output 0 (ROADMAP C12)."""
    from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    path = tmp_path / "mobilenet_v2_quant.tflite"
    path.write_bytes(mobilenet["uint8"])
    frames = np.random.default_rng(2).integers(0, 256, (8, 1, 32, 32, 3), dtype=np.uint8)
    before = ic.FRAME_CALLS
    got = _labels(parse_pipeline, path, frames, "accelerator=cpu")
    assert ic.FRAME_CALLS == before
    assert got == _labels(jax_parse, path, frames, dec="device-fused=never")


# -- C5 --------------------------------------------------------------------------------------

def test_shape_ops_make_no_host_copy():
    """A graph whose RESHAPE target comes from SHAPE and BROADCAST_ARGS
    runs, folded and per frame, without reading a tensor back to the host:
    the shapes fold from the tensors' shapes."""
    tensors = [TFLTensor(0, "x", (1, 2, 6), "float32", 0),
               TFLTensor(1, "s", (3,), "int32", 0),
               TFLTensor(2, "one", (3,), "int32", 0, None, np.array([1, 1, 1], np.int32)),
               TFLTensor(3, "b", (3,), "int32", 0),
               TFLTensor(4, "y", (1, 2, 6), "float32", 0)]
    ops = [TFLOp("SHAPE", [0], [1], {"out_dtype": "int32"}),
           TFLOp("BROADCAST_ARGS", [1, 2], [3], {}),
           TFLOp("RESHAPE", [0, 3], [4], {})]
    model = read_tflite(mf.tflite_bytes(TFLiteModel(3, "", tensors, [0], [4], ops)))
    lowering = tl._Lowering(model)
    module = ic.ImportedGraph(lowering, lowering.params(), [3])
    copies = []

    def counting(name):
        real = getattr(torch.Tensor, name)

        def fn(self, *a, **k):
            copies.append(name)
            return real(self, *a, **k)
        return fn

    names = ("cpu", "numpy", "item", "tolist", "__array__")
    x = torch.randn(4, 1, 2, 6)
    with mock.patch.multiple(torch.Tensor, **{n: counting(n) for n in names}):
        with torch.inference_mode():
            folded = module(x)
            single = module(x[0])
    assert copies == []
    assert all(isinstance(t, torch.Tensor) for t in folded + single)
    assert torch.equal(folded[0], x) and torch.equal(single[0], x[0])
    assert module.foldable
