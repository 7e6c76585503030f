"""Port parity: the ``.onnx`` importer (``importers/onnx_reader.py``,
``importers/onnx_lower.py``, ``backends/onnx_import.py``) against the JAX
package's, on the CPU.

* readers: the same model from both packages' readers for the JAX tests'
  hand-encoded files, every file ``tests/torch_model_files.py`` writes
  here, and corrupted bytes (both refuse, or both read the same model);
* ops: one case per op of ``_OP_IMPLS``, written to a file, read and lowered
  by both packages, outputs within the JAX tests' ``rtol=1e-4, atol=1e-4``
  (integers exact), and folded two frames deep against frame by frame;
* the JAX tests' models (MLP, CNN, shape chain, attention block, QDQ) and a
  32x32 MobileNet-v2 file from the zoo model: outputs as the JAX package's;
* pipelines: the ONNX CNN through ``framework=onnx`` labels as the JAX
  pipeline does;
* C5: the shape chain folds from shapes, with no host copy per call.
"""

import sys
import zlib
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import test_onnx_import as jt  # noqa: E402
import torch_model_files as mf  # noqa: E402

from nnstreamer_tpu.importers import onnx_lower as jl  # noqa: E402
from nnstreamer_tpu.importers.onnx_reader import read_onnx as jax_read  # noqa: E402
from nnstreamer_tpu_torch.backends import _importer_common as ic  # noqa: E402
from nnstreamer_tpu_torch.importers import onnx_lower as tl  # noqa: E402
from nnstreamer_tpu_torch.importers.onnx_reader import (  # noqa: E402
    OnnxModel, OnnxNode, OnnxParseError, OnnxValueInfo, read_onnx)

torch.set_num_threads(2)

RTOL = ATOL = 1e-4


def _same_value(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same_value(x, y) for x, y in zip(a, b))
    return a == b or (a != a and b != b)  # NaN attributes compare equal


def same_model(a, b) -> None:
    assert (a.ir_version, a.opset) == (b.ir_version, b.opset)
    assert [(v.name, v.dtype, v.shape) for v in a.inputs] == [
        (v.name, v.dtype, v.shape) for v in b.inputs]
    assert [(v.name, v.dtype, v.shape) for v in a.outputs] == [
        (v.name, v.dtype, v.shape) for v in b.outputs]
    assert list(a.initializers) == list(b.initializers)
    for k in a.initializers:
        assert _same_value(a.initializers[k], b.initializers[k]), k
    assert len(a.nodes) == len(b.nodes)
    for s, t in zip(a.nodes, b.nodes):
        assert (s.op_type, s.inputs, s.outputs, s.name) == (t.op_type, t.inputs, t.outputs, t.name)
        assert list(s.attrs) == list(t.attrs)
        for k in s.attrs:
            assert _same_value(s.attrs[k], t.attrs[k]), (s.op_type, k)


def read_both(blob: bytes):
    got, want = read_onnx(blob), jax_read(blob)
    same_model(got, want)
    return got, want


def assert_outputs(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(g.astype(np.float64), w.astype(np.float64))


def both(blob: bytes, *xs):
    """Read and lower ``blob`` in both packages (the JAX one jitted) and
    compare the outputs on ``xs``; returns the port's."""
    got_m, want_m = read_both(blob)
    got = tl.lower_onnx(got_m)(*xs)
    assert_outputs(got, jl.lower_onnx(want_m)(*xs))
    return got


# -- readers ---------------------------------------------------------------------

def test_readers_agree_on_the_jax_tests_files():
    for blob in (jt.build_mlp()[0], jt.build_cnn()[0], jt.build_shape_chain()):
        read_both(blob)
        read_both(mf.onnx_bytes(read_onnx(blob)))  # the struct writer round trip


def test_rejects_garbage():
    for blob in (b"\xff" * 11, b"TFL3 is not onnx...."):
        with pytest.raises(OnnxParseError):
            read_onnx(blob)


def test_fuzzed_bytes_refused_or_read_alike():
    rng = np.random.default_rng(0)
    blob, _ = jt.build_mlp()
    for _ in range(300):
        buf = bytearray(blob)
        for _ in range(rng.integers(1, 12)):
            buf[rng.integers(0, len(buf))] = rng.integers(0, 256)
        try:
            got = read_onnx(bytes(buf))
        except OnnxParseError:
            got = None
        try:
            want = jax_read(bytes(buf))
        except Exception:  # noqa: BLE001 -- the JAX reader's own refusal
            want = None
        assert (got is None) == (want is None)
        if got is not None:
            same_model(got, want)


# -- the JAX tests' models -------------------------------------------------------------

def test_jax_tests_models_as_jax():
    rng = np.random.default_rng(2)
    both(jt.build_mlp()[0], rng.standard_normal((1, 8)).astype(np.float32))
    both(jt.build_cnn()[0], rng.standard_normal((1, 3, 16, 16)).astype(np.float32))
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    (y,) = both(jt.build_shape_chain(), x)
    np.testing.assert_array_equal(y.numpy(), x.reshape(2, 12))


def test_attention_block_and_qdq_as_jax():
    """The JAX tests' attention block and QDQ graphs, captured where they
    call the JAX lowering, then run through both packages."""
    blobs = []
    real = jt.read_onnx

    def grab(blob):
        blobs.append(blob)
        return real(blob)

    with mock.patch.object(jt, "read_onnx", grab):
        jt.TestTransformerBlock().test_attention_block_matches_torch()
        jt.TestQDQ().test_qdq_roundtrip_on_grid()
        jt.TestQDQ().test_qdq_conv_sandwich()
    rng = np.random.default_rng(3)
    both(blobs[0], rng.standard_normal((5, 8)).astype(np.float32))
    both(blobs[1], ((np.arange(8) * 30) - 5.0).astype(np.float32) * 0.5)
    both(blobs[2], rng.standard_normal((1, 3, 8, 8)).astype(np.float32))


def test_data_dependent_shape_refused():
    nodes = [OnnxNode("Cast", ["x"], ["xi"], attrs={"to": 7}),
             OnnxNode("Reshape", ["x", "xi"], ["y"])]
    m = OnnxModel(8, 13, nodes, {}, [OnnxValueInfo("x", "float32", (2,))],
                  [OnnxValueInfo("y", "float32", (2,))])
    with pytest.raises(tl.OnnxLowerError, match="must be known"):
        tl.lower_onnx(read_onnx(mf.onnx_bytes(m)))(np.ones(2, np.float32))


def test_unsupported_op_named_at_load():
    m = OnnxModel(8, 13, [OnnxNode("NonMaxSuppression", ["x"], ["y"])], {},
                  [OnnxValueInfo("x", "float32", (1,))], [OnnxValueInfo("y", "float32", (1,))])
    with pytest.raises(tl.OnnxLowerError, match="NonMaxSuppression"):
        tl._Lowering(m)


# -- one case per op ---------------------------------------------------------------------

def X(shape, dtype="float32", kind="normal"):
    return ("x", tuple(shape), dtype, kind)


def I(array):  # noqa: E743 -- an initializer
    return ("c", np.asarray(array))


def _rand(rng, shape, dtype, kind):
    if dtype == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "positive":
        return np.abs(x) + 0.5
    if kind == "round":
        return np.round(x * 2).astype(np.float32)
    return x


def case(op_type, ins, n_out=1, out_dtype="float32", extra=None, opset=13, **attrs):
    rng = np.random.default_rng(zlib.crc32((extra or op_type).encode()))
    inputs, inits, names, data = [], {}, [], []
    for j, spec in enumerate(ins):
        if spec is None:
            names.append("")
        elif spec[0] == "x":
            _, shape, dtype, kind = spec
            names.append(f"in{j}")
            inputs.append(OnnxValueInfo(f"in{j}", dtype, shape))
            data.append(_rand(rng, shape, dtype, kind))
        else:
            names.append(f"c{j}")
            inits[f"c{j}"] = spec[1]
    outs = [f"out{k}" for k in range(n_out)]
    m = OnnxModel(8, opset, [OnnxNode(op_type, names, outs, name="n0", attrs=attrs)], inits,
                  inputs, [OnnxValueInfo(o, out_dtype, None) for o in outs])
    return pytest.param(m, data, id=extra or op_type)


F32 = np.float32
R = np.random.default_rng(9)
_ACT = (1, 3, 4, 4)

OPS = [
    case("Conv", [X((1, 3, 6, 6)), I(R.standard_normal((4, 3, 3, 3)).astype(F32)),
                  I(R.standard_normal(4).astype(F32))],
         kernel_shape=[3, 3], strides=[2, 2], pads=[1, 0, 1, 2]),
    case("ConvTranspose", [X((1, 3, 4, 4)), I(R.standard_normal((3, 2, 3, 3)).astype(F32)),
                           I(R.standard_normal(2).astype(F32))],
         strides=[2, 2], pads=[1, 1, 1, 1], output_padding=[1, 1]),
    case("MaxPool", [X((1, 2, 6, 6))], kernel_shape=[2, 2], strides=[2, 2]),
    case("AveragePool", [X((1, 2, 5, 5))], kernel_shape=[3, 3], strides=[2, 2],
         pads=[1, 1, 1, 1]),
    case("GlobalAveragePool", [X((1, 3, 4, 5))]),
    case("GlobalMaxPool", [X((1, 3, 4, 5))]),
    case("Gemm", [X((2, 4)), I(R.standard_normal((5, 4)).astype(F32)),
                  I(R.standard_normal(5).astype(F32))], transB=1, alpha=0.5, beta=2.0),
    case("MatMul", [X((1, 2, 3, 4)), I(R.standard_normal((4, 5)).astype(F32))]),
    case("BatchNormalization", [X(_ACT), I(R.random(3).astype(F32) + 0.5),
                                I(R.standard_normal(3).astype(F32)),
                                I(R.standard_normal(3).astype(F32)),
                                I(R.random(3).astype(F32) + 0.5)], epsilon=1e-5),
    case("LayerNormalization", [X((2, 3, 4)), I(R.random(4).astype(F32) + 0.5),
                                I(R.standard_normal(4).astype(F32))], opset=17, axis=-1,
         epsilon=1e-5),
    case("InstanceNormalization", [X(_ACT), I(R.random(3).astype(F32) + 0.5),
                                   I(R.standard_normal(3).astype(F32))], epsilon=1e-5),
    case("LRN", [X((1, 5, 3, 3))], size=3, alpha=1e-3, beta=0.75, k=1.0),
    case("Relu", [X(_ACT)]),
    case("LeakyRelu", [X(_ACT)], alpha=0.1),
    case("PRelu", [X(_ACT), I(R.standard_normal((3, 1, 1)).astype(F32))]),
    case("Sigmoid", [X(_ACT)]),
    case("HardSigmoid", [X(_ACT)], alpha=0.3, beta=0.4),
    case("Tanh", [X(_ACT)]),
    case("Erf", [X(_ACT)]),
    case("Gelu", [X(_ACT)]),
    case("Softplus", [X(_ACT)]),
    case("Softmax", [X((1, 3, 5))], axis=1),
    case("LogSoftmax", [X((1, 3, 5))], axis=-1),
    case("Clip", [X(_ACT), I(np.array(-0.5, F32)), I(np.array(0.7, F32))]),
] + [
    case(op, [X((1, 3, 4), kind=k1), X((1, 3, 4), kind=k2)], out_dtype=dt)
    for op, k1, k2, dt in (
        ("Add", "normal", "normal", "float32"), ("Sub", "normal", "normal", "float32"),
        ("Mul", "normal", "normal", "float32"), ("Div", "normal", "positive", "float32"),
        ("Pow", "positive", "normal", "float32"), ("Min", "normal", "normal", "float32"),
        ("Max", "normal", "normal", "float32"), ("Equal", "round", "round", "bool"),
        ("Greater", "round", "round", "bool"), ("Less", "round", "round", "bool"))
] + [
    case(op, [X((1, 3, 4), kind=k)])
    for op, k in (("Sqrt", "positive"), ("Exp", "normal"), ("Log", "positive"),
                  ("Abs", "normal"), ("Neg", "normal"), ("Floor", "normal"),
                  ("Ceil", "normal"), ("Reciprocal", "positive"))
] + [
    case("Reshape", [X((1, 2, 6)), I(np.array([0, 3, -1], np.int64))]),
    case("Flatten", [X((1, 2, 3, 4))], axis=2),
    case("Transpose", [X((1, 2, 3, 4))], perm=[0, 2, 3, 1]),
    case("Concat", [X((1, 2, 3)), X((1, 2, 2))], axis=2),
    case("Shape", [X((1, 2, 3))], out_dtype="int64"),
    case("Gather", [X((1, 5, 3)), I(np.array([4, 0, 2], np.int64))], axis=1),
    case("Unsqueeze", [X((1, 3)), I(np.array([2], np.int64))]),
    case("Squeeze", [X((1, 3, 1, 2)), I(np.array([2], np.int64))]),
    case("Slice", [X((1, 6, 5)), I(np.array([1, 4], np.int64)), I(np.array([6, 0], np.int64)),
                   I(np.array([1, 2], np.int64)), I(np.array([2, -2], np.int64))]),
    case("Split", [X((1, 2, 6)), I(np.array([2, 4], np.int64))], n_out=2, axis=2),
    case("Pad", [X((1, 2, 3, 3)), I(np.array([0, 0, 1, 2, 0, 0, 2, 1], np.int64)),
                 I(np.array(0.5, F32))], mode=b"constant"),
    case("Pad", [X((1, 2, 4, 4)), I(np.array([0, 0, 1, 2, 0, 0, 2, 1], np.int64))],
         extra="Pad-reflect", mode=b"reflect"),
    case("Resize", [X((1, 2, 3, 4)), None, None, I(np.array([1, 2, 6, 7], np.int64))],
         mode=b"linear", coordinate_transformation_mode=b"half_pixel"),
    case("Upsample", [X((1, 2, 3, 3)), I(np.array([1.0, 1.0, 2.0, 2.0], F32))], mode=b"nearest"),
    case("Cast", [X((1, 4))], out_dtype="int32", to=6),
    case("ConstantOfShape", [I(np.array([2, 3], np.int64))], value=np.array([1.5], F32)),
    case("Expand", [X((1, 1, 3)), I(np.array([1, 4, 3], np.int64))]),
] + [
    case(op, [X((1, 3, 4, 2), kind="positive")], axes=[1, 2], keepdims=keep)
    for op, keep in (("ReduceMean", 1), ("ReduceSum", 0), ("ReduceMax", 1),
                     ("ReduceMin", 0), ("ReduceProd", 1))
] + [
    case("ArgMax", [X((1, 5, 3))], out_dtype="int64", axis=1, keepdims=0),
    case("Identity", [X((1, 3))]),
    case("Dropout", [X((1, 3))]),
    case("Where", [I(R.random((1, 4)) > 0.5), X((1, 4)), X((1, 4))]),
    case("QuantizeLinear", [X((1, 6)), I(np.array(0.05, F32)), I(np.array(128, np.uint8))],
         out_dtype="uint8"),
    case("DequantizeLinear", [X((1, 6), "uint8"), I(np.array(0.05, F32)),
                              I(np.array(128, np.uint8))]),
]


def test_op_cases_cover_every_op():
    assert {p.values[0].nodes[0].op_type for p in OPS} == set(jl._OP_IMPLS) == set(tl._OP_IMPLS)


@pytest.mark.parametrize("model,data", OPS)
def test_op_matches_jax(model, data):
    both(mf.onnx_bytes(model), *data)


@pytest.mark.parametrize("model,data", OPS)
def test_op_folded_equals_frame_by_frame(model, data):
    if not model.inputs:
        pytest.skip("no graph input to fold")
    lowering = tl._Lowering(model)
    module = ic.ImportedGraph(lowering, lowering.params(), [len(v.shape) for v in model.inputs])
    frames = [[x, _rand(np.random.default_rng(3), x.shape, x.dtype.name, "positive")]
              for x in data]
    with torch.inference_mode():
        got = module(*[torch.from_numpy(np.stack(f)) for f in frames])
        for b in range(2):
            assert_outputs([g[b] for g in got],
                           lowering.run(lowering.params(), *[f[b] for f in frames]))


# -- MobileNet-v2 and pipelines ------------------------------------------------------------

def test_mobilenet_file_as_jax_and_the_zoo():
    """A 32x32, width-0.35 zoo MobileNet-v2 as ``.onnx``: the port's
    lowering equals the JAX package's and the zoo model's float32 call."""
    from nnstreamer_tpu_torch.models import mobilenet_v2 as mv

    module, _, _ = mv.build({"dtype": "float32", "size": "32", "width": "0.35", "seed": "3"})
    module.eval()
    blob = mf.mobilenet_v2_onnx(module, 32, 32)
    m = read_onnx(blob)
    assert m.op_histogram() == {"Cast": 1, "Mul": 1, "Add": 11, "Transpose": 1, "Conv": 52,
                                "Clip": 35, "GlobalAveragePool": 1, "Flatten": 1, "Gemm": 1}
    x = np.random.default_rng(4).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    (y,) = both(blob, x)
    with torch.inference_mode():
        np.testing.assert_allclose(y.numpy(), module(torch.from_numpy(x)).numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_pipeline_labels_as_jax(tmp_path):
    """The JAX tests' CNN through ``framework=onnx`` and the labeling
    decoder labels frames as the JAX pipeline does (its decoder unfused:
    ROADMAP C12), the micro-batches folded."""
    from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    path = tmp_path / "cnn.onnx"
    path.write_bytes(jt.build_cnn()[0])
    frames = np.random.default_rng(5).standard_normal((8, 1, 3, 16, 16)).astype(np.float32)

    got, want = [], []
    for out, parse, extra in ((got, parse_pipeline, "accelerator=cpu ! tensor_decoder "
                               "mode=image_labeling"),
                              (want, jax_parse, "! tensor_decoder mode=image_labeling "
                               "device-fused=never")):
        pipe = parse(f"appsrc name=src ! tensor_filter framework=onnx model={path} "
                     f"max-batch=4 {extra} ! tensor_sink name=out")
        pipe.start()
        try:
            for x in frames:
                pipe["src"].push(x)
            pipe["src"].end_of_stream()
            pipe.wait(timeout=120)
        finally:
            pipe.stop()
        out += [f.meta["label_index"] for f in pipe["out"].frames]
    before = ic.FRAME_CALLS
    assert got == want and len(got) == 8 and ic.FRAME_CALLS == before


def test_shape_chain_makes_no_host_copy():
    """C5: Shape -> Gather -> Unsqueeze -> Concat -> Reshape folds from the
    tensors' shapes; no tensor comes back to the host, folded or not."""
    m = read_onnx(jt.build_shape_chain())
    lowering = tl._Lowering(m)
    module = ic.ImportedGraph(lowering, lowering.params(), [3])
    copies = []

    def counting(name):
        real = getattr(torch.Tensor, name)

        def fn(self, *a, **k):
            copies.append(name)
            return real(self, *a, **k)
        return fn

    x = torch.randn(3, 2, 3, 4)
    names = ("cpu", "numpy", "item", "tolist", "__array__")
    with mock.patch.multiple(torch.Tensor, **{n: counting(n) for n in names}):
        with torch.inference_mode():
            folded = module(x)
            single = module(x[0])
    assert copies == [] and module.foldable
    assert torch.equal(folded[0], x.reshape(3, 2, 12)) and torch.equal(single[0], x[0].reshape(2, 12))
