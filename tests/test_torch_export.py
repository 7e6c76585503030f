"""Converted models as ``torch.export`` programs (``.pt2``) against the JAX
package's ``.jaxexport`` and against the port's own importers.

* the kernels as registered operators (``nns_torch::``): a fake call
  launches nothing and leaves every launch counter at 0; a traced module
  records the operators whatever device its example tensors are on;
* a 32x32, width-0.35 quantized MobileNet-v2 ``.tflite``
  (``tests/torch_model_files.py``) converted by both CLIs: the port's
  ``.pt2`` served by ``torch-cuda accelerator=cpu``, the JAX
  ``.jaxexport`` by ``jax-xla``: with ``--int8`` (integer arithmetic in
  both) outputs within ``rtol=1e-4, atol=1e-4`` (the tolerance of
  ``test_torch_tflite_import.py``; uint8 outputs: exact); in fake-quant
  (float32 convolutions summed in another order) at most one quantum
  apart on under 1% of the scores; labels equal except at counted
  near-ties (top two scores a quantum apart); the ``.pt2`` bit-equal to the port's
  ``ImportedGraph`` at micro-batch sizes 1, 3 and 4 and per frame;
  ``--int8`` bit-equal to ``framework=tflite custom=int8:true``;
* ``--fixed`` (a micro-batch frame by frame) and the refusal of a graph
  with an ``Unfoldable`` op without it;
* zoo ViT (2 layers, 32 wide, ``attn:flash``) and MobileNet-v2
  (``pallas:1``) exported with ``export_model``, equal to their modules.

Tolerance: exact unless named above.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import test_torch_tflite_import as tt  # noqa: E402
import torch_model_files as mf  # noqa: E402

from nnstreamer_tpu_torch.backends import _importer_common as ic  # noqa: E402
from nnstreamer_tpu_torch.backends.torch_cuda import (  # noqa: E402
    ExportedModule, TorchCuda, export_model)
from nnstreamer_tpu_torch.cli import convert  # noqa: E402
from nnstreamer_tpu_torch.elements.filter import detect_framework  # noqa: E402
from nnstreamer_tpu_torch.ops import flash_attention as fa  # noqa: E402
from nnstreamer_tpu_torch.ops import labeling, preprocess  # noqa: E402
from nnstreamer_tpu_torch.ops import quantize as q8  # noqa: E402
from nnstreamer_tpu_torch.pipeline import parse_pipeline  # noqa: E402

torch.set_num_threads(2)

COUNTERS = ((preprocess, "LAUNCHES"), (labeling, "LAUNCHES"), (fa, "LAUNCHES"),
            (fa, "LAUNCHES_TENSOR_CORES"), (q8, "QUANTIZE_LAUNCHES"),
            (q8, "QUANTIZE_ONEPASS_LAUNCHES"), (q8, "QUANTIZE_TWOPASS_LAUNCHES"),
            (q8, "CONV_LAUNCHES"), (q8, "CONV_GEMM_LAUNCHES"), (q8, "CONV_GATHER_LAUNCHES"),
            (q8, "DWCONV_LAUNCHES"))


def counters():
    return [getattr(m, n) for m, n in COUNTERS]


@pytest.fixture(autouse=True)
def zeroed_counters(monkeypatch):
    """Every launch counter starts each test at 0 and gets its value back
    after it, whatever tests ran before in this process."""
    for module, name in COUNTERS:
        monkeypatch.setattr(module, name, 0)


def program_ops(module: ExportedModule):
    return [str(n.target) for n in module.__dict__["_program"].graph.nodes
            if str(n.target).startswith("nns_torch.")]


# -- the operators ---------------------------------------------------------------------------

def _fake_calls():
    f, bf, u8, i8 = torch.float32, torch.bfloat16, torch.uint8, torch.int8
    return {
        "normalize_u8": (lambda e: torch.ops.nns_torch.normalize_u8(
            e((2, 8, 8, 3), u8), 2 / 255, -1.0, bf), [((2, 8, 8, 3), bf)]),
        "top1": (lambda e: torch.ops.nns_torch.top1(e((4, 1001), f)),
                 [((4,), torch.int32), ((4,), f)]),
        "top1_packed": (lambda e: torch.ops.nns_torch.top1_packed(e((4, 1001), bf)),
                        [((4, 2), f)]),
        "flash_attention": (lambda e: torch.ops.nns_torch.flash_attention(
            e((2, 197, 12, 64), bf), e((2, 197, 12, 64), bf), e((2, 197, 12, 64), bf), False),
            [((2, 197, 12, 64), bf)]),
        "flash_attention_lse": (lambda e: torch.ops.nns_torch.flash_attention_lse(
            e((2, 8, 2, 16), f), e((2, 8, 2, 16), f), e((2, 8, 2, 16), f), True),
            [((2, 8, 2, 16), f), ((2, 2, 8), f)]),
        "quantize_rows": (lambda e: torch.ops.nns_torch.quantize_rows(e((128, 96), bf)),
                          [((128, 96), i8), ((128,), f)]),
        "conv_i8 gather": (lambda e: torch.ops.nns_torch.conv_i8(
            e((2, 9, 9, 3), i8), e((2,), f), e((8, 3, 3, 3), i8), e((8,), f), 2, 1, bf, None),
            [((2, 8, 5, 5), bf)]),
        "conv_i8 depthwise": (lambda e: torch.ops.nns_torch.conv_i8(
            e((2, 8, 8, 16), i8), e((2,), f), e((16, 3, 3, 1), i8), e((16,), f), 1, 16,
            torch.int32, [1, 1, 1, 1]), [((2, 16, 8, 8), torch.int32)]),
    }


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("op", sorted(_fake_calls()))
def test_a_fake_call_launches_nothing(op, device):
    """The operators' fake implementations give the outputs' shapes and
    dtypes on the input's device and touch no launch counter, on fake
    CUDA tensors too."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    call, want = _fake_calls()[op]
    before = counters()
    with FakeTensorMode():
        out = call(lambda shape, dtype: torch.empty(shape, dtype=dtype, device=device))
    out = out if isinstance(out, (tuple, list)) else (out,)
    assert [(tuple(t.shape), t.dtype) for t in out] == want
    assert all(t.device.type == device for t in out)
    assert counters() == before == [0] * len(COUNTERS)


def test_conv_fake_is_channels_last():
    from torch._subclasses.fake_tensor import FakeTensorMode

    call, _ = _fake_calls()["conv_i8 gather"]
    with FakeTensorMode():
        out = call(lambda shape, dtype: torch.empty(shape, dtype=dtype))
    assert out.is_contiguous(memory_format=torch.channels_last)


def test_an_eager_call_equals_its_operator():
    """On the CPU the operators run the plain versions, as the wrappers do."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (2, 4, 4, 3), dtype=np.uint8))
    assert torch.equal(preprocess.normalize_u8(x),
                       torch.ops.nns_torch.normalize_u8(x, 2 / 255, -1.0, torch.bfloat16))
    logits = torch.from_numpy(rng.standard_normal((3, 11)).astype(np.float32))
    assert all(torch.equal(a, b) for a, b in zip(labeling.top1(logits),
                                                  torch.ops.nns_torch.top1(logits)))
    rows = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))
    assert all(torch.equal(a, b) for a, b in zip(q8.quantize_rows(rows),
                                                  torch.ops.nns_torch.quantize_rows(rows)))
    assert counters() == [0] * len(COUNTERS)


def test_flash_operator_backward_names_the_training_slice():
    """The operators' backward is the training slice's recompute: the
    gradients equal autograd's through ``reference_attention_lse``
    (float32, within 1e-6: the same function summed in another order)."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 1, 8)).astype(np.float32))
               for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((1, 4, 1, 8)).astype(np.float32))
    g_lse = torch.from_numpy(rng.standard_normal((1, 1, 4)).astype(np.float32))

    def grads(fn, with_lse):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = fn(*qkv)
        loss = (out * g).sum() + ((lse * g_lse).sum() if with_lse else 0)
        loss.backward()
        return [t.grad for t in qkv]

    ref = lambda q, k, v: fa.reference_attention_lse(q, k, v, causal=True)  # noqa: E731
    for op, with_lse in ((lambda q, k, v: (torch.ops.nns_torch.flash_attention(q, k, v, True),
                                           torch.zeros(1, 1, 4)), False),
                         (lambda q, k, v: torch.ops.nns_torch.flash_attention_lse(q, k, v, True),
                          True)):
        for a, b in zip(grads(op, with_lse), grads(ref, with_lse)):
            assert torch.allclose(a, b, rtol=0, atol=1e-6)


# -- the MobileNet-v2 file through both converters -------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from nnstreamer_tpu_torch.models import mobilenet_v2 as mv

    module, _, _ = mv.build({"dtype": "float32", "size": "32", "width": "0.35", "seed": "3"})
    calib = np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    d = tmp_path_factory.mktemp("export")
    src = d / "mobilenet_v2_quant.tflite"
    src.write_bytes(mf.mobilenet_v2_tflite(module.eval(), calib, "uint8"))
    out = {"tflite": src}
    for name, args in (("fq", []), ("int8", ["--int8"])):
        out[name] = d / f"mnv2_{name}.pt2"
        assert convert.main([str(src), str(out[name]), *args]) == 0
    return out


def _frames(n, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (n, 1, 32, 32, 3), dtype=np.uint8)


def _port_outputs(path, xs):
    be = TorchCuda()
    be.open(str(path), {"accelerators": ["cpu"]})
    try:
        return [o.numpy() for o in be.invoke_batch([xs])]
    finally:
        be.close()


@pytest.mark.parametrize("int8", [False, True], ids=["fake-quant", "int8"])
def test_pt2_against_the_jax_packages_jaxexport(files, tmp_path, int8):
    from nnstreamer_tpu.backends.jax_xla import JaxXla
    from nnstreamer_tpu.cli.convert import main as jax_convert

    dst = tmp_path / "m.jaxexport"
    assert jax_convert([str(files["tflite"]), str(dst)] + (["--int8"] if int8 else [])) == 0
    xs = _frames(8)
    jb = JaxXla()
    jb.open(str(dst), {})
    try:
        want = [np.asarray(o) for o in jb.invoke_batch([xs])]
    finally:
        jb.close()
    got = _port_outputs(files["int8" if int8 else "fq"], xs)
    if int8:  # integer arithmetic in both packages: the same quanta
        tt.assert_outputs(got, want)
    else:
        # float32 convolutions summed in another order (cuDNN/oneDNN against
        # XLA) move a value across a rounding boundary now and then: one
        # quantum, on a few of the 8008 scores
        diff = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32))
        assert got[0].dtype == want[0].dtype == np.uint8 and got[0].shape == want[0].shape
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    scores = want[0].reshape(8, -1).astype(np.int32)
    top2 = np.sort(scores, axis=-1)[:, -2:]
    tied = top2[:, 1] - top2[:, 0] <= (0 if int8 else 1)  # a quantum apart: a near-tie
    labels = [g.reshape(8, -1).argmax(-1) for g in (got[0], want[0])]
    assert (labels[0] == labels[1])[~tied].all() and tied.sum() <= 2


def test_pt2_is_bit_equal_to_imported_graph(files):
    from nnstreamer_tpu_torch.importers.tflite_lower import _Lowering
    from nnstreamer_tpu_torch.importers.tflite_reader import read_tflite

    model = read_tflite(str(files["tflite"]))
    lowering = _Lowering(model)
    graph = ic.ImportedGraph(lowering, lowering.params(), [4])
    program = ExportedModule(str(files["fq"])).to("cpu").eval()
    assert program.symbolic and program.in_ranks == [5]
    assert program.in_spec.tensors[0].shape == (1, 32, 32, 3)
    assert program.out_spec.tensors[0].shape == (1, 1001)
    before = ic.FRAME_CALLS
    with torch.inference_mode():
        for n in (1, 3, 4):
            x = torch.from_numpy(_frames(n, seed=n))
            assert torch.equal(program(x)[0], graph(x)[0])
        assert torch.equal(program(x[0])[0], graph(x[0])[0])  # a frame: the axis added
    assert ic.FRAME_CALLS == before and graph.foldable


def _labels_and_outputs(text, frames):
    pipe = parse_pipeline(text)
    pipe.start()
    try:
        for x in frames:
            pipe["src"].push(x)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
    finally:
        pipe.stop()
    return [np.asarray(f.tensors[0]) for f in pipe["out"].frames], pipe


def test_int8_pt2_is_bit_equal_to_the_tflite_backend(files):
    """``--int8``'s program through ``framework=auto`` (the ``.pt2`` goes to
    ``torch-cuda``) against ``framework=tflite custom=int8:true``: equal
    outputs, then equal labels with the decoder."""
    frames = _frames(10)
    text = ("appsrc name=src ! tensor_filter name=f framework={fw} model={model} {custom} "
            "max-batch=4 accelerator=cpu ! {dec}tensor_sink name=out")
    got, pipe = _labels_and_outputs(text.format(fw="auto", model=files["int8"], custom="",
                                                dec=""), frames)
    assert pipe["f"]._framework == "torch-cuda"
    want, _ = _labels_and_outputs(text.format(fw="tflite", model=files["tflite"],
                                              custom="custom=int8:true", dec=""), frames)
    assert len(got) == 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dec = "tensor_decoder mode=image_labeling ! "
    a, _ = _labels_and_outputs(text.format(fw="torch-cuda", model=files["int8"], custom="",
                                           dec=dec), frames)
    b, _ = _labels_and_outputs(text.format(fw="tflite", model=files["tflite"],
                                           custom="custom=int8:true", dec=dec), frames)
    assert [x.tolist() for x in a] == [x.tolist() for x in b]


def test_a_fresh_process_loads_a_program_through_the_backend(files):
    """The backend's loader registers every operator itself: a process
    that imported nothing else loads the ``--int8`` program and labels a
    frame as this process does."""
    import subprocess

    x = _frames(1)
    np.save(files["int8"].with_suffix(".npy"), x)
    code = ("import sys, numpy as np\n"
            "from nnstreamer_tpu_torch.backends.torch_cuda import TorchCuda\n"
            "be = TorchCuda()\n"
            f"be.open({str(files['int8'])!r}, {{'accelerators': ['cpu']}})\n"
            f"x = np.load({str(files['int8'].with_suffix('.npy'))!r})\n"
            "print('OUT', int(be.invoke_batch([x])[0].reshape(-1).argmax()))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=Path(__file__).resolve().parents[1], timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = int(_port_outputs(files["int8"], x)[0].reshape(-1).argmax())
    assert r.stdout.split("OUT ")[1].split()[0] == str(want)


def test_int8_program_holds_the_kernels_operators(files):
    """The int8 route's convolutions are ``conv_i8`` operators whose
    arguments carry no route or plan (both are chosen when the program
    runs, from the real tensors' bases), and the full-precision ops around
    them stay plain aten ops."""
    from unittest import mock

    from nnstreamer_tpu_torch.importers.tflite_lower import _Lowering
    from nnstreamer_tpu_torch.importers.tflite_reader import read_tflite

    model = read_tflite(str(files["tflite"]))
    lowering = _Lowering(model, int8_compute=True)
    graph = ic.ImportedGraph(lowering, lowering.params(), [4], lowering.int8_params())
    calls = []
    real = q8.conv_i8
    with mock.patch.object(q8, "conv_i8", lambda *a, **k: calls.append(1) or real(*a, **k)):
        with torch.inference_mode():
            graph(torch.from_numpy(_frames(2)))
    program = ExportedModule(str(files["int8"]))
    ops = program_ops(program)
    # one operator a convolution, depthwise convolution or patch sum of the eager graph
    assert ops.count("nns_torch.conv_i8.default") == len(calls) > 36 + 17
    assert set(ops) == {"nns_torch.conv_i8.default"}
    for node in program.__dict__["_program"].graph.nodes:
        if str(node.target) == "nns_torch.conv_i8.default":
            assert len(node.args) == 8 and not any(isinstance(a, str) for a in node.args)
    assert program_ops(ExportedModule(str(files["fq"]))) == []


def test_fixed_program_serves_frame_by_frame_and_a_mixing_graph_needs_it(tmp_path):
    model = tt.case("CONCATENATION", [tt.A((1, 2)), tt.A((1, 2))], [tt.O((2, 2))], axis=0,
                    activation=None).values[0]
    src = tmp_path / "cat.tflite"
    src.write_bytes(mf.tflite_bytes(model))
    with pytest.raises(SystemExit, match="--fixed"):
        convert.main([str(src)])
    assert not (tmp_path / "cat.pt2").exists()
    assert convert.main([str(src), "--fixed"]) == 0
    program = ExportedModule(str(tmp_path / "cat.pt2"))
    assert not program.symbolic and program.in_ranks == [2, 2]
    xs = [torch.randn(3, 1, 2), torch.randn(3, 1, 2)]
    assert torch.equal(program(*xs)[0], torch.cat(xs, dim=1))  # frame by frame, stacked
    assert torch.equal(program(xs[0][0], xs[1][0])[0], torch.cat([xs[0][0], xs[1][0]]))


def test_pt2_goes_to_torch_cuda_under_auto():
    assert detect_framework("model.pt2") == "torch-cuda"
    assert detect_framework("model.PT2", "arch:vit") == "torch-cuda"


# -- zoo modules ------------------------------------------------------------------------------

@pytest.mark.parametrize("arch,props,op,count", [
    ("vit", {"size": "32", "patch": "8", "d_model": "32", "heads": "2", "layers": "2",
             "d_ff": "64", "classes": "10", "attn": "flash"},
     "nns_torch.flash_attention.default", 2),
    ("mobilenet_v2", {"size": "32", "width": "0.35", "classes": "10", "pallas": "1"},
     "nns_torch.normalize_u8.default", 1),
], ids=["vit-flash", "mobilenet_v2-pallas"])
def test_zoo_module_exported_equals_the_module(tmp_path, arch, props, op, count):
    from nnstreamer_tpu_torch.models import build

    module, in_spec, out_spec = build(arch, dict(props, dtype="float32"))
    module.train()
    path = tmp_path / f"{arch}.pt2"
    export_model(module, [(t.shape, t.dtype) for t in in_spec.tensors], str(path))
    assert module.training  # the module's mode is restored
    program = ExportedModule(str(path))
    assert program_ops(program) == [op] * count
    assert [t.shape for t in program.out_spec.tensors] == [t.shape for t in out_spec.tensors]
    module.eval()
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3, 32, 32, 3),
                                                           dtype=np.uint8))
    with torch.inference_mode():
        want = module(x)
        assert torch.equal(program(x)[0], want)
        assert torch.equal(program(x[1])[0], module(x[1:2])[0])  # a frame: a batch of 1
    assert counters() == [0] * len(COUNTERS)
