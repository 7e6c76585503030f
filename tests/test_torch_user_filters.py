"""The port's user filters against the JAX package's: ``custom-easy`` (an
in-process callable), ``python3`` (a script, both styles, ``set_options``),
``torch`` (a TorchScript archive) and ``custom`` (a native ``.so`` over the
C ABI, built with g++ from each package's own copy of ``scaler_custom.cc``).

The same seeded numpy frames go through the same pipeline text in both
packages.  Tolerance: exact (every output bit for bit, labels and meta
equal); the backends compute the same float32 operations on the host.
The port's addition (a batched callable) and card tensors handed to a
callable untouched are held against the per-frame run and against the JAX
package's host decoder.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends import register_custom_easy as jax_register
from nnstreamer_tpu.backends import unregister_custom_easy as jax_unregister
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends import custom_easy, find_backend
from nnstreamer_tpu_torch.backends import register_custom_easy, unregister_custom_easy
from nnstreamer_tpu_torch.core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from nnstreamer_tpu_torch.native import runtime
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_parity import assert_frames_equal, both, run

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frames(n=6, shape=(4, 5), seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape).astype(dtype), float(i)) for i in range(n)]


# -- custom-easy ------------------------------------------------------------

def _affine(inputs):
    x = np.asarray(inputs[0], np.float32)
    return [x * np.float32(3.0) - np.float32(1.0), x.sum(axis=-1)]


@pytest.fixture
def affine_both():
    jax_register("ce_affine", _affine)
    register_custom_easy("ce_affine", _affine)
    yield "ce_affine"
    jax_unregister("ce_affine")
    unregister_custom_easy("ce_affine")


def test_custom_easy_equals_jax(affine_both):
    both(f"appsrc name=src ! tensor_filter framework=custom-easy model={affine_both} ! "
         "tensor_sink name=out", frames())


def test_custom_easy_batched_equals_per_frame(affine_both):
    """A callable registered ``batched=True`` gets micro-batches (leading
    frame axis) through max-batch, and its frames equal the JAX package's
    per-frame run."""
    calls = []

    def batched(inputs):
        calls.append(int(inputs[0].shape[0]))
        x = np.asarray(inputs[0], np.float32)
        return [x * np.float32(3.0) - np.float32(1.0), x.sum(axis=-1)]

    register_custom_easy("ce_batched", batched, batched=True)
    try:
        got = run(parse_pipeline, "appsrc name=src max-buffers=16 ! tensor_filter "
                  "framework=custom-easy model=ce_batched max-batch=4 batch-timeout=200 ! "
                  "tensor_sink name=out", frames(8))
    finally:
        unregister_custom_easy("ce_batched")
    want = run(jax_parse, f"appsrc name=src ! tensor_filter framework=custom-easy "
               f"model={affine_both} ! tensor_sink name=out", frames(8))
    assert_frames_equal(got["out"].frames, want["out"].frames)
    assert sum(calls) == 8 and max(calls) > 1


def test_custom_easy_torch_tensors_reach_the_callable_untouched():
    """Torch tensors pushed into the stream reach the callable as the same
    torch tensors: nothing is copied to the host on its behalf."""
    seen = []

    def fn(inputs):
        seen.append(inputs[0])
        return [inputs[0] * 2]

    register_custom_easy("ce_torch", fn)
    xs = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + i for i in range(3)]
    try:
        pipe = parse_pipeline("appsrc name=src ! tensor_filter framework=custom-easy "
                              "model=ce_torch ! tensor_sink name=out")
        pipe.start()
        for i, x in enumerate(xs):
            pipe["src"].push(x, pts=float(i))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
        pipe.stop()
    finally:
        unregister_custom_easy("ce_torch")
    assert [s is x for s, x in zip(seen, xs)] == [True] * 3
    for f, x in zip(pipe["out"].frames, xs):
        np.testing.assert_array_equal(np.asarray(f.tensors[0]), (x * 2).numpy())


def _logits(inputs):
    x = np.asarray(inputs[0], np.float32)
    return [np.stack([x.sum(axis=-1), x.max(axis=-1), -x.min(axis=-1)], axis=-1).reshape(-1)]


@pytest.mark.parametrize("batched", [False, True], ids=["per-frame", "batched"])
def test_custom_easy_labeling_equals_jax_host_decoder(tmp_path, batched):
    """A custom-easy callable's scores into the labeling decoder, per frame
    and in micro-batches: labels and scores equal the JAX pipeline's."""
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"c{i}" for i in range(12)))

    def port_fn(inputs):
        return [np.stack([_logits([a])[0] for a in np.asarray(inputs[0])])] if batched \
            else _logits(inputs)

    jax_register("ce_logits", _logits)
    register_custom_easy("ce_logits", port_fn, batched=batched)
    text = ("appsrc name=src ! tensor_filter name=f framework=custom-easy model=ce_logits "
            f"{'max-batch=4 batch-timeout=200' if batched else ''} ! tensor_decoder "
            f"mode=image_labeling option1={labels} ! tensor_sink name=out")
    try:
        pushes = frames(8, shape=(4, 4), seed=3)
        got = run(parse_pipeline, text, pushes)
        want = run(jax_parse, text.replace("max-batch=4 batch-timeout=200", ""), pushes)
    finally:
        jax_unregister("ce_logits")
        unregister_custom_easy("ce_logits")
    g, w = got["out"].frames, want["out"].frames
    assert len(g) == len(w) == 8
    for a, b in zip(g, w):
        assert (a.pts, a.meta["label"], a.meta["label_index"]) == \
            (b.pts, b.meta["label"], b.meta["label_index"])
        assert a.meta["label_score"] == b.meta["label_score"]


def test_custom_easy_unregistered_raises():
    be = custom_easy.CustomEasy()
    with pytest.raises(FileNotFoundError):
        be.open("nope", {})


# -- python3 ----------------------------------------------------------------

CLASS_SCRIPT = """
import numpy as np

class CustomFilter:
    def __init__(self):
        self.mult = 2.0
    def set_options(self, custom):
        self.mult = float(custom.get("mult", 2.0))
    def invoke(self, inputs):
        return [np.asarray(a, np.float32) * np.float32(self.mult) for a in inputs] + \\
            [np.asarray([len(inputs)], np.int32)]
"""

FUNC_SCRIPT = """
import numpy as np

def invoke(inputs):
    x = inputs[0]
    return np.cumsum(x, axis=-1).astype(np.float32)
"""

INFO_SCRIPT = """
import numpy as np

class CustomFilter:
    def get_model_info(self):
        return ["float32:5:4"], ["float32:5:4", "int64:1"]
    def invoke(self, inputs):
        return [inputs[0][::-1].copy(), np.asarray([inputs[0].size], np.int64)]
"""


@pytest.mark.parametrize("script,custom", [
    (CLASS_SCRIPT, "mult:3.5"), (CLASS_SCRIPT, ""), (FUNC_SCRIPT, ""), (INFO_SCRIPT, "")],
    ids=["class-set-options", "class-default", "module-invoke", "model-info"])
def test_python3_equals_jax(tmp_path, script, custom):
    path = tmp_path / "user_filter.py"
    path.write_text(script)
    both(f"appsrc name=src ! tensor_filter framework=python3 model={path} "
         f"{'custom=' + custom if custom else ''} ! tensor_sink name=out", frames())


def test_python3_derives_schema_from_a_zero_frame(tmp_path):
    """``set_input_info`` without a script hook probes with zeros, as the
    JAX backend does: the same output schema."""
    from nnstreamer_tpu.backends.python3 import Python3Backend as JaxPython3
    from nnstreamer_tpu.core.types import StreamSpec as JaxStreamSpec
    from nnstreamer_tpu.core.types import TensorSpec as JaxTensorSpec

    path = tmp_path / "f.py"
    path.write_text(CLASS_SCRIPT)
    port, jax = find_backend("python3")(), JaxPython3()
    port.open(str(path), {"custom": "mult:2"})
    jax.open(str(path), {"custom": "mult:2"})
    got = port.set_input_info(StreamSpec((TensorSpec((3, 2), np.uint8),), FORMAT_STATIC))
    want = jax.set_input_info(JaxStreamSpec((JaxTensorSpec((3, 2), np.uint8),), "static"))
    assert [(t.shape, np.dtype(t.dtype)) for t in got.tensors] == \
        [(t.shape, np.dtype(t.dtype)) for t in want.tensors]


def test_python3_card_tensors_cross_through_materialize(tmp_path, monkeypatch):
    """Inputs reach the script as numpy arrays through
    ``core.buffer.materialize`` (the port's one host-copy path)."""
    from nnstreamer_tpu_torch.backends import python3 as py3

    path = tmp_path / "f.py"
    path.write_text(FUNC_SCRIPT)
    crossed = []
    real = py3.materialize
    monkeypatch.setattr(py3, "materialize", lambda ts: crossed.append(len(ts)) or real(ts))
    be = py3.Python3Backend()
    be.open(str(path), {})
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    (out,) = be.invoke([x])
    assert crossed == [1] and isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.cumsum(x.numpy(), axis=-1))


def test_python3_without_invoke_raises(tmp_path):
    path = tmp_path / "empty.py"
    path.write_text("X = 1\n")
    with pytest.raises(ValueError, match="neither CustomFilter nor invoke"):
        find_backend("python3")().open(str(path), {})


# -- torch (TorchScript) ----------------------------------------------------

class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(5, 3, generator=g))

    def forward(self, x):
        y = torch.tanh(x @ self.w)
        return y, y.sum(dim=-1)


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    path = tmp_path_factory.mktemp("ts") / "tiny.pt"
    torch.jit.save(torch.jit.script(_Tiny().eval()), str(path))
    return str(path)


@pytest.mark.parametrize("batch", ["", "max-batch=3 batch-timeout=200"], ids=["frame", "batch"])
def test_torchscript_equals_jax(scripted, batch):
    text = (f"appsrc name=src ! tensor_filter framework=torch model={scripted} {batch} "
            "accelerator=cpu ! tensor_sink name=out")
    got = run(parse_pipeline, text, frames(6))
    want = run(jax_parse, text, frames(6))
    assert_frames_equal(got["out"].frames, want["out"].frames)


def test_torchscript_schema_and_device(scripted):
    be = find_backend("torch")()
    be.open(scripted, {"accelerators": ["cpu"]})
    assert be.device == torch.device("cpu")
    spec = be.set_input_info(StreamSpec((TensorSpec((4, 5), np.float32),), FORMAT_STATIC))
    assert [(t.shape, np.dtype(t.dtype)) for t in spec.tensors] == \
        [((4, 3), np.dtype(np.float32)), ((4,), np.dtype(np.float32))]
    (y, s) = be.invoke_batch([np.ones((2, 4, 5), np.float32)])
    assert tuple(y.shape) == (2, 4, 3) and isinstance(y, torch.Tensor)


# -- custom (native .so) ----------------------------------------------------

def _jax_scaler(tmp_path_factory):
    """The JAX package's example built against the JAX package's header."""
    jax_native = os.path.join(ROOT, "nnstreamer_tpu", "native")
    out = tmp_path_factory.mktemp("jax_native") / "libscaler.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                    f"-I{os.path.join(jax_native, 'include')}",
                    os.path.join(jax_native, "examples", "scaler_custom.cc"), "-o", str(out)],
                   check=True, capture_output=True)
    return str(out)


@pytest.fixture(scope="module")
def scalers(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available: the custom backend's subplugin cannot be built")
    return str(runtime.build_example("scaler_custom")), _jax_scaler(tmp_path_factory)


@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["float32-scaled", "int32-copied"])
def test_custom_native_equals_jax(scalers, dtype):
    port_so, jax_so = scalers
    pushes = frames(5, shape=(3, 4), seed=2, dtype=np.float32)
    pushes = [(a.astype(dtype) * (1 if dtype == np.float32 else 100), p) for a, p in pushes]
    text = "appsrc name=src ! tensor_filter framework=custom model={} custom=mult:2.5 ! " \
           "tensor_sink name=out"
    got = run(parse_pipeline, text.format(port_so), pushes)
    want = run(jax_parse, text.format(jax_so), pushes)
    assert_frames_equal(got["out"].frames, want["out"].frames)
    if dtype == np.float32:
        for f, (a, _) in zip(got["out"].frames, pushes):
            np.testing.assert_array_equal(f.tensors[0], a * np.float32(2.5))


def test_custom_native_set_input_info_and_card_inputs(scalers):
    from nnstreamer_tpu_torch.backends import custom_native

    be = custom_native.CustomNative()
    be.open(scalers[0], {"custom": "mult:4"})
    assert be.get_model_info() == (None, None)  # shape-polymorphic
    spec = be.set_input_info(StreamSpec((TensorSpec((8,), np.float32),), FORMAT_STATIC))
    assert spec.tensors[0].shape == (8,)
    (out,) = be.invoke([torch.full((8,), 1.5)])  # crosses through materialize
    np.testing.assert_array_equal(out, np.full((8,), 6.0, np.float32))
    be.close()
    with pytest.raises(FileNotFoundError):
        custom_native.CustomNative().open("/nonexistent/lib.so", {})


def test_native_builds_include_only_the_ports_header(tmp_path):
    """The g++ command lines of the native core and of the example
    subplugins name one include directory: the port's ``native/include``;
    nothing of the JAX package's tree is on them."""
    port_inc = os.path.join(ROOT, "nnstreamer_tpu_torch", "native", "include")
    for src in (runtime.CORE_SRC, runtime.EXAMPLES_DIR / "scaler_custom.cc"):
        cmd = runtime.compile_command(src, tmp_path / "x.so")
        incs = [a[2:] for a in cmd if a.startswith("-I")]
        assert incs == [port_inc], cmd
        assert not any(os.sep + "nnstreamer_tpu" + os.sep in a for a in cmd), cmd
        assert cmd[0] == "g++" and {"-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"} <= set(cmd)
    assert runtime.library_path(runtime.CORE_SRC).parent == \
        runtime.BUILD_DIR and runtime.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    for src in (runtime.CORE_SRC, runtime.EXAMPLES_DIR / "scaler_custom.cc"):
        text = src.read_text()
        assert '#include "nns_tpu_custom_filter.h"' in text or "nns_tpu_custom_filter" not in text
