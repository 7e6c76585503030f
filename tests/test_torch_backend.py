"""The torch-cuda backend leaves registered modules where they are.

Opening a filter on a registered module must neither move it nor switch
its mode: the JAX backend places params with ``jax.device_put``, which
leaves the registered tree untouched, and the port runs a private copy
whenever the module does not already live on the filter's device in eval
mode.  ``pick_device`` is patched to return ``meta``, a second device
that needs no card.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.backends import torch_cuda
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.elements.filter import TensorFilter

torch.set_num_threads(2)

MODEL = "torch_backend_c1"


class _Affine(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 3)
        self.register_buffer("shift", torch.arange(3, dtype=torch.float32))

    def forward(self, x):
        return self.lin(x) + self.shift


@pytest.fixture
def registered():
    torch.manual_seed(0)
    module = _Affine()  # left in training mode, as registered
    register_torch_model(MODEL, module)
    yield module
    unregister_torch_model(MODEL)


def _filter(name, accelerator="cpu"):
    el = TensorFilter(name)
    el.set_property("model", MODEL)
    el.set_property("accelerator", accelerator)
    return el


def _on_meta(monkeypatch):
    monkeypatch.setattr(torch_cuda, "pick_device", lambda wishes: torch.device("meta"))


def test_open_on_another_device_leaves_registered_module_untouched(registered, monkeypatch):
    _on_meta(monkeypatch)
    el = _filter("f")
    el.start()
    try:
        placed = el.backend._module
        assert placed is not registered
        assert all(p.device.type == "meta" for p in placed.parameters())
        assert not placed.training
        # the registered module: still on the CPU, still in training mode
        assert all(p.device.type == "cpu" for p in registered.parameters())
        assert all(b.device.type == "cpu" for b in registered.buffers())
        assert registered.training and registered.lin.training
    finally:
        el.stop()


def test_module_already_placed_in_eval_mode_is_used_as_is(registered):
    registered.eval()
    el = _filter("f")
    el.start()
    try:
        assert el.backend._module is registered
    finally:
        el.stop()


def test_two_filters_on_two_placements_compute_with_their_own_weights(registered, monkeypatch):
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    with torch.no_grad():
        want = registered.eval()(torch.from_numpy(x)).numpy()
    registered.train()
    cpu = _filter("cpu_f")
    cpu.start()
    try:
        _on_meta(monkeypatch)
        meta = _filter("meta_f", accelerator="gpu")
        meta.start()
        try:
            assert meta.backend._module is not cpu.backend._module
            (out_meta,) = meta.backend.invoke_batch([x])
            assert out_meta.device.type == "meta" and tuple(out_meta.shape) == (2, 3)
            # opening on meta moved nothing out from under the CPU filter
            (out_cpu,) = cpu.backend.invoke_batch([x])
            np.testing.assert_allclose(out_cpu.numpy(), want, rtol=1e-6, atol=1e-6)
            assert cpu.backend._module.lin.weight.device.type == "cpu"
        finally:
            meta.stop()
    finally:
        cpu.stop()
    assert registered.training  # as registered


# -- the output schema of a fused filter --------------------------------------------


def _count_model_calls(monkeypatch):
    calls = []
    invoke = torch_cuda.TorchCuda.invoke_batch
    monkeypatch.setattr(torch_cuda.TorchCuda, "invoke_batch",
                        lambda self, xs: calls.append(int(xs[0].shape[0])) or invoke(self, xs))
    return calls


def test_declared_output_schema_is_derived_without_a_model_call(monkeypatch, tmp_path):
    """A zoo model declares its output: the fused decoder's schema comes
    from it through the postprocess on the host, so a source with a static
    schema costs no model call beyond the micro-batches (the JAX backend
    runs ``eval_shape``)."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    calls = _count_model_calls(monkeypatch)
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"c{i}" for i in range(10)))
    pipe = parse_pipeline(
        "videotestsrc num-buffers=12 width=32 height=32 pattern=random seed=2 ! "
        "tensor_converter ! tensor_filter name=f framework=torch-cuda model=zoo "
        "custom=arch:mobilenet_v2,dtype:float32,size:32,width:0.35,classes:10 "
        f"accelerator=cpu max-batch=4 ! tensor_decoder mode=image_labeling option1={labels} ! "
        "tensor_sink name=out")
    pipe.start()
    try:
        pipe.wait(timeout=60)
        fused = pipe["f"].derive_spec()
    finally:
        pipe.stop()
    assert [(t.shape, t.dtype) for t in fused.tensors] == [((2,), np.float32)]
    assert len(pipe["out"].frames) == 12
    assert sum(calls) == 12  # every model call is a micro-batch of the stream


def test_probed_output_schema_is_cached_per_input_schema(registered, monkeypatch):
    """Without a declared output, one zero frame runs through the model
    once per input schema, however often negotiation asks."""
    from nnstreamer_tpu_torch.core.types import FORMAT_STATIC, StreamSpec, TensorSpec

    calls = _count_model_calls(monkeypatch)
    f = _filter("f")
    f.start()
    try:
        for shape in ((4,), (4,), (2, 4), (4,)):
            f.sink_specs[0] = StreamSpec((TensorSpec(shape, np.float32),), FORMAT_STATIC)
            want = shape[:-1] + (3,)
            assert [(t.shape, t.dtype) for t in f.derive_spec().tensors] == [(want, np.float32)]
    finally:
        f.stop()
    assert calls == [1, 1]
