"""Port parity: DeepLab, the segment decoder and its pipeline against the
JAX package, on the CPU.

* DeepLab in float32 at 65 (odd) and 64 (even), 21 classes: outputs within
  rtol = atol = 1e-4 (the tolerance of ``tests/test_torch_mobilenet.py``).
* the bilinear upsample: ``F.interpolate(mode="bilinear",
  align_corners=False)`` against ``jax.image.resize(..., "bilinear")`` at
  integer and non-integer scales, within 1e-6.
* ``image_segment``, all three modes on identical raw tensors: canvases
  byte-equal and ``meta`` equal; the device half of ``tflite-deeplab``
  (argmax, clip, uint8) equal to JAX's and its ``decode_fused`` to the
  host decode (JAX ``tests/test_decoders.py:220-250``).
* the pipeline ``appsrc ! tensor_filter ! tensor_decoder
  mode=image_segment option1=tflite-deeplab ! tensor_sink``, fused and
  ``device-fused=never``, in both packages on the same frames, with no
  pixel at a near-tie of its class argmax.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
from nnstreamer_tpu.decoders.segment import ImageSegment as JaxSegment
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends.torch_cuda import (
    TorchCuda,
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from nnstreamer_tpu_torch.decoders.segment import ImageSegment
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models import deeplab
from nnstreamer_tpu_torch.models._quant_flax import QuantConv2d
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_parity import assert_decoded_equal, decoder_pipeline, model_pair, run_both, spec_tuple

torch.set_num_threads(2)

MODEL = "torch_parity_deeplab"


@pytest.fixture(scope="module", params=[65, 64], ids=["odd", "even"])
def pair(request):
    size = request.param
    return (size,) + model_pair("deeplab", deeplab, {"size": str(size)}, seed=size)


def test_outputs_match_jax(pair):
    size, fn, variables, module, _ = pair
    x = np.random.default_rng(size).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    (got,), (want,) = run_both(fn, variables, module, x)
    assert got.shape == want.shape == (2, size, size, 21) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_single_frame_without_batch_axis(pair):
    size, fn, variables, module, specs = pair
    name = f"{MODEL}_{size}"
    register_torch_model(name, module, specs[2], specs[3])
    try:
        be = TorchCuda()
        be.open(name, {"accelerators": ["cpu"]})
        x = np.random.default_rng(size + 1).integers(0, 256, (size, size, 3), dtype=np.uint8)
        (got,) = be.invoke([x])
    finally:
        unregister_torch_model(name)
    (want,) = fn(variables, [x])
    assert tuple(got.shape) == np.asarray(want).shape == (size, size, 21)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_specs_state_dict_and_refusals(pair):
    size, _, variables, module, (jax_in, jax_out, port_in, port_out) = pair
    assert spec_tuple(port_in) == spec_tuple(jax_in) and spec_tuple(port_out) == spec_tuple(jax_out)
    assert set(deeplab.state_dict_from_flax(variables)) == set(module.state_dict())
    # the atrous branches pad 2 and 4 symmetrically, and the trunk stops at stride 16
    assert module.aspp.b2.padding == (2, 2) and module.aspp.b3.padding == (4, 4)
    assert module.aspp.b2.bias is None and module.classifier.bias is not None
    # the JAX build never reads quantize: int8 builds the float model (C10)
    int8, _, _ = torch_build("deeplab", {"quantize": "int8", "size": "33"})
    assert not any(isinstance(m, QuantConv2d) for m in int8.modules())


@pytest.mark.parametrize("src,dst", [(17, 257), (5, 13), (4, 64), (9, 9), (3, 10)])
def test_bilinear_resize_equals_jax_image_resize(src, dst):
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(src * dst).normal(0, 1, (2, src, src + 1, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst + 2, 3), method="bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(dst, dst + 2),
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_build_bf16_and_float16():
    for dtype in ("bfloat16", "float16"):
        m, _, _ = torch_build("deeplab", {"dtype": dtype, "size": "33", "seed": "1"})
        assert m.stem.conv.weight.dtype == getattr(torch, dtype)
        assert m.classifier.weight.dtype == torch.float32
        x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 33, 33, 3), np.uint8))
        with torch.inference_mode():
            out = m.eval()(x)
        assert out.dtype == torch.float32 and out.shape == (2, 33, 33, 21)
        assert torch.isfinite(out).all()


# -- image_segment decoder --------------------------------------------------------

def _decoders(options):
    port, jax = ImageSegment(), JaxSegment()
    port.set_options(options)
    jax.set_options(options)
    return port, jax


CASES = {
    "tflite-deeplab": (["tflite-deeplab"], lambda r: r.normal(0, 1, (12, 10, 21))),
    "tflite-deeplab-4": (["tflite-deeplab", "4"], lambda r: r.normal(0, 1, (12, 10, 9))),
    "tflite-deeplab-batched": (["", ""], lambda r: r.normal(0, 1, (1, 8, 6, 5))),
    "snpe-deeplab": (["snpe-deeplab"], lambda r: r.integers(0, 30, (12, 10)).astype(np.float32)),
    "snpe-deeplab-3d": (["snpe-deeplab", "6"],
                        lambda r: r.integers(0, 9, (12, 10, 1)).astype(np.float32)),
    "snpe-depth": (["snpe-depth"], lambda r: r.uniform(0, 10, (12, 10))),
    "snpe-depth-flat": (["snpe-depth"], lambda r: np.full((4, 4), 3.0)),
}


@pytest.mark.parametrize("case", CASES)
def test_host_decode_equals_jax(case):
    options, make = CASES[case]
    port, jax = _decoders(options)
    rng = np.random.default_rng(len(case))
    for i in range(2):
        t = make(rng).astype(np.float32)
        assert_decoded_equal(port.decode(TensorFrame([t], pts=float(i)), None),
                             jax.decode(JaxFrame([t], pts=float(i)), None))
    spec = StreamSpec((TensorSpec((12, 10, 21), np.float32),), FORMAT_STATIC)
    assert port.get_out_spec(spec).tensors[0].shape == (12, 10, 4)


@pytest.mark.parametrize("max_labels", ["", "4", "300"])
def test_device_half_equals_jax_and_host(max_labels):
    import jax.numpy as jnp

    port, jax = _decoders(["tflite-deeplab", max_labels])
    assert port.supports_device_fn() is jax.supports_device_fn() is (max_labels != "300")
    scores = np.random.default_rng(1).normal(0, 1, (3, 12, 10, 21)).astype(np.float32)
    scores[0, 0, 0, :] = 0.5  # a tie: the first maximum wins in both
    with torch.inference_mode():
        (got,) = port.device_fn([torch.from_numpy(scores)])
        (one,) = port.device_fn([torch.from_numpy(scores[1])])  # no batch axis
    (want,) = jax.device_fn([jnp.asarray(scores)])
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 12, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(one[0], got[1])
    for i in range(3):
        fused = port.decode_fused(TensorFrame([got[i]], pts=float(i)), None)
        assert_decoded_equal(fused, jax.decode_fused(JaxFrame([np.asarray(want[i])], pts=float(i)),
                                                     None))
        if port.supports_device_fn():
            assert_decoded_equal(fused, port.decode(TensorFrame([scores[i]], pts=float(i)), None))


def test_pipeline_fused_and_unfused_equal_jax(pair):
    size, fn, variables, module, specs = pair
    register_jax_model(MODEL, fn, variables, specs[0], specs[1])
    register_torch_model(MODEL, module, specs[2], specs[3])
    frames = np.random.default_rng(17).integers(0, 256, (5, size, size, 3), dtype=np.uint8)
    (got,), (want,) = run_both(fn, variables, module, frames)
    # no pixel's class argmax at a near-tie: its top two scores differ by
    # more than twice the packages' largest score difference
    top2 = np.sort(want, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 2 * np.abs(got - want).max()
    runs = {}
    try:
        for name, parse, props in (
                ("port", parse_pipeline, f"framework=torch-cuda model={MODEL} accelerator=cpu"),
                ("jax", jax_parse, f"framework=jax-xla model={MODEL}")):
            for extra in ("", "device-fused=never"):
                fused, out = decoder_pipeline(parse, props, "image_segment",
                                              "option1=tflite-deeplab", frames, extra)
                assert fused is (extra == "") and [f.pts for f in out] == [0.0, 1.0, 2.0, 3.0, 4.0]
                runs[name, extra] = out
    finally:
        unregister_jax_model(MODEL)
        unregister_torch_model(MODEL)
    for key in runs:
        assert_decoded_equal(runs[key], runs["jax", ""])  # one class grid, four routes
    assert all(f.meta["classes_present"] for f in runs["port", ""])
