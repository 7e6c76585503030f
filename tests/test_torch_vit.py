"""Port parity: the PyTorch ViT against the flax one, alone and in the
image-labeling pipeline.

Float32 on both sides (bf16 rounds ``x * (2/255) - 1`` differently in the
two frameworks); the flax params are converted by ``state_dict_from_flax``.
Size 32 with patch 8 gives T = 17 tokens.  The JAX ``attn:flash`` model
runs its reference attention off-TPU, the port's its flash wrapper's plain
version: both the same function in float32.  Logits within
``rtol=atol=1e-4`` (summation orders differ), argmax equal.
"""

import numpy as np
import pytest
import torch
from torch import nn

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse_pipeline
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models._quant_flax import QuantLinear
from nnstreamer_tpu_torch.models.vit import state_dict_from_flax
from nnstreamer_tpu_torch.pipeline import parse_pipeline

torch.set_num_threads(2)

SIZE, N_FRAMES, MODEL = 32, 10, "torch_parity_vit"
_PROPS = {"size": str(SIZE), "patch": "8", "d_model": "32", "heads": "2", "layers": "2",
          "d_ff": "64", "classes": "10", "dtype": "float32"}


@pytest.fixture(scope="module", params=["flash", "xla"])
def models(request):
    props = dict(_PROPS, attn=request.param)
    fn, variables, jax_in, jax_out = jax_build("vit", props)
    module, in_spec, out_spec = torch_build("vit", props)
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    specs = [(s.tensors[0].shape, s.tensors[0].dtype) for s in (jax_in, jax_out, in_spec, out_spec)]
    return fn, variables, module.eval(), specs


def test_logits_match_jax(models):
    fn, variables, module, _ = models
    x = np.random.default_rng(0).integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    ref = np.asarray(fn(variables, [x])[0])
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
        single = module(torch.from_numpy(x[1])).numpy()
    assert got.shape == ref.shape == (3, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))
    np.testing.assert_allclose(single, got[1], rtol=1e-5, atol=1e-5)  # one frame, no batch axis


def test_specs_match_jax(models):
    *_, (jax_in, jax_out, port_in, port_out) = models
    assert port_in == jax_in == ((SIZE, SIZE, 3), np.uint8)
    assert port_out == jax_out == ((10,), np.float32)


def test_state_dict_covers_every_parameter(models):
    _, variables, module, _ = models
    sd = state_dict_from_flax(variables)
    assert set(sd) == set(module.state_dict())
    kernel = np.asarray(variables["params"]["patch_embed"]["kernel"])  # HWIO (8, 8, 3, 32)
    np.testing.assert_array_equal(sd["patch_embed.weight"].numpy()[5, 2], kernel[:, :, 2, 5])
    qkv = np.asarray(variables["params"]["block1"]["attn_qkv"]["kernel"])  # (in, out)
    np.testing.assert_array_equal(sd["blocks.1.attn_qkv.weight"].numpy(), qkv.T)


@pytest.fixture(scope="module")
def registered():
    props = dict(_PROPS, attn="flash")
    fn, variables, in_spec, out_spec = jax_build("vit", props)
    register_jax_model(MODEL, fn, variables, in_spec, out_spec)
    module, t_in, t_out = torch_build("vit", props)
    module.load_state_dict(state_dict_from_flax(variables))
    register_torch_model(MODEL, module, t_in, t_out)
    yield
    unregister_jax_model(MODEL)
    unregister_torch_model(MODEL)


def _labels(parse, framework, frames, extra=""):
    pipe = parse(
        f"appsrc name=src ! tensor_filter name=f framework={framework} model={MODEL} "
        f"max-batch=4 batch-timeout=200 {extra} ! tensor_decoder mode=image_labeling "
        "! tensor_sink name=out")
    pipe.start()
    try:
        for i, f in enumerate(frames):
            pipe["src"].push(f, pts=float(i))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
    finally:
        pipe.stop()
    out = pipe["out"].frames
    assert [f.pts for f in out] == list(range(len(frames)))
    return (np.array([f.meta["label_index"] for f in out]),
            np.array([f.meta["label_score"] for f in out]))


def test_pipeline_labels_match_jax(registered):
    # micro-batches of 4, 4 and 2 (bucket padding), the decoder's device
    # half fused into the filter in both packages
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(N_FRAMES)]
    want_idx, want_score = _labels(jax_parse_pipeline, "jax-xla", frames)
    idx, score = _labels(parse_pipeline, "torch-cuda", frames, "accelerator=cpu")
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(score, want_score, rtol=1e-4, atol=1e-4)


def test_build_is_seeded_and_keeps_head_float32():
    props = dict(_PROPS, dtype="bfloat16", seed="3")
    a, _, _ = torch_build("vit", props)
    b, _, _ = torch_build("vit", props)
    c, _, _ = torch_build("vit", dict(props, seed="4"))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.patch_embed.weight, c.patch_embed.weight)
    assert a.blocks[0].attn_qkv.weight.dtype == a.pos_embed.dtype == torch.bfloat16
    assert a.head.weight.dtype == a.blocks[0].ln1.weight.dtype == torch.float32
    assert a.blocks[0].attn_qkv.bias is None
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8))
    with torch.inference_mode():
        out = a(x)
    assert out.dtype == torch.float32 and out.shape == (2, 10) and torch.isfinite(out).all()


def test_unported_options_raise():
    int8, _, _ = torch_build("vit", dict(_PROPS, quantize="int8"))  # ported: A6
    assert isinstance(int8.blocks[0].mlp_down, QuantLinear) and type(int8.head) is nn.Linear
    with pytest.raises(ValueError, match="not divisible"):
        torch_build("vit", dict(_PROPS, size="30"))
