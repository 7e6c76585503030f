"""Port parity: the PyTorch transformer LM's full-sequence logits against
the flax model, alone and through the port's pipeline.

Float32 on both sides, the flax params converted by
``state_dict_from_flax``; 40 tokens of a vocabulary of 64.  Logits within
``rtol=atol=1e-4`` (summation orders differ), per-position argmax equal.
"""

import numpy as np
import pytest
import torch
from torch import nn

from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models._quant_flax import QuantLinear
from nnstreamer_tpu_torch.models.transformer import GenerateLM, TransformerLM, state_dict_from_flax
from nnstreamer_tpu_torch.pipeline import parse_pipeline

torch.set_num_threads(2)

_PROPS = {"vocab": "64", "d_model": "32", "heads": "2", "layers": "2", "seq": "64",
          "dtype": "float32"}


@pytest.fixture(scope="module", params=["flash", "xla"])
def models(request):
    props = dict(_PROPS, attn=request.param)
    fn, params, jax_in, jax_out = jax_build("transformer", props)
    module, in_spec, out_spec = torch_build("transformer", props)
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    specs = [(s.tensors[0].shape, s.tensors[0].dtype) for s in (jax_in, jax_out, in_spec, out_spec)]
    return fn, params, module.eval(), specs


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, 64, (n, 40), dtype=np.int32)


def test_logits_match_jax(models):
    fn, params, module, _ = models
    toks = _tokens(2, 1)
    ref = np.asarray(fn(params, [toks])[0])
    with torch.inference_mode():
        got = module(torch.from_numpy(toks)).numpy()
    assert got.shape == ref.shape == (2, 40, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_specs_match_jax(models):
    *_, (jax_in, jax_out, port_in, port_out) = models
    assert port_in == jax_in == ((None,), np.int32)
    assert port_out == jax_out == ((None, 64), np.float32)


def test_state_dict_covers_every_parameter(models):
    _, params, module, _ = models
    sd = state_dict_from_flax(params)
    assert set(sd) == set(module.state_dict())
    head = np.asarray(params["params"]["lm_head"]["kernel"])  # (d_model, vocab)
    np.testing.assert_array_equal(sd["lm_head.weight"].numpy(), head.T)


def test_pipeline_logits_match_jax(models):
    # 5 prompts through appsrc ! tensor_filter ! tensor_sink: micro-batches
    # of at most 4 (bucket padding on the partial one), logits per frame
    fn, params, module, _ = models
    name = "torch_parity_lm"
    register_torch_model(name, module, *torch_build("transformer", _PROPS)[1:])
    try:
        pipe = parse_pipeline(f"appsrc name=src ! tensor_filter name=f model={name} "
                              "accelerator=cpu max-batch=4 ! tensor_sink name=out")
        toks = _tokens(5, 2)
        pipe.start()
        try:
            for i, t in enumerate(toks):
                pipe["src"].push(t, pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=60)
        finally:
            pipe.stop()
    finally:
        unregister_torch_model(name)
    out = pipe["out"].frames
    assert [f.pts for f in out] == list(range(5))
    got = np.stack([f.tensors[0] for f in out])
    ref = np.asarray(fn(params, [toks])[0])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("prop", ["generate:4", "decode:1", "slotted:1", "mesh:dp=1"])
def test_generation_paths_raise(prop):
    # as the JAX zoo: generate:<N> builds the generation entry, decode and
    # slotted are ignored (the logits entry); mesh waits for ROADMAP A11
    key, _, value = prop.partition(":")
    props = dict(_PROPS, **{key: value})
    if key == "mesh":
        with pytest.raises(NotImplementedError, match="A11"):
            torch_build("transformer", props)
        return
    module, _, out_spec = torch_build("transformer", props)
    jax_out = jax_build("transformer", props)[3]
    toks = torch.from_numpy(_tokens(1, 4)[0, :6])
    with torch.inference_mode():
        out = module(toks)
    if key == "generate":
        assert isinstance(module, GenerateLM)
        assert out.shape == (10,) and out.dtype == torch.int32
        assert torch.equal(out[:6], toks)
        assert out_spec.tensors[0].shape == (None,) and out_spec.tensors[0].dtype == np.int32
    else:
        assert isinstance(module, TransformerLM) and out.shape == (6, 64)
        assert out_spec.tensors[0].shape == (None, 64)
    assert (out_spec.tensors[0].shape, out_spec.tensors[0].dtype) == (
        jax_out.tensors[0].shape, jax_out.tensors[0].dtype)
    logits, _, _ = torch_build("transformer", dict(_PROPS, generate="0"))  # 0: the logits entry
    assert isinstance(logits, TransformerLM)


def test_int8_raises_and_long_sequences_are_refused():
    int8, _, _ = torch_build("transformer", dict(_PROPS, quantize="int8"))  # ported: A6
    assert isinstance(int8.blocks[0].attn_qkv, QuantLinear) and type(int8.lm_head) is nn.Linear
    module, _, _ = torch_build("transformer", _PROPS)
    with pytest.raises(ValueError, match="exceed"):
        module(torch.zeros(1, 65, dtype=torch.int32))


def test_build_is_seeded_and_keeps_lm_head_float32():
    a, _, _ = torch_build("transformer", dict(_PROPS, dtype="bfloat16", seed="3"))
    b, _, _ = torch_build("transformer", dict(_PROPS, dtype="bfloat16", seed="3"))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert a.embed.weight.dtype == a.blocks[1].mlp_up.weight.dtype == torch.bfloat16
    assert a.lm_head.weight.dtype == torch.float32 and a.lm_head.bias is None
    with torch.inference_mode():
        out = a(torch.from_numpy(_tokens(2, 3)))
        single = a(torch.from_numpy(_tokens(2, 3)[0]))
    assert out.dtype == torch.float32 and out.shape == (2, 40, 64) and torch.isfinite(out).all()
    assert single.shape == (40, 64)
