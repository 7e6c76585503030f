"""Port parity: KV-cache generation of the PyTorch transformer against the
JAX package's ``generate:<N>``, its streaming halves, its chunked
prefill, and ``jax.random``'s threefry draws.

Float32 with the JAX package's continuous-batching test config (vocab 61,
d_model 32, heads 2, layers 2, d_ff 64, seq 64, params seed 11), the flax
params converted by ``state_dict_from_flax``.  Greedy tokens must be
equal, and every step of the reference must have a top-2 logit margin
above 1e-4 so that equality is not luck at a near-tie.  Threefry bits and
uniforms must be bit-equal; sampled tokens equal wherever the reference's
top-2 margin of ``logits / T + gumbel`` is above 1e-5 (``log`` may round
differently in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu.models.transformer import build_slot_stream as jax_slot_stream
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.models import transformer as tr
from nnstreamer_tpu_torch.ops import threefry
from nnstreamer_tpu_torch.pipeline import parse_pipeline

torch.set_num_threads(2)

PROPS = {"dtype": "float32", "vocab": "61", "d_model": "32", "heads": "2", "layers": "2",
         "d_ff": "64", "seq": "64", "seed": "11"}
SAMPLING = {"temperature": "0.8", "top_k": "7", "gen_seed": "3"}
N = 13
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's logits and generate:<N> entries (one params tree)
    and the port's LM holding the converted params."""
    logits_fn, params, _, _ = jax_build("transformer", PROPS)
    gen_fn, gen_params, _, _ = jax_build("transformer", dict(PROPS, generate=str(N)))
    lm = tr.lm_from_props(PROPS)
    lm.load_state_dict(tr.state_dict_from_flax(params), strict=True)
    return {"logits": logits_fn, "gen": gen_fn, "params": params, "gen_params": gen_params,
            "lm": lm}


def _prompts(b, tp=7, seed=0):
    return np.random.default_rng(seed).integers(0, 61, (b, tp)).astype(np.int32)


def _jax_logits(ref, seq):
    return np.asarray(ref["logits"](ref["params"], [seq])[0])


def _margins(z):
    top = np.sort(z, axis=-1)
    return top[..., -1] - top[..., -2]


def test_params_trees_match(ref):
    a, b = jax.tree_util.tree_leaves(ref["params"]), jax.tree_util.tree_leaves(ref["gen_params"])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("b", [1, 2])
def test_one_shot_greedy_equals_jax(ref, b):
    prompt = _prompts(b)
    want = np.asarray(ref["gen"](ref["gen_params"], [prompt])[0])
    # the reference is no near-tie at any step
    steps = _jax_logits(ref, want)[:, prompt.shape[1] - 1:-1]
    assert _margins(steps).min() > 1e-4
    module = tr.GenerateLM(ref["lm"], N)
    with torch.inference_mode():
        got = module(torch.from_numpy(prompt)).numpy()
        single = module(torch.from_numpy(prompt[0])).numpy()
    assert got.dtype == np.int32 and got.shape == (b, 7 + N)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(single, want[0])


def test_generate_through_the_filter_equals_jax(ref):
    # one prompt (invoke, B = 1), then a block of two (invoke_batch, B = 2)
    prompts = _prompts(3, seed=1)
    want = np.concatenate([np.asarray(ref["gen"](ref["gen_params"], [p])[0])
                           for p in (prompts[:1], prompts[1:])])
    assert min(_margins(_jax_logits(ref, w)[:, 6:-1]).min() for w in (want[:1], want[1:])) > 1e-4
    name = "torch_parity_generate"
    _, in_spec, out_spec = tr.build(dict(PROPS, generate=str(N)))
    register_torch_model(name, tr.GenerateLM(ref["lm"], N), in_spec, out_spec)
    try:
        pipe = parse_pipeline(f"appsrc name=src ! tensor_filter name=f model={name} "
                              "accelerator=cpu ! tensor_sink name=out")
        pipe.start()
        try:
            pipe["src"].push(prompts[0], pts=0.0)
            pipe["src"].push_block(prompts[1:], pts=[1.0, 2.0])
            pipe["src"].end_of_stream()
            pipe.wait(timeout=60)
        finally:
            pipe.stop()
    finally:
        unregister_torch_model(name)
    out = pipe["out"].frames
    assert [f.pts for f in out] == [0.0, 1.0, 2.0] and pipe["f"].invokes == 2
    np.testing.assert_array_equal(np.stack([f.tensors[0] for f in out]), want)


def test_stream_halves_equal_one_shot(ref):
    prompt = _prompts(2, seed=2)
    want = np.asarray(ref["gen"](ref["gen_params"], [prompt])[0])[:, 7:]
    assert _margins(_jax_logits(ref, np.concatenate([prompt, want], 1))[:, 6:-1]).min() > 1e-4
    prefill, decode_chunk = tr.make_stream_generate(ref["lm"])
    cache, tok = prefill(torch.from_numpy(prompt))
    got, t = [tok[:, None]], 1
    for n in (4, 4, 3, 1):  # chunked as a stream: buckets of 4 and tails
        cache, tok, toks = decode_chunk(cache, tok, t, n)
        got.append(toks)
        t += n
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(), want)
    assert cache.pos.tolist() == [7 + N - 1] * 2


def test_chunked_prefill_last_logits_match_jax(ref):
    """A prompt prefilled in pieces of 3, 3 and 1 into slot 2 of 4."""
    prompt = _prompts(1, seed=3)
    jmodel, jparams, _ = jax_slot_stream(PROPS, 4)
    jcache = jmodel.reset_slot(jmodel.init_cache(), np.int32(2))
    model = tr.SlotModel(ref["lm"], 4)
    cache = model.reset_slot(model.init_cache(), 2)
    for a, b in ((0, 3), (3, 6), (6, 7)):
        jcache, jlogits = jmodel.prefill_fn(b - a)(jparams, jcache, prompt[:, a:b], np.int32(2))
        cache, logits = model.prefill_fn(b - a)(cache, torch.from_numpy(prompt[:, a:b]), 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), _jax_logits(ref, prompt)[:, -1],
                               rtol=1e-4, atol=1e-4)
    assert cache.pos.tolist() == [0, 0, 7, 0]
    assert not cache.k[:, [0, 1, 3]].any()  # the neighbours untouched


_KEYS = {
    "PRNGKey(0)": (lambda: jax.random.PRNGKey(0), lambda: threefry.prng_key(0)),
    "PRNGKey(5)": (lambda: jax.random.PRNGKey(5), lambda: threefry.prng_key(5)),
    "fold_in(PRNGKey(3), 7)": (lambda: jax.random.fold_in(jax.random.PRNGKey(3), 7),
                               lambda: threefry.fold_in(threefry.prng_key(3), 7)),
    "fold_in(fold_in(PRNGKey(11), 1), 2**31)": (
        lambda: jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(11), 1), 2**31),
        lambda: threefry.fold_in(threefry.fold_in(threefry.prng_key(11), 1), 2**31)),
}


@pytest.mark.parametrize("shape", [(1, 61), (2, 61), (2, 50257)], ids=str)
@pytest.mark.parametrize("key", list(_KEYS))
def test_threefry_bits_and_uniforms_equal_jax(key, shape):
    jkey, pkey = (f() for f in _KEYS[key])
    assert tuple(int(w) for w in np.asarray(jkey)) == pkey
    bits = np.asarray(jax.random.bits(jkey, shape)).astype(np.int64)
    np.testing.assert_array_equal(threefry.random_bits(pkey, shape).numpy(), bits)
    for lo in (0.0, TINY):
        u = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, 1.0))
        got = threefry.uniform(pkey, shape, lo, 1.0).numpy()
        np.testing.assert_array_equal(got.view(np.int32), u.view(np.int32))
    g = np.asarray(jax.random.gumbel(jkey, shape))
    np.testing.assert_allclose(threefry.gumbel(pkey, shape).numpy(), g, rtol=1e-5, atol=1e-5)


def test_threefry_per_row_keys_equal_per_row_draws():
    """Tensor words draw one (1, V) block per key, as the vmapped per-slot
    pick does; gen 0 keeps the raw key."""
    gen = torch.tensor([0, 1, 5, 9])
    key0 = threefry.prng_key(3)
    folded = threefry.fold_in(key0, gen)
    keys = tuple(torch.where(gen == 0, k0, k) for k0, k in zip(key0, folded))
    got = threefry.random_bits(keys, (1, 61))
    assert got.shape == (4, 1, 61)
    for i, g in enumerate(gen.tolist()):
        k = jax.random.PRNGKey(3) if g == 0 else jax.random.fold_in(jax.random.PRNGKey(3), g)
        want = np.asarray(jax.random.bits(k, (1, 61))).astype(np.int64)
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("b", [1, 2])
def test_sampled_tokens_equal_jax_outside_near_ties(ref, b):
    props = dict(PROPS, generate=str(N), **SAMPLING)
    gen_fn, gen_params, _, _ = jax_build("transformer", props)
    prompt = _prompts(b, seed=4)
    want = np.asarray(gen_fn(gen_params, [prompt])[0])
    # the reference's per-step margin of logits / T (top 7) + gumbel
    logits = _jax_logits(ref, want)[:, 6:-1].astype(np.float32) / np.float32(0.8)
    kth = np.sort(logits, axis=-1)[..., -7:-6]
    logits = np.where(logits >= kth, logits, np.float32(-1e30))
    key0 = jax.random.PRNGKey(3)
    noise = np.stack([np.asarray(jax.random.gumbel(
        key0 if i == 0 else jax.random.fold_in(key0, i), (b, 61))) for i in range(N)], 1)
    margins = _margins(logits + noise).min(axis=0)  # (N,) over the rows
    low = np.flatnonzero(margins <= 1e-5)
    first = int(low[0]) if low.size else N
    assert first >= 8  # seed 3 and these prompts: no near-tie in the first 8 steps
    module = tr.GenerateLM(ref["lm"], N, **tr._sampling(props))
    with torch.inference_mode():
        got = module(torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got[:, :7 + first], want[:, :7 + first])


def test_one_shot_overrun_raises_as_jax(ref):
    module = tr.GenerateLM(ref["lm"], 60)
    with pytest.raises(ValueError, match="prompt 7 \\+ generate 60 exceeds max_seq 64"):
        module(torch.from_numpy(_prompts(1)))
