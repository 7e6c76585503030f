"""Port parity: the port's flash attention against the Pallas kernel.

The JAX side runs ``_flash_kernel`` itself in Pallas interpret mode
(``interpret=True``) on the CPU; the port's wrappers, given CPU tensors,
run their plain version (``flash_attention_plain``), which mirrors that
kernel's numerics.  Same inputs from ``numpy.random.default_rng``.  Float32
at ``atol=3e-5`` (``tests/test_flash_attention.py``'s tolerance: the two
sum in another order); bfloat16 inputs compared in float32 at
``atol=rtol=1e-2``, about one bf16 ulp of the output.  Plus the port's
``reference_attention`` against the JAX one, and the CUDA kernel's route
choice and argument checks as pure functions of dtypes, shapes, strides
and addresses (views on the meta device; no card here).

The training slice's ``flash_attention_grad`` (kernel forward, recompute
backward) against JAX ``flash_attention_grad`` in interpret mode
(``tests/test_flash_attention.py:191-208``): the three gradients of
``sum(out * g)`` for a seeded cotangent ``g``, float32 at ``atol=5e-5``
(that file's gradient tolerance) and bfloat16 at the bfloat16 tolerance
above; ``reference_attention_lse`` against the JAX one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.ops.flash_attention import flash_attention as jax_flash
from nnstreamer_tpu.ops.flash_attention import flash_attention_grad as jax_flash_grad
from nnstreamer_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse
from nnstreamer_tpu.ops.flash_attention import reference_attention_lse as jax_reference_lse
from nnstreamer_tpu.parallel.ring_attention import reference_attention as jax_reference
from nnstreamer_tpu_torch.ops import flash_attention as fa
from nnstreamer_tpu_torch.parallel.ring_attention import reference_attention

torch.set_num_threads(2)

F32 = dict(atol=3e-5, rtol=0)
BF16 = dict(atol=1e-2, rtol=1e-2)


def _qkv(b, tq, h, d, tk=None, seed=0, bf16=False):
    """(jax (q, k, v), torch (q, k, v)) holding the same values."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, t, h, d), dtype=np.float32) for t in (tq, tk or tq, tk or tq)]
    if bf16:  # both round float32 to nearest even
        return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
                [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bq,bk", [(64, 64), (96, 64)])
def test_ragged_t_matches_pallas(causal, bq, bk):
    # T = 100 is no multiple of either block: the Pallas wrapper pads and
    # masks at valid_len; the port masks the ragged tile itself
    (jq, jk, jv), (q, k, v) = _qkv(2, 100, 2, 32, seed=1)
    want = jax_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk, interpret=True)
    got = fa.flash_attention(q, k, v, causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_vit_token_count_matches_pallas():
    # ViT's (S/p)^2 + 1 = 197 tokens, non-causal, at the default blocks
    (jq, jk, jv), (q, k, v) = _qkv(1, 197, 2, 16, seed=2)
    want = jax_flash(jq, jk, jv, causal=False, interpret=True)
    np.testing.assert_allclose(fa.flash_attention(q, k, v, causal=False).numpy(),
                               np.asarray(want), **F32)


@pytest.mark.parametrize("causal,tk", [(False, 128), (True, 64)])
def test_lse_matches_pallas(causal, tk):
    (jq, jk, jv), (q, k, v) = _qkv(2, 64, 2, 32, tk=tk, seed=3)
    want_out, want_lse = jax_flash_lse(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                                       interpret=True)
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    assert out.shape == (2, 64, 2, 32) and lse.shape == (2, 2, 64) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_pallas(causal):
    (jq, jk, jv), (q, k, v) = _qkv(2, 64, 2, 32, seed=4, bf16=True)
    want_out, want_lse = jax_flash_lse(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                                       interpret=True)
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(want_out), **BF16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
    (jq, jk, jv), (q, k, v) = _qkv(2, 40, 2, 16, seed=5)
    np.testing.assert_allclose(reference_attention(q, k, v, causal=causal).numpy(),
                               np.asarray(jax_reference(jq, jk, jv, causal=causal)), **F32)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_grad_matches_jax_flash_attention_grad(causal, bf16):
    import jax

    (jq, jk, jv), (q, k, v) = _qkv(1, 32, 2, 8, seed=9, bf16=bf16)
    g = np.random.default_rng(10).standard_normal((1, 32, 2, 8)).astype(np.float32)

    def loss(q, k, v):
        out = jax_flash_grad(q, k, v, causal, 16, 16, True)
        return jnp.sum(out.astype(jnp.float32) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_grad(*qkv, causal=causal)
    assert out.dtype == q.dtype and out.grad_fn is not None
    (out.float() * torch.from_numpy(g)).sum().backward()
    for t, w in zip(qkv, want):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(_f32(t.grad), _f32(w), **(BF16 if bf16 else dict(atol=5e-5,
                                                                                   rtol=0)))


@pytest.mark.parametrize("causal,tk", [(False, 24), (True, 16)])
def test_reference_attention_lse_matches_jax(causal, tk):
    (jq, jk, jv), (q, k, v) = _qkv(2, 16, 2, 8, tk=tk, seed=11)
    want_out, want_lse = jax_reference_lse(jq, jk, jv, causal=causal)
    out, lse = fa.reference_attention_lse(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **F32)


def test_grad_on_cpu_launches_nothing_and_saves_only_qkv():
    _, (q, k, v) = _qkv(1, 16, 1, 8, seed=12)
    before = fa.LAUNCHES
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_grad(*qkv, causal=True)
    assert fa.LAUNCHES == before
    assert torch.equal(out.detach(), fa.flash_attention_plain(q, k, v, causal=True))
    assert [t.data_ptr() for t in out.grad_fn.saved_tensors] == [t.data_ptr() for t in qkv]


def test_causal_needs_aligned_positions():
    _, (q, k, v) = _qkv(1, 8, 1, 8, tk=16)
    for fn in (fa.flash_attention, fa.flash_attention_lse, fa.flash_attention_plain):
        with pytest.raises(ValueError, match="aligned"):
            fn(q, k, v, causal=True)
    fa.flash_attention_lse(q, k, v, causal=False)  # non-causal takes Tk != Tq


def test_cpu_tensor_runs_the_plain_version_without_a_launch():
    _, (q, k, v) = _qkv(1, 33, 2, 8, seed=6)
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.LAUNCHES == before
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal=True))


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty(1, 8, 1, 8, device="meta")
    with pytest.raises(ValueError, match="tensors on meta"):
        fa.flash_attention(q, q, q, causal=False)
    with pytest.raises(TypeError, match="dtypes differ"):
        fa.flash_attention(q, q, q.to(torch.bfloat16), causal=False)


@pytest.mark.parametrize("d", [4, 12, 60, 136])
def test_kernel_refuses_unsupported_head_dims(d):
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.check_kernel_args((2, 64, 2, d), (2, 64, 2, d), torch.bfloat16)


def test_kernel_argument_check_takes_the_slice_shapes():
    for shape in [(128, 197, 12, 64), (8, 1024, 12, 64), (2, 1, 2, 8), (2, 100, 2, 128)]:
        for dtype in (torch.bfloat16, torch.float32):
            fa.check_kernel_args(shape, shape, dtype)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.check_kernel_args((2, 64, 2, 64), (2, 64, 2, 64), torch.float16)
    with pytest.raises(ValueError, match="too large"):
        fa.check_kernel_args((2**16, 64, 2**15, 64), (2**16, 64, 2**15, 64), torch.bfloat16)


# --- the CUDA kernel's two routes and what each takes (pure functions of
# dtypes, shapes, strides and addresses; views on the meta device) ---


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_cores"),
                                         (torch.float32, "cuda_cores")])
def test_route_follows_the_dtype(dtype, route):
    assert fa.route(dtype) == route


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.route(torch.float16)


@pytest.mark.parametrize("block,b,t", [("EncoderBlock", 128, 197), ("Block", 8, 1024)],
                         ids=["vit_b16", "gpt2_small"])
def test_kernel_args_take_the_models_own_views(block, b, t, monkeypatch):
    # the port's own blocks at full width, on meta: q, k, v are views of one
    # fused projection at 0, H*D and 2*H*D elements with token stride 3*H*D
    from nnstreamer_tpu_torch.models import transformer, vit

    seen = []

    def record(q, k, v, *, causal):
        fa.check_kernel_args(q.shape, k.shape, q.dtype, views=(q, k, v))
        seen.append((tuple(q.shape), q.stride(), k.data_ptr() - q.data_ptr(),
                     v.data_ptr() - q.data_ptr(), causal))
        return q

    monkeypatch.setattr(transformer, "flash_attention", record)
    monkeypatch.setattr(transformer, "flash_attention_grad", record)  # grad mode: training
    with torch.device("meta"):
        cls = getattr(vit if block == "EncoderBlock" else transformer, block)
        cls(768, 12, 3072, torch.bfloat16, attn_impl="flash")(
            torch.empty(b, t, 768, dtype=torch.bfloat16))
    assert seen == [((b, t, 12, 64), (t * 2304, 2304, 64, 1), 768 * 2, 2 * 768 * 2,
                     block == "Block")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_args_take_a_head_major_view(dtype):
    # (B, H, T, D) storage read as (B, T, H, D): head stride T*D, token stride D
    q = torch.empty(2, 3, 200, 64, device="meta", dtype=dtype).transpose(1, 2)
    fa.check_kernel_args(q.shape, q.shape, dtype, views=(q, q, q))


def _bf16(*shape):
    return torch.empty(*shape, device="meta", dtype=torch.bfloat16)


@pytest.mark.parametrize("make,match", [
    (lambda: _bf16(2 * 64 * 2 * 64 + 8)[1:1 + 2 * 64 * 2 * 64].view(2, 64, 2, 64),
     "k starts at an address that is not 16-byte aligned"),
    (lambda: _bf16(2, 64, 2 * 64 + 4)[..., :128].reshape(2, 64, 2, 64),
     r"k's batch, token and head strides \(8448, 132, 64\) must be multiples of 8"),
    (lambda: _bf16(2, 64, 2, 68)[..., :64], "multiples of 8 elements"),
    (lambda: _bf16(2, 64, 2, 128)[..., ::2], "D contiguous"),
], ids=["base_off_by_one_element", "token_stride_132", "head_stride_68", "d_strided"])
def test_kernel_args_refuse_what_the_bf16_kernel_cannot_read(make, match):
    ok = _bf16(2, 64, 2, 64)
    bad = make()
    with pytest.raises(ValueError, match=match):
        fa.check_kernel_args(ok.shape, bad.shape, torch.bfloat16, views=(ok, bad, ok))


def test_float32_route_takes_any_batch_token_head_strides():
    # the CUDA-core kernel reads element by element: no alignment rule
    odd = torch.empty(2, 64, 2 * 64 + 4, device="meta")[..., :128].reshape(2, 64, 2, 64)
    shifted = torch.empty(2 * 64 * 2 * 64 + 1, device="meta")[1:].view(2, 64, 2, 64)
    fa.check_kernel_args(odd.shape, odd.shape, torch.float32, views=(odd, shifted, odd))


@pytest.mark.parametrize("dtype,heads,t_fits,t_over", [
    # bfloat16: one work item per (batch, head, 128-row query tile), < 2**31
    (torch.bfloat16, 2**16, 128 * (2**15 - 1), 128 * (2**15 - 1) + 1),
    # float32: at most 65535 query tiles of 64 rows
    (torch.float32, 1, 64 * 65535, 64 * 65535 + 1),
], ids=["tensor_cores", "cuda_cores"])
def test_grid_limit_follows_the_query_tile(dtype, heads, t_fits, t_over):
    fa.check_kernel_args((1, t_fits, heads, 64), (1, t_fits, heads, 64), dtype)
    with pytest.raises(ValueError, match="too large"):
        fa.check_kernel_args((1, t_over, heads, 64), (1, t_over, heads, 64), dtype)
    # the float32 limit is not the bfloat16 one: 128-row tiles halve the count
    fa.check_kernel_args((1, 64 * 65535 + 1, 1, 64), (1, 64 * 65535 + 1, 1, 64), torch.bfloat16)
