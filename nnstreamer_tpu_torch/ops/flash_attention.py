"""Flash attention: exact attention with an online softmax.

Port of ``nnstreamer_tpu/ops/flash_attention.py`` (forward and lse).  The
public layout is the JAX package's: q, k, v are (B, T, H, D), the output
is (B, T, H, D) in q's dtype, the lse (B, H, Tq) float32.  On a CUDA
tensor the wrappers launch the hand-written kernel
``csrc/flash_attention.cu`` or raise; on a CPU tensor they run
:func:`flash_attention_plain`.  The kernel has two routes, chosen by
dtype (:func:`route`): bfloat16 runs on the tensor cores (wgmma, work
items of 128 query rows), float32 on the CUDA cores (blocks of 64 rows).
Both take D a multiple of 8 up to 128, any T (the kernel streams K/V tiles
and masks the ragged one itself) and strided (B, T, H, D) views with D
contiguous; the bfloat16 route reads q, k, v through TMA tensor maps, so
it also needs 16-byte aligned bases and batch, token and head strides that
are multiples of 8 elements (:func:`check_kernel_args`).

Training goes through :func:`flash_attention_grad` (the JAX package's
``flash_attention_grad``, ``:314-352``): its forward is the wrapper's (the
kernel on a CUDA tensor), it saves only q, k and v, and its backward
recomputes the gradients through :func:`reference_attention_lse` under
autograd, as JAX ``_fa_bwd`` takes them by XLA autodiff of its reference:
no kernel computes the backward there either.  The recompute holds the
(B, H, Tq, Tk) float32 scores of one layer at a time.  A direct
:func:`flash_attention` call on a CUDA tensor that needs a gradient raises
and names :func:`flash_attention_grad`.  Both wrappers are also the
operators ``nns_torch::flash_attention`` and
``nns_torch::flash_attention_lse`` (``ops/_oplib.py``), which a traced
module records; they register the same recompute backward.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build, _oplib

#: kernel launches made by :func:`flash_attention` / :func:`flash_attention_lse`, both routes
LAUNCHES = 0
#: the launches of those that ran the bfloat16 tensor-core kernel
LAUNCHES_TENSOR_CORES = 0

_NEG_INF = -1e30  # the masked score, as the Pallas kernel has it
#: the profiler range of :func:`flash_attention_grad`'s recompute backward
RECOMPUTE_RANGE = "nns_torch::flash_attention_recompute_backward"
_NO_BACKWARD = ("flash_attention on a CUDA tensor that needs a gradient: call "
                "flash_attention_grad (kernel forward, recompute backward), or run under "
                "torch.inference_mode()")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
_ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
#: query rows per work item (bfloat16) or block (float32) of each route
QUERY_TILE = {"tensor_cores": 128, "cuda_cores": 64}
_SIGNATURES = {
    "nns_flash_attention": (
        *(ctypes.c_void_p,) * 5, *(ctypes.c_int,) * 6, *(ctypes.c_int64,) * 9,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ),
}


def _check_shapes(q_shape: Sequence[int], k_shape: Sequence[int], v_shape: Sequence[int],
                  causal: bool) -> None:
    if len(q_shape) != 4 or len(k_shape) != 4 or tuple(k_shape) != tuple(v_shape):
        raise ValueError(f"flash attention takes q (B, Tq, H, D) and k, v (B, Tk, H, D), got "
                         f"{tuple(q_shape)}, {tuple(k_shape)}, {tuple(v_shape)}")
    (b, tq, h, d), (bk, tk, hk, dk) = q_shape, k_shape
    if (b, h, d) != (bk, hk, dk) or tk < 1:
        raise ValueError(f"q {tuple(q_shape)} and k/v {tuple(k_shape)} disagree on B, H or D, "
                         "or there are no keys")
    if causal and tq != tk:
        # a misaligned caller must fail loud, never silently mis-mask
        raise ValueError(f"causal flash needs aligned q/k positions (Tq={tq}, Tk={tk})")


def route(dtype: torch.dtype) -> str:
    """Which kernel a CUDA call in `dtype` launches: ``"tensor_cores"``
    (bfloat16, wgmma) or ``"cuda_cores"`` (float32, which TF32 on the
    tensor cores would round to about three decimal digits)."""
    if dtype not in _ROUTES:
        raise TypeError(f"the flash-attention kernel takes bfloat16 or float32, not {dtype}")
    return _ROUTES[dtype]


def check_kernel_args(q_shape: Sequence[int], k_shape: Sequence[int], dtype: torch.dtype,
                      views: Sequence[torch.Tensor] = ()) -> None:
    """Raise for what the CUDA kernel does not take: a dtype other than
    bfloat16/float32, a head dim that is not a multiple of 8 in [8, 128],
    more than 2**31 - 1 (batch, head) pairs, T of 2**31 or more, or a grid
    too large for the route's tiles of :data:`QUERY_TILE` query rows: the
    tensor-core kernel walks one work item per (batch, head, query tile),
    at most 2**31 - 1; the CUDA-core kernel at most 65535 query tiles.  For
    each of `views` (the q, k, v tensors): D must be contiguous, and on
    the bfloat16 route the base must be 16-byte aligned and the batch,
    token and head strides multiples of 8 elements."""
    kernel = route(dtype)
    tile = QUERY_TILE[kernel]
    b, tq, h, d = q_shape
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"the flash-attention kernel takes a head dim that is a multiple of 8 "
                         f"in [8, 128], got D={d}")
    tiles = -(-tq // tile)
    grid_ok = b * h * tiles < 2**31 if kernel == "tensor_cores" else tiles <= 65535
    if b * h >= 2**31 or max(tq, k_shape[1]) >= 2**31 or not grid_ok:
        raise ValueError(f"flash attention: q {tuple(q_shape)} / k {tuple(k_shape)} too large "
                         f"for the kernel's grid ({tile}-row query tiles)")
    for name, t in zip("qkv", views):
        if t.stride(-1) != 1:
            raise ValueError("flash attention: the CUDA kernel needs D contiguous (stride 1)")
        if kernel != "tensor_cores":
            continue
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} starts at an address that is not "
                             "16-byte aligned, which the bfloat16 kernel's TMA reads need")
        if any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"flash attention: {name}'s batch, token and head strides "
                             f"{tuple(t.stride()[:3])} must be multiples of 8 elements (16 "
                             "bytes) for the bfloat16 kernel's TMA reads")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, with_lse: bool = False):
    """The plain PyTorch version, with the Pallas kernel's numerics: q
    scaled by 1/sqrt(D) in float32, float32 scores, masked scores -1e30,
    ``out = (p @ v) / max(l, 1e-30)`` cast to q's dtype and ``lse = m +
    log(l)`` where l > 0, else -1e30.  One softmax over all keys where the
    kernel streams tiles: the same function, summed in another order."""
    _check_shapes(q.shape, k.shape, v.shape, causal)
    d = q.shape[-1]
    qf = q.float().transpose(1, 2) * (1.0 / d**0.5)  # (B, H, Tq, D)
    s = qf @ k.float().permute(0, 2, 3, 1)  # (B, H, Tq, Tk)
    if causal:
        t = torch.arange(q.shape[1], device=q.device)
        s = s.masked_fill(t[:, None] < t[None, :], _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    den = l.clamp_min(1e-30)
    out = ((p @ v.float().transpose(1, 2)) / den).transpose(1, 2).to(q.dtype).contiguous()
    if not with_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(den), torch.full_like(m, _NEG_INF))
    return out, lse[..., 0]


def reference_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention plus lse, differentiable: the counterpart of JAX
    ``reference_attention_lse`` (``ops/flash_attention.py:279-297``) and
    the function the recompute backward differentiates.  Scores are
    accumulated in float32 and divided by sqrt(D) after the product,
    masked scores are -inf, ``p`` is cast to v's dtype before the value
    product (accumulated in float32), the output is cast to q's dtype, and
    a fully masked row's lse is -1e30.  It shares no code with
    :func:`flash_attention_plain`, the kernel's test version."""
    _check_shapes(q.shape, k.shape, v.shape, causal)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (q.shape[-1] ** 0.5)
    if causal:
        t = torch.arange(q.shape[1], device=q.device)
        s = s.masked_fill(t[:, None] < t[None, :], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)  # (B, H, Tq); -inf on fully masked rows
    masked = torch.isinf(lse)
    p = torch.exp(s - torch.where(masked, 0.0, lse)[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, torch.where(masked, _NEG_INF, lse)


def _recompute_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                     g_out: torch.Tensor, g_lse=None):
    """(dq, dk, dv) by autograd through :func:`reference_attention_lse`
    (JAX ``_fa_bwd``); `g_lse` also pulls on the lse where given.  A
    ``torch.profiler`` session sees it as the range
    :data:`RECOMPUTE_RANGE`."""
    with torch.enable_grad(), torch.profiler.record_function(RECOMPUTE_RANGE):
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out, lse = reference_attention_lse(*qkv, causal=causal)
        outs, grads = [out], [g_out]
        if g_lse is not None:
            outs.append(lse)
            grads.append(g_lse)
        return torch.autograd.grad(outs, qkv, grads)


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, with_lse: bool):
    global LAUNCHES, LAUNCHES_TENSOR_CORES
    _check_shapes(q.shape, k.shape, v.shape, causal)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention: q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, with_lse=True)
    if q.device.type != "cuda" or not (q.device == k.device == v.device):
        raise ValueError(f"flash attention: tensors on {q.device}, {k.device}, {v.device}")
    check_kernel_args(q.shape, k.shape, q.dtype, views=(q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(_NO_BACKWARD)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel():
        with torch.cuda.device(q.device):
            err = lib.nns_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None, _DTYPE_CODES[q.dtype], b, h, tq, tk, d,
                q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2), 1.0 / d**0.5, int(causal),
                torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, err, "flash_attention")
        LAUNCHES += 1
        if route(q.dtype) == "tensor_cores":
            LAUNCHES_TENSOR_CORES += 1
    return out, lse


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    return _run(q, k, v, causal, with_lse=False)[0]


def _flash_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return _run(q, k, v, causal, with_lse=True)


_flash_op = torch.library.custom_op(_oplib.name("flash_attention"), _flash, mutates_args=())
_flash_lse_op = torch.library.custom_op(_oplib.name("flash_attention_lse"), _flash_lse,
                                        mutates_args=())


def _fake_out(q, k, v, causal):
    _check_shapes(q.shape, k.shape, v.shape, causal)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention: q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    return q.new_empty(q.shape)


@_flash_op.register_fake
def _(q, k, v, causal):
    return _fake_out(q, k, v, causal)


@_flash_lse_op.register_fake
def _(q, k, v, causal):
    out = _fake_out(q, k, v, causal)
    return out, q.new_empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32)


def _save_qkv(ctx, inputs, output):
    q, k, v, causal = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal = causal


def _op_backward(ctx, g_out):
    return (*_recompute_grads(*ctx.saved_tensors, ctx.causal, g_out), None)


def _op_lse_backward(ctx, g_out, g_lse):
    return (*_recompute_grads(*ctx.saved_tensors, ctx.causal, g_out, g_lse), None)


_flash_op.register_autograd(_op_backward, setup_context=_save_qkv)
_flash_lse_op.register_autograd(_op_lse_backward, setup_context=_save_qkv)


class _FlashAttentionGrad(torch.autograd.Function):
    """Kernel forward, recompute backward (JAX ``_fa_fwd``/``_fa_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)  # the only residuals, as JAX _fa_fwd keeps
        ctx.causal = causal
        return _flash(q, k, v, causal)

    @staticmethod
    def backward(ctx, g_out):
        return (*_recompute_grads(*ctx.saved_tensors, ctx.causal, g_out), None)


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """Differentiable flash attention, (B, T, H, D) -> (B, T, H, D) in q's
    dtype: the forward launches the kernel on a CUDA tensor (the plain
    version on a CPU one) and saves only q, k, v; the backward recomputes
    through :func:`reference_attention_lse`.  A traced call records the
    operator, whose backward is the same."""
    if _oplib.tracing():
        return torch.ops.nns_torch.flash_attention(q, k, v, causal)
    return _FlashAttentionGrad.apply(q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Exact attention, (B, T, H, D) -> (B, T, H, D) in q's dtype."""
    if _oplib.tracing():
        return torch.ops.nns_torch.flash_attention(q, k, v, causal)
    return _flash(q, k, v, causal)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention plus the per-row log-sum-exp: (B, Tq, H, D) q and
    (B, Tk, H, D) k, v -> ((B, Tq, H, D), (B, H, Tq) float32).  Tk may
    differ from Tq when not causal.  The lse is the merge statistic of two
    partials over disjoint keys: ``lse = logaddexp(lse1, lse2)``, ``out =
    out1 * exp(lse1 - lse) + out2 * exp(lse2 - lse)``."""
    if _oplib.tracing():
        return torch.ops.nns_torch.flash_attention_lse(q, k, v, causal)
    return _flash_lse(q, k, v, causal)
