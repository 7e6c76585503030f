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
are multiples of 8 elements (:func:`check_kernel_args`).  The
recompute-backward ``flash_attention_grad`` waits for the training slice:
a CUDA call that needs a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

#: kernel launches made by :func:`flash_attention` / :func:`flash_attention_lse`, both routes
LAUNCHES = 0
#: the launches of those that ran the bfloat16 tensor-core kernel
LAUNCHES_TENSOR_CORES = 0

_NEG_INF = -1e30  # the masked score, as the Pallas kernel has it
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
        raise RuntimeError("flash attention on CUDA has no backward yet (the training slice, "
                           "ROADMAP A9): call it under torch.inference_mode()")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Exact attention, (B, T, H, D) -> (B, T, H, D) in q's dtype."""
    return _run(q, k, v, causal, with_lse=False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention plus the per-row log-sum-exp: (B, Tq, H, D) q and
    (B, Tk, H, D) k, v -> ((B, Tq, H, D), (B, H, Tq) float32).  Tk may
    differ from Tq when not causal.  The lse is the merge statistic of two
    partials over disjoint keys: ``lse = logaddexp(lse1, lse2)``, ``out =
    out1 * exp(lse1 - lse) + out2 * exp(lse2 - lse)``."""
    return _run(q, k, v, causal, with_lse=True)
