"""Fused top-1 (argmax + max score) over class logits.

Port of ``nnstreamer_tpu/ops/labeling.py``, the image-labeling decoder's
device half.  On a CUDA tensor :func:`top1` and :func:`top1_packed`
launch the hand-written kernel ``csrc/top1.cu``; on a CPU tensor they run
:func:`top1_plain` and :func:`top1_packed_plain`.  All follow
``jnp.argmax``/``jnp.max`` for float32, bfloat16 and float16 logits: the
first maximal index wins ties, NaN counts as the maximum (first NaN's
index, value NaN), a row of all -inf gives index 0, and the max is the
float32 of the winning element.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

#: kernel launches made by :func:`top1` and :func:`top1_packed` in this process
LAUNCHES = 0

#: the kernel's code for each logits dtype
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: columns below which float32 holds every index exactly (the packed form)
PACKED_MAX_COLS = 2**24

_SIGNATURES = {
    "nns_top1": (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ),
}


def top1_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version for (B, C) float32, bfloat16 or float16,
    compared in float32 (exact for all three): the rules are spelled out
    rather than left to ``torch.max``, whose index on ties is not
    documented."""
    x = x.float()
    nan = torch.isnan(x)
    row_nan = nan.any(dim=1)
    best = x.masked_fill(nan, float("-inf")).amax(dim=1)
    # a NaN row's winner is its first NaN; any other row's is its first max
    hit = torch.where(row_nan[:, None], nan, x == best[:, None])
    cols = torch.arange(x.shape[1], device=x.device).expand_as(x)
    idx = torch.where(hit, cols, x.shape[1]).amin(dim=1).to(torch.int32)
    val = torch.where(row_nan, torch.full_like(best, float("nan")), best)
    return idx, val


def top1_packed_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`top1_packed`: (B, C) -> (B, 2) float32
    ``[float(argmax), max]``."""
    idx, val = top1_plain(x)
    return torch.stack([idx.to(torch.float32), val], dim=-1)


def _rows(logits: torch.Tensor, what: str, max_cols: int = 2**31) -> torch.Tensor:
    """`logits` as (B, C) after the checks both wrappers share."""
    x = logits[None] if logits.dim() == 1 else logits
    if x.dim() != 2 or x.shape[1] == 0 or x.shape[1] >= max_cols:
        raise ValueError(f"{what} takes (B, C) or (C,) with 0 < C < {max_cols}, "
                         f"got {tuple(logits.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32, bfloat16 or float16 logits, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x


def _launch(x: torch.Tensor, idx=None, val=None, packed=None) -> None:
    """One launch of the kernel on (B, C) CUDA `x`, into (idx, val) or
    `packed`.  Columns must be unit stride (any row stride and start):
    a view whose columns are not gets one ``.contiguous()`` copy first."""
    global LAUNCHES
    rows, cols = x.shape
    if rows == 0:
        return
    if cols > 1 and x.stride(1) != 1:
        x = x.contiguous()
    lib = _build.load("top1", _SIGNATURES)
    outs = [None if t is None else t.data_ptr() for t in (idx, val, packed)]  # None: NULL
    with torch.cuda.device(x.device):
        err = lib.nns_top1(x.data_ptr(), _DTYPES[x.dtype], rows, cols, x.stride(0), *outs,
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "top1")
    LAUNCHES += 1


def top1(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, C) or (C,) float32, bfloat16 or float16 -> (argmax int32,
    max float32) per row.  A CUDA view is read in place when its columns
    are unit stride, whatever its row stride and start; any other view is
    copied once with ``.contiguous()`` first."""
    x = _rows(logits, "top1")
    if x.device.type == "cpu":
        idx, val = top1_plain(x)
    else:
        idx = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
        val = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        _launch(x, idx=idx, val=val)
    return (idx[0], val[0]) if logits.dim() == 1 else (idx, val)


def top1_packed(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, C) or (C,) -> (B, 2) or (2,) float32 ``[float(argmax),
    max]`` per row in one launch: the image-labeling decoder's device half.
    C must be below 2**24, where float32 stops holding every index exactly.
    Views are taken as by :func:`top1`."""
    x = _rows(logits, "top1_packed", PACKED_MAX_COLS)
    if x.device.type == "cpu":
        packed = top1_packed_plain(x)
    else:
        packed = torch.empty(x.shape[0], 2, dtype=torch.float32, device=x.device)
        _launch(x, packed=packed)
    return packed[0] if logits.dim() == 1 else packed
