"""Fused top-1 (argmax + max score) over class logits.

Port of ``nnstreamer_tpu/ops/labeling.py``, the image-labeling decoder's
device half.  On a CUDA tensor :func:`top1` launches the hand-written
kernel ``csrc/top1.cu``; on a CPU tensor it runs :func:`top1_plain`.
Both follow ``jnp.argmax``/``jnp.max``: the first maximal index wins ties,
NaN counts as the maximum (first NaN's index, value NaN), and a row of
all -inf gives index 0.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

#: kernel launches made by :func:`top1` in this process
LAUNCHES = 0

_SIGNATURES = {
    "nns_top1_f32": (
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ),
}


def top1_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version for (B, C) float32: the rules are spelled
    out rather than left to ``torch.max``, whose index on ties is not
    documented."""
    nan = torch.isnan(x)
    row_nan = nan.any(dim=1)
    best = x.masked_fill(nan, float("-inf")).amax(dim=1)
    # a NaN row's winner is its first NaN; any other row's is its first max
    hit = torch.where(row_nan[:, None], nan, x == best[:, None])
    cols = torch.arange(x.shape[1], device=x.device).expand_as(x)
    idx = torch.where(hit, cols, x.shape[1]).amin(dim=1).to(torch.int32)
    val = torch.where(row_nan, torch.full_like(best, float("nan")), best)
    return idx, val


def top1(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, C) or (C,) float32 -> (argmax int32, max float32) per
    row.  A CUDA tensor must be contiguous."""
    global LAUNCHES
    single = logits.dim() == 1
    x = logits[None] if single else logits
    if x.dim() != 2 or x.shape[1] == 0 or x.shape[1] >= 2**31:
        raise ValueError(f"top1 takes (B, C) or (C,) with 0 < C < 2**31, got {tuple(logits.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"top1 takes float32 logits, got {x.dtype}")
    if x.device.type == "cpu":
        idx, val = top1_plain(x)
    elif x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError("top1: the CUDA kernel needs a contiguous tensor")
        lib = _build.load("top1", _SIGNATURES)
        rows, cols = x.shape
        idx = torch.empty(rows, dtype=torch.int32, device=x.device)
        val = torch.empty(rows, dtype=torch.float32, device=x.device)
        if rows:
            with torch.cuda.device(x.device):
                err = lib.nns_top1_f32(
                    x.data_ptr(), rows, cols, idx.data_ptr(), val.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
            _build.check(lib, err, "top1")
            LAUNCHES += 1
    else:
        raise ValueError(f"top1: unsupported device {x.device}")
    return (idx[0], val[0]) if single else (idx, val)
