"""Fused uint8 -> float normalize (scale + bias + cast).

Port of ``nnstreamer_tpu/ops/preprocess.py``: ``x * scale + bias`` computed
in float32 and cast to the output dtype, the MobileNet ingest transform.
On a CUDA tensor :func:`normalize_u8` launches the hand-written kernel
``csrc/normalize_u8.cu`` (bit-exact against :func:`normalize_u8_plain`);
on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches made by :func:`normalize_u8` in this process
LAUNCHES = 0

_OUT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SIGNATURES = {
    "nns_normalize_u8": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ),
}


def normalize_u8_plain(
    x: torch.Tensor, scale: float = 2.0 / 255.0, bias: float = -1.0,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The plain PyTorch version: float32 multiply, float32 add, cast."""
    return (x.to(torch.float32) * scale + bias).to(dtype)


def normalize_u8(
    x: torch.Tensor, scale: float = 2.0 / 255.0, bias: float = -1.0,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``x * scale + bias`` cast to `dtype` (default: uint8 [0, 255] ->
    [-1, 1] bf16).  Accepts a uint8 tensor of any shape; a CUDA tensor must
    be contiguous (it may start at any offset)."""
    global LAUNCHES
    if x.dtype != torch.uint8:
        raise TypeError(f"normalize_u8 takes uint8, got {x.dtype}")
    if dtype not in _OUT_CODES:
        raise TypeError(f"normalize_u8 outputs float32/float16/bfloat16, not {dtype}")
    if x.device.type == "cpu":
        return normalize_u8_plain(x, scale, bias, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"normalize_u8: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("normalize_u8: the CUDA kernel needs a contiguous tensor")
    lib = _build.load("normalize_u8", _SIGNATURES)
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel():
        with torch.cuda.device(x.device):
            err = lib.nns_normalize_u8(
                x.data_ptr(), out.data_ptr(), x.numel(), _OUT_CODES[dtype], scale, bias,
                torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, err, "normalize_u8")
        LAUNCHES += 1
    return out
