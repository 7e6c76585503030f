"""Int8 inference: symmetric quantization, int8 convolution, int8 dense.

Port of ``nnstreamer_tpu/ops/quantize.py`` (post-training, calibration-free,
the ``quantize:int8`` zoo prop).  The scheme, step for step as the
reference computes it, so that on equal inputs the int8 values, scales,
int32 accumulators and outputs are bit-equal:

* :func:`quantize_symmetric`: ``x`` cast to float32, ``amax`` = max |x|
  over ``axes``, ``scale = max(amax, 1e-8) / 127`` (a true float32
  division), ``q = clip(round(x / scale), -127, 127)`` with round half to
  even, as int8.
* :func:`int8_conv`: one activation scale per SAMPLE (over H, W and C: a
  frame's result never depends on its micro-batch neighbours), one weight
  scale per output channel; TensorFlow SAME padding; int32 accumulation;
  the epilogue ``rescale = s_x * s_w`` in float32, then ``(float32(acc) *
  rescale)`` cast to the output dtype.
* :func:`int8_dense`: one activation scale per row (last axis), one weight
  scale per output column, the same accumulation and epilogue.

Layouts are PyTorch's at the public functions: NCHW activations (held
``channels_last``, so each sample is one contiguous HWC row), OIHW conv
weights, ``(out, in)`` dense weights.  Quantized weights are kept as rows
of the OHWI (or ``(out, in)``) weight: one row per output channel.

On a CUDA tensor the work goes to three hand-written kernels, two of them
by two routes chosen from the shape before any launch (neither falls back
to the other): ``csrc/quantize_i8.cu`` for activations and weights alike
(:func:`quantize_plan`: one cooperative launch that reads the input once,
in waves of whole rows, or the two-pass kernel for a row longer than a
wave or an unaligned one), ``csrc/int8_conv.cu`` for ``groups == 1`` and
dense layers (:func:`int8_conv_plan`: one s8 wgmma kernel whose A tile
comes by TMA where the activation is a plain row-major ``[M, K]`` matrix,
else gathered as an implicit GEMM by a producer warpgroup; the tile width
from O and the copy width from C and the bases) and ``csrc/int8_dwconv.cu``
(direct depthwise convolution, ``groups == C == out``, by
:func:`int8_dwconv_plan`'s bands of shared memory).  Other groups, dtypes or layouts raise there.  On
a CPU tensor the plain versions run: the integer products in float64
(``F.conv2d`` with ``groups``, ``torch.matmul``), exact since every partial
sum stays below 2^53.

Weight quantization is deterministic, so callers may quantize a weight
once per version and pass it as ``qweight`` (``models/_quant_flax.py``
caches it per ``weight._version`` and ``data_ptr``) where the JAX graph
re-quantizes its float params on every call.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

#: launches of ``csrc/quantize_i8.cu`` (one per quantized tensor, either
#: route) in this process, and of each route
QUANTIZE_LAUNCHES = 0
QUANTIZE_ONEPASS_LAUNCHES = 0
QUANTIZE_TWOPASS_LAUNCHES = 0
#: launches of ``csrc/int8_conv.cu`` (convolutions with groups 1 and dense
#: layers, either route), and of each route
CONV_LAUNCHES = 0
CONV_GEMM_LAUNCHES = 0
CONV_GATHER_LAUNCHES = 0
#: launches of ``csrc/int8_dwconv.cu`` (depthwise convolutions)
DWCONV_LAUNCHES = 0

EPS = 1e-8

#: the kernels' code of each input and output dtype (int32: the raw accumulator)
_IN_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_OUT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.int32: 3}

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_QUANTIZE_SIGNATURES = {
    # x, in code, rows, cols, row stride, q, scale, scratch, eps, stream
    "nns_quantize_i8": (_P, _I, _I64, _I64, _I64, _P, _P, _P, _F, _P),
    # x, in code, rows, cols, row stride, rows per wave, grid, q, scale,
    # scratch, eps, stream
    "nns_quantize_i8_onepass": (_P, _I, _I64, _I64, _I64, _I64, _I, _P, _P, _P, _F, _P),
}
# xq, s_x, wq, s_w, out, out code, N, H, W, C, O, kh, kw, stride, Ho, Wo,
# pad top, pad left, stream
_CONV_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_CONV_SIGNATURES = {
    # ..., tile n, chunk, staged, stream
    "nns_int8_conv": _CONV_ARGS[:-1] + (_I, _I, _I, _P),
    # a, s_a, b, s_b, out, out code, M, N, K, rows per scale, tile n, stream
    "nns_int8_gemm": (_P, _P, _P, _P, _P, _I, _I64, _I, _I, _I64, _I, _P),
}
# ..., chunk, tile c, rows, tile w, stream
_DWCONV_SIGNATURES = {"nns_int8_dwconv": _CONV_ARGS[:-1] + (_I, _I, _I, _I, _P)}

#: bytes of each of the three wave buffers of a block of the one-pass
#: quantize kernel (``kBufBytes`` in ``csrc/quantize_i8.cu``)
QUANTIZE_BUF_BYTES = 72 * 1024
#: input bytes below which the one-pass kernel takes fewer blocks than SMs
QUANTIZE_BLOCK_BYTES = 16 * 1024
#: output pixels along W one thread of ``csrc/int8_dwconv.cu`` computes
#: (``kPix``), and the largest box side a TMA load takes
DWCONV_PIX = 4
DWCONV_BOX_MAX = 256
#: shared memory of a depthwise block (two input boxes, every channel's
#: weights and scales): two blocks fit an SM
DWCONV_SMEM_BYTES = 110 * 1024
#: threads of a depthwise block (``kThreads``)
DWCONV_THREADS = 256

Quantized = Tuple[torch.Tensor, torch.Tensor]


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow SAME padding (before, after) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


Pads = Tuple[int, int, int, int]


def conv_pads(h: int, w: int, kh: int, kw: int, stride: int,
              pads: Optional[Sequence[int]] = None) -> Pads:
    """(top, bottom, left, right): ``pads`` as given, or SAME where None."""
    if pads is None:
        return same_pads(h, kh, stride) + same_pads(w, kw, stride)
    top, bottom, left, right = (int(p) for p in pads)
    if min(top, bottom, left, right) < 0:
        raise ValueError(f"conv_i8: negative pads {tuple(pads)}")
    return top, bottom, left, right


def conv_out(h: int, w: int, kh: int, kw: int, stride: int, pads: Pads) -> Tuple[int, int]:
    """Output rows and columns of a convolution with explicit pads (VALID:
    pads of 0)."""
    top, bottom, left, right = pads
    return (max(0, (h + top + bottom - kh) // stride + 1),
            max(0, (w + left + right - kw) // stride + 1))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# -- quantization -------------------------------------------------------------

def quantize_symmetric_plain(
    x: torch.Tensor, axes: Optional[Sequence[int]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (int8 values, float32 scale), the scale reduced
    over ``axes`` with the dims kept (a 0-d scale for ``axes=None``).  The
    divisors are tensors on ``x``'s device: PyTorch's CUDA division by a
    host scalar multiplies by its reciprocal, which rounds differently."""
    x = x.to(torch.float32)
    a = x.abs()
    amax = a.amax() if axes is None else a.amax(dim=tuple(axes), keepdim=True)
    d127 = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(amax, EPS) / d127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows_plain(x: torch.Tensor) -> Quantized:
    """The plain version of :func:`quantize_rows`."""
    q, scale = quantize_symmetric_plain(x, axes=(1,))
    return q, scale.reshape(-1)


class QuantizePlan(NamedTuple):
    """How ``csrc/quantize_i8.cu`` runs one (rows, cols) input."""

    route: str  #: "one-pass" or "two-pass"
    grid: int  #: blocks of the one-pass launch (0 for two-pass)
    rows_per_wave: int  #: whole rows each one-pass wave holds (0 for two-pass)


def quantize_plan(rows: int, cols: int, itemsize: int, row_stride: int, x_ptr: int,
                  sms: int) -> QuantizePlan:
    """The route of one quantization, from the shape and the base alone.
    One pass: a cooperative launch of ``grid`` blocks (one per SM, fewer
    for a small input: about ``QUANTIZE_BLOCK_BYTES`` each) walks waves of
    ``rows_per_wave`` whole rows, each block's equal slice of a wave held
    in one of its three ``QUANTIZE_BUF_BYTES`` buffers, so the input is
    read once.  It needs 16-byte aligned rows (base, row bytes, row
    stride) for its bulk copies, and one row in a wave; anything else
    takes the two passes."""
    vec = 16 // itemsize
    row_bytes = cols * itemsize
    aligned = (x_ptr % 16 == 0 and row_bytes % 16 == 0
               and (rows == 1 or row_stride * itemsize % 16 == 0))
    grid = max(1, min(sms, -(-rows * row_bytes // QUANTIZE_BLOCK_BYTES)))

    def slice_bytes(n: int) -> int:  # a block's share of a wave of n rows
        return -(-(-(-n * cols // grid)) // vec) * vec * itemsize

    n = min(rows, grid * (QUANTIZE_BUF_BYTES // itemsize) // cols) if aligned else 0
    while n and slice_bytes(n) > QUANTIZE_BUF_BYTES:
        n -= 1
    return QuantizePlan("one-pass", grid, n) if n else QuantizePlan("two-pass", 0, 0)


def quantize_rows(x: torch.Tensor) -> Quantized:
    """(rows, cols) float32, float16 or bfloat16 -> (int8 (rows, cols)
    contiguous, float32 scale (rows,)): one scale per row.  On a CUDA
    tensor each row must be contiguous (rows may sit at any stride); the
    route is :func:`quantize_plan`'s."""
    global QUANTIZE_LAUNCHES, QUANTIZE_ONEPASS_LAUNCHES, QUANTIZE_TWOPASS_LAUNCHES
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes a 2-D tensor, got {tuple(x.shape)}")
    if x.dtype not in _IN_CODES:
        raise TypeError(f"quantize_rows takes float32/float16/bfloat16, not {x.dtype}")
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    rows, cols = x.shape
    if cols == 0:
        raise ValueError("quantize_rows: rows of no element have no scale")
    if cols > 1 and x.stride(1) != 1:
        raise ValueError("quantize_rows: the CUDA kernel needs each row contiguous")
    _check_cuda(x, "quantize_rows")
    q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scale = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scale
    row_stride = x.stride(0) if rows > 1 else cols
    plan = quantize_plan(rows, cols, x.element_size(), row_stride, x.data_ptr(), _sms(x.device))
    # the rows' abs-max slots, then (one pass) a grid counter a wave
    waves = -(-rows // plan.rows_per_wave) if plan.rows_per_wave else 0
    scratch = torch.empty(rows + waves, dtype=torch.int32, device=x.device)
    lib = _build.load("quantize_i8", _QUANTIZE_SIGNATURES)
    args = (q.data_ptr(), scale.data_ptr(), scratch.data_ptr(), EPS, _stream(x))
    with torch.cuda.device(x.device):
        if plan.route == "one-pass":
            err = lib.nns_quantize_i8_onepass(x.data_ptr(), _IN_CODES[x.dtype], rows, cols,
                                              row_stride, plan.rows_per_wave, plan.grid, *args)
        else:
            err = lib.nns_quantize_i8(x.data_ptr(), _IN_CODES[x.dtype], rows, cols, row_stride,
                                      *args)
    _build.check(lib, err, f"quantize_i8 ({plan.route})")
    QUANTIZE_LAUNCHES += 1
    if plan.route == "one-pass":
        QUANTIZE_ONEPASS_LAUNCHES += 1
    else:
        QUANTIZE_TWOPASS_LAUNCHES += 1
    return q, scale


def quantize_symmetric(
    x: torch.Tensor, axes: Optional[Sequence[int]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale) with ``x ~ values * scale``, the scale
    reduced over ``axes`` with the dims kept (``None``: one per-tensor
    scale, 0-d).  On a CUDA tensor the reduced axes must be the trailing
    ones of a contiguous tensor (one row each); others raise."""
    if x.device.type == "cpu":
        return quantize_symmetric_plain(x, axes)
    nd = x.dim()
    lead = 0 if axes is None else nd - len(axes)
    if axes is not None and sorted(a % nd for a in axes) != list(range(lead, nd)):
        raise ValueError(f"quantize_symmetric: the CUDA kernel reduces trailing axes, not {axes}")
    if not x.is_contiguous():
        raise ValueError("quantize_symmetric: the CUDA kernel needs a contiguous tensor")
    q, scale = quantize_rows(x.reshape(math.prod(x.shape[:lead]), -1))
    if axes is None:
        return q.reshape(x.shape), scale.reshape(())
    return q.reshape(x.shape), scale.reshape(tuple(x.shape[:lead]) + (1,) * (nd - lead))


def _weight_rows(w: torch.Tensor) -> torch.Tensor:
    """An OIHW conv weight as its OHWI rows, or a dense ``(out, in)`` weight."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1) if w.dim() == 4 else w


def quantize_weight(w: torch.Tensor) -> Quantized:
    """A float weight's int8 rows and per-output-channel scales: an OIHW
    conv weight -> (int8 (O, kh, kw, I) OHWI, float32 (O,)); a dense
    ``(out, in)`` weight -> (int8 (out, in), float32 (out,))."""
    q, scale = quantize_rows(_weight_rows(w).contiguous())
    return (q.reshape(w.shape[0], *w.shape[2:], w.shape[1]) if w.dim() == 4 else q), scale


def quantize_weight_plain(w: torch.Tensor) -> Quantized:
    """The plain version of :func:`quantize_weight`."""
    q, scale = quantize_rows_plain(_weight_rows(w))
    return (q.reshape(w.shape[0], *w.shape[2:], w.shape[1]) if w.dim() == 4 else q), scale


# -- the integer products ------------------------------------------------------

def _epilogue(acc: torch.Tensor, rescale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    if out_dtype == torch.int32:
        return acc
    return (acc.to(torch.float32) * rescale).to(out_dtype)


def _exact_conv():
    """cuDNN may pick an FFT or Winograd algorithm even in float64; the
    native convolution is im2col and GEMM (or a direct depthwise loop)."""
    return torch.backends.cudnn.flags(enabled=False)


def conv_i8_plain(xq: torch.Tensor, s_x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                  stride: int = 1, groups: int = 1,
                  out_dtype: torch.dtype = torch.bfloat16,
                  pads: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The plain version of :func:`conv_i8`: the int8 convolution in
    float64 (exact), the int32 accumulator, the epilogue."""
    n, h, w, _ = xq.shape
    o, kh, kw, _ = wq.shape
    top, bottom, left, right = conv_pads(h, w, kh, kw, stride, pads)
    x = F.pad(xq.permute(0, 3, 1, 2).to(torch.float64), (left, right, top, bottom))
    with _exact_conv() if xq.device.type == "cuda" else contextlib.nullcontext():
        acc = F.conv2d(x, wq.permute(0, 3, 1, 2).to(torch.float64), stride=stride, groups=groups)
    acc = acc.to(torch.int32)
    rescale = s_x.reshape(n, 1, 1, 1) * s_w.reshape(1, o, 1, 1)
    return _epilogue(acc, rescale, out_dtype).contiguous(memory_format=torch.channels_last)


def check_kernel_args(xq: torch.Tensor, s_x: torch.Tensor, wq: torch.Tensor,
                      s_w: torch.Tensor, groups: int) -> bool:
    """Raise for what the CUDA kernels do not take (checked before any
    launch): groups other than 1 or C == O, operands not int8 with float32
    scales, non-contiguous operands.  Returns whether it is depthwise."""
    c, o = xq.shape[-1], wq.shape[0]
    if groups != 1 and not groups == c == o:
        raise ValueError(f"conv_i8: the CUDA kernels take groups 1 or groups == C == O, "
                         f"not {groups} groups of {c} -> {o}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"conv_i8: int8 operands expected, not {xq.dtype} and {wq.dtype}")
    if s_x.dtype != torch.float32 or s_w.dtype != torch.float32:
        raise TypeError("conv_i8: float32 scales expected")
    if not all(t.is_contiguous() for t in (xq, wq, s_x, s_w)):
        raise ValueError("conv_i8: the CUDA kernels need contiguous operands")
    return groups > 1


def int8_conv_route(c: int, kh: int, kw: int, stride: int, x_ptr: int, w_ptr: int,
                    pads: Optional[Sequence[int]] = None) -> str:
    """The route of ``csrc/int8_conv.cu`` for a groups-1 convolution of C
    input channels (a dense layer: C inputs, 1 x 1, stride 1), from the
    shape, the pads and the operands' bases alone: "gemm" where the
    activation is a plain row-major [M, K = C] int8 matrix that a TMA
    tensor map can describe (1 x 1, stride 1, no pads, K a multiple of 16,
    both bases 16-byte aligned), else "gather"."""
    plain = kh == kw == 1 and stride == 1 and not any(pads or ())
    return "gemm" if plain and c % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0 else "gather"


class ConvPlan(NamedTuple):
    """How ``csrc/int8_conv.cu`` runs one groups-1 convolution or dense layer."""

    route: str  #: "gemm" (A by TMA) or "gather" (A gathered by a producer warpgroup)
    tile_n: int  #: output channels a tile: wgmma's n, 32, 64 or 128
    #: gather: bytes a copy, 16 (and B by TMA), 8, 4 or 1 (byte loads)
    chunk: int
    #: gather at chunk 1: each kernel row's run staged as aligned words and
    #: repacked (``kGatherRows``, the C = 3 stems) instead of byte loads
    staged: bool


#: the gather route's k-stage and a staged tile row's slot, in bytes
#: (``kBK`` and ``kRowSlot`` in ``csrc/int8_conv.cu``)
GATHER_STAGE_BYTES = 128
GATHER_ROW_SLOT = 164


def int8_conv_plan(c: int, o: int, kh: int, kw: int, stride: int, x_ptr: int,
                   w_ptr: int, pads: Optional[Sequence[int]] = None) -> ConvPlan:
    """The plan of one groups-1 convolution of C -> O channels (a dense
    layer: 1 x 1, stride 1), from the shape and the operands' bases alone:
    :func:`int8_conv_route`'s route; the narrowest of 32, 64 and 128 output
    channels that holds O (128 above it), so a narrow layer fills its
    tiles; the widest copy of 16, 8, 4 or 1 bytes that divides C and both
    bases' alignment (each copy then stays inside one tap); and, at 1 byte,
    staged runs where the kh runs of kw * C bytes, each rounded up to 4,
    fit one stage, their aligned words fit a row's slot and O fits one
    tile (``rows_fit`` in the kernel).  ``pads`` (top, bottom, left,
    right; None: SAME) only bar the GEMM route."""
    route = int8_conv_route(c, kh, kw, stride, x_ptr, w_ptr, pads)
    tile_n = next((t for t in (32, 64) if o <= t), 128)
    chunk = next(v for v in (16, 8, 4, 1) if c % v == 0 and x_ptr % v == 0 and w_ptr % v == 0)
    staged = (chunk == 1 and kh * -(-kw * c // 4) * 4 <= GATHER_STAGE_BYTES and o <= tile_n
              and kh * ((kw * c + 6) // 4) * 4 <= GATHER_ROW_SLOT)
    return ConvPlan(route, tile_n, chunk, staged)


class DwconvPlan(NamedTuple):
    """How ``csrc/int8_dwconv.cu`` runs one depthwise convolution: a
    block's item is ``tile_c`` channels of ``rows`` x ``tile_w`` output
    pixels of one image, whose input box of ``in_rows`` x ``in_cols``
    pixels (halo included) it stages in shared memory."""

    chunk: int  #: 16: the box by TMA; 8, 4 or 1: copies of that many bytes
    tile_c: int
    rows: int
    tile_w: int
    in_rows: int
    in_cols: int


def dwconv_weight_bytes(c: int, kh: int, kw: int, tile_c: int) -> int:
    """Shared memory of a depthwise block's weights (words of 4 taps) and
    scales, every channel tile's, and of the weights as they come."""
    return (kh * -(-kw // 4) + 1) * -(-c // tile_c) * tile_c * 4 + -(-c * kh * kw // 16) * 16


def int8_dwconv_plan(n: int, h: int, w: int, c: int, kh: int, kw: int, stride: int,
                     x_align: int, sms: int, pads: Optional[Sequence[int]] = None) -> DwconvPlan:
    """The plan of one depthwise convolution from its shape, the activation
    base's alignment (``x_ptr % 16``) and the card's SM count alone; the
    batch ``n`` counts rounded up to a power of two, so a shape is searched
    at most eight times over micro-batches of up to 128 frames.  The
    box comes by TMA where C % 16 == 0 and the base is 16-byte aligned,
    else by the widest copy of 8, 4 or 1 bytes dividing C and the
    alignment.  Channels (a multiple of 16 up to 128), output rows and
    output columns (a multiple of DWCONV_PIX, or the whole row) of an item:
    the triple that costs least, within DWCONV_SMEM_BYTES a block and
    DWCONV_BOX_MAX a box side.  The cost multiplies the halo (input pixels
    a box stages over those its outputs need alone, square-rooted: the
    neighbours' reads of a halo mostly hit L2), the threads idle in an
    item's last pass (square-rooted), the rows and columns of a last band
    past the image, the channels of a last tile past C, the blocks idle in
    the last wave (two blocks an SM), and, where a tile holds fewer than
    all C channels, 64 / tile_c for tiles under 64 (short strided runs
    waste DRAM sectors and TMA requests).  ``tools/torch_dwconv_plan_ab.py``
    times it against a fixed rule and against the search without the
    last-wave term.  ``pads`` (top, bottom, left, right; None: SAME) set
    the output size."""
    return _dwconv_plan(1 << max(n - 1, 0).bit_length(), h, w, c, kh, kw, stride, x_align, sms,
                        conv_pads(h, w, kh, kw, stride, pads))


@functools.lru_cache(maxsize=4096)
def _dwconv_plan(n: int, h: int, w: int, c: int, kh: int, kw: int, stride: int, x_align: int,
                 sms: int, pads: Pads) -> DwconvPlan:
    ho, wo = conv_out(h, w, kh, kw, stride, pads)
    chunk = 16 if c % 16 == 0 and x_align == 0 else next(
        v for v in (8, 4, 1) if c % v == 0 and x_align % v == 0)
    pix = DWCONV_PIX
    widths = sorted({wo} | set(range(pix, wo, pix)), reverse=True)
    best = None
    for tile_c in range(16, min(128, -(-c // 16) * 16) + 1, 16):  # wider only adds waste
        strided = max(1.0, 64 / tile_c) if tile_c < c else 1.0
        c_tiles = -(-c // tile_c)
        chans = c_tiles * tile_c / c * strided
        boxes = DWCONV_SMEM_BYTES - 256 - dwconv_weight_bytes(c, kh, kw, tile_c)
        for tile_w in widths:
            pws = -(-tile_w // pix)
            in_cols = (pws * pix - 1) * stride + kw
            if in_cols > DWCONV_BOX_MAX:
                continue
            w_tiles = -(-wo // tile_w)
            cols = w_tiles * tile_w / wo * (in_cols / (tile_w * stride)) ** 0.5
            for rows in range(1, ho + 1):
                in_rows = (rows - 1) * stride + kh
                if in_rows > DWCONV_BOX_MAX or 2 * in_rows * in_cols * tile_c > boxes:
                    break
                units = rows * pws * tile_c // 16
                waves = c_tiles * n * -(-ho // rows) * w_tiles / (2 * sms)
                cost = (chans * cols * -(-ho // rows) * rows / ho
                        * (in_rows / (rows * stride)) ** 0.5
                        * (-(-units // DWCONV_THREADS) * DWCONV_THREADS / units) ** 0.5
                        * math.ceil(waves) / waves)
                key = (round(cost, 9), -rows * tile_w * tile_c)
                if best is None or key < best[0]:
                    best = (key, DwconvPlan(chunk, tile_c, rows, tile_w, in_rows, in_cols))
    if best is None:
        raise ValueError(f"int8_dwconv: no box of a {kh}x{kw} kernel at stride {stride} over "
                         f"{c} channels fits {DWCONV_SMEM_BYTES} bytes of shared memory")
    return best[1]


def conv_i8(xq: torch.Tensor, s_x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
            stride: int = 1, groups: int = 1,
            out_dtype: torch.dtype = torch.bfloat16,
            pads: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The int8 convolution of quantized operands: ``xq`` (N, H, W, C) int8
    with per-sample scales ``s_x`` (N,), ``wq`` (O, kh, kw, C / groups) OHWI
    int8 with per-channel scales ``s_w`` (O,), zero padding of ``pads``
    (top, bottom, left, right; None: SAME; VALID is 0s).  Returns (N, O,
    Ho, Wo) ``channels_last`` in ``out_dtype`` (``torch.int32``: the raw
    accumulator, no epilogue).  CUDA: ``groups`` 1 through
    ``int8_conv.cu`` by :func:`int8_conv_plan`, ``groups == C == O``
    through ``int8_dwconv.cu`` by :func:`int8_dwconv_plan`."""
    global CONV_LAUNCHES, CONV_GEMM_LAUNCHES, CONV_GATHER_LAUNCHES, DWCONV_LAUNCHES
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"conv_i8 outputs float32/float16/bfloat16/int32, not {out_dtype}")
    n, h, w, c = xq.shape
    o, kh, kw, cg = wq.shape
    if cg * groups != c or o % groups:
        raise ValueError(f"conv_i8: weight {tuple(wq.shape)} does not fit {c} channels "
                         f"in {groups} groups")
    pads = conv_pads(h, w, kh, kw, stride, pads)
    if xq.device.type == "cpu":
        return conv_i8_plain(xq, s_x, wq, s_w, stride, groups, out_dtype, pads)
    depthwise = check_kernel_args(xq, s_x, wq, s_w, groups)
    _check_cuda(xq, "conv_i8")
    ho, wo = conv_out(h, w, kh, kw, stride, pads)
    out = torch.empty((n, o, ho, wo), dtype=out_dtype, device=xq.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    if depthwise:
        plan = int8_dwconv_plan(n, h, w, c, kh, kw, stride, xq.data_ptr() % 16,
                                _sms(xq.device), pads)
        route, name, extra = "depthwise", "int8_dwconv", plan[:4]
    else:
        plan = int8_conv_plan(c, o, kh, kw, stride, xq.data_ptr(), wq.data_ptr(), pads)
        route, name, extra = plan.route, "int8_conv", (plan.tile_n, plan.chunk, plan.staged)
    lib = _build.load(name, _DWCONV_SIGNATURES if depthwise else _CONV_SIGNATURES)
    operands = (xq.data_ptr(), s_x.data_ptr(), wq.data_ptr(), s_w.data_ptr(), out.data_ptr(),
                _OUT_CODES[out_dtype])
    with torch.cuda.device(xq.device):
        if route == "gemm":
            err = lib.nns_int8_gemm(*operands, n * h * w, o, c, h * w, plan.tile_n, _stream(xq))
        else:
            err = getattr(lib, f"nns_{name}")(
                *operands, n, h, w, c, o, kh, kw, stride, ho, wo, pads[0], pads[2], *extra,
                _stream(xq))
    _build.check(lib, err, f"{name} ({route}, {plan})")
    if depthwise:
        DWCONV_LAUNCHES += 1
    else:
        CONV_LAUNCHES += 1
        if route == "gemm":
            CONV_GEMM_LAUNCHES += 1
        else:
            CONV_GATHER_LAUNCHES += 1
    return out


def dense_i8_plain(xq: torch.Tensor, s_x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of :func:`dense_i8`: the product in float64 (exact)."""
    acc = torch.matmul(xq.to(torch.float64), wq.to(torch.float64).T).to(torch.int32)
    return _epilogue(acc, s_x[:, None] * s_w[None, :], out_dtype)


def dense_i8(xq: torch.Tensor, s_x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``xq`` (M, K) int8 with row scales (M,) times ``wq`` (N, K) int8 with
    row scales (N,), transposed: (M, N) in ``out_dtype`` (``torch.int32``:
    the raw accumulator).  On CUDA, ``int8_conv.cu`` with H = W = 1 (a
    1 x 1 convolution: the GEMM route where :func:`int8_conv_route` allows)."""
    m, k = xq.shape
    if xq.device.type == "cpu":
        if out_dtype not in _OUT_CODES:
            raise TypeError(f"dense_i8 outputs float32/float16/bfloat16/int32, not {out_dtype}")
        return dense_i8_plain(xq, s_x, wq, s_w, out_dtype)
    out = conv_i8(xq.reshape(m, 1, 1, k), s_x, wq.reshape(wq.shape[0], 1, 1, k), s_w,
                  out_dtype=out_dtype)
    return out.reshape(m, wq.shape[0])


# -- the reference's entry points ---------------------------------------------

def _quantize_samples(x: torch.Tensor, plain: bool) -> Quantized:
    """Per-sample int8 of NCHW ``x`` held channels_last: (int8 (N, H, W, C), (N,))."""
    nhwc = x.permute(0, 2, 3, 1)
    if not plain and not nhwc.is_contiguous():
        raise ValueError("int8_conv: the CUDA kernels need a channels_last activation")
    q, scale = (quantize_rows_plain if plain else quantize_rows)(nhwc.reshape(x.shape[0], -1))
    return q.reshape(nhwc.shape), scale


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, groups: int = 1,
              out_dtype: torch.dtype = torch.bfloat16,
              qweight: Optional[Quantized] = None) -> torch.Tensor:
    """NCHW ``x`` (channels_last on CUDA) convolved with the OIHW float
    ``weight``, int8 x int8 -> int32, SAME padding, rescaled to
    ``out_dtype``; ``qweight`` is :func:`quantize_weight` of ``weight``
    where the caller holds it.  Output (N, O, Ho, Wo) channels_last."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, weight, stride, groups, out_dtype, qweight)
    xq, s_x = _quantize_samples(x, plain=False)
    wq, s_w = qweight if qweight is not None else quantize_weight(weight)
    return conv_i8(xq, s_x, wq, s_w, stride, groups, out_dtype)


def int8_conv_plain(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, groups: int = 1,
                    out_dtype: torch.dtype = torch.bfloat16,
                    qweight: Optional[Quantized] = None) -> torch.Tensor:
    """The plain version of :func:`int8_conv`."""
    xq, s_x = _quantize_samples(x, plain=True)
    wq, s_w = qweight if qweight is not None else quantize_weight_plain(weight)
    return conv_i8_plain(xq, s_x, wq, s_w, stride, groups, out_dtype)


def int8_dense(x: torch.Tensor, weight: torch.Tensor, out_dtype: torch.dtype = torch.float32,
               qweight: Optional[Quantized] = None) -> torch.Tensor:
    """``x (..., in) @ weight.T`` for an ``(out, in)`` float weight, int8 x
    int8 -> int32, one scale per row of ``x``; (..., out) in ``out_dtype``."""
    if x.device.type == "cpu":
        return int8_dense_plain(x, weight, out_dtype, qweight)
    xq, s_x = quantize_rows(x.reshape(-1, x.shape[-1]))
    wq, s_w = qweight if qweight is not None else quantize_weight(weight)
    return dense_i8(xq, s_x, wq, s_w, out_dtype).reshape(*x.shape[:-1], weight.shape[0])


def int8_dense_plain(x: torch.Tensor, weight: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32,
                     qweight: Optional[Quantized] = None) -> torch.Tensor:
    """The plain version of :func:`int8_dense`."""
    xq, s_x = quantize_rows_plain(x.reshape(-1, x.shape[-1]))
    wq, s_w = qweight if qweight is not None else quantize_weight_plain(weight)
    return dense_i8_plain(xq, s_x, wq, s_w, out_dtype).reshape(*x.shape[:-1], weight.shape[0])
