"""Lower a parsed TFLite graph to a function of torch tensors.

Port of ``nnstreamer_tpu/importers/tflite_lower.py``.  One pass over the
graph at load time checks every op and dequantizes the constants; a call
replays the ops in order on torch tensors of one device (NHWC activations,
as the file lays them out; the convolutions permute to NCHW views, which
are ``channels_last`` tensors for cuDNN, and back).

Quantized models (uint8/int8 per the TFLite quantization spec) run in
fake-quant simulation by default: constants dequantized at load (per
channel where ``quantized_dimension`` says so), activations in float32,
and every tensor with quantization parameters rounded through its integer
grid at op boundaries.  Graph inputs and outputs keep their declared
integer dtypes.

``int8_compute=True`` runs quantized ``CONV_2D``, ``DEPTHWISE_CONV_2D`` and
``FULLY_CONNECTED`` as integer arithmetic on the port's int8 kernels
(``ops/quantize.py``: ``int8_conv``, ``int8_dwconv``, the GEMM route for
dense layers), with the zero-point expansion of the reference:

    s_in*s_w * [ sum (q_x - zp_in')(q_w - zp_w') over the window ]
  = s_in*s_w * [ conv(x8, w8) - zp_w' * patchsum(x8)
                 - zp_in' * sum(w8) + K * zp_in' * zp_w' ]

with ``x8``/``w8`` the int8-shifted values (uint8 shifts by 128) and primed
zero points shifted alike.  The reference pads ``x8`` with ``zp_in'``
and runs VALID; the kernels here fill their padding with 0 instead (no
padded copy of the activation), which drops the padded taps from the first
two sums.  A padded tap adds nothing to the left-hand side, so the
constant terms count only the taps inside the image: ``sum(w8)`` and ``K``
over the valid taps of each output position, a per-layer int32 constant
computed at load.  The int32 accumulators are the reference's, exactly.
The patch sums run on the same kernels with weights of ones (groups 1 with
a kernel larger than 1 x 1, and depthwise), or as an int32 channel sum
(1 x 1 and dense).  The input quantization is the file's static per-tensor
scale, in torch elementwise ops, and the epilogue keeps the reference's
float32 order: ``acc * (s_in * s_w)``, the bias, the activation.

Shape-producing ops (``SHAPE``, ``BROADCAST_ARGS``) fold to numpy
constants from the tensors' shapes, never from their values, so nothing
comes back from the card per call.  :attr:`_Lowering.fold` runs a
micro-batch of N frames folded into the file's leading dimension: the
shape arguments of ``RESHAPE``, ``STRIDED_SLICE``, ``SLICE``, ``BROADCAST_TO``
and ``TRANSPOSE_CONV`` are rewritten for it, and an op that would mix
frames along axis 0 raises :class:`Unfoldable` (the caller then runs frame
by frame; ``backends/_importer_common.py``).  Unsupported ops raise
:class:`TFLiteLowerError` at load.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _oplib
from ..ops import quantize as q8
from .tflite_reader import QuantParams, TFLiteModel, TFLOp, TFLTensor


class TFLiteLowerError(NotImplementedError):
    pass


class Unfoldable(Exception):
    """An op would mix the frames of a folded micro-batch along axis 0."""


# integer limits for fake-quant clipping
_QLIMITS = {
    "uint8": (0, 255),
    "int8": (-128, 127),
    "int16": (-32768, 32767),
    "int32": (-2**31, 2**31 - 1),
    "int64": (-2**63, 2**63 - 1),
    "uint32": (0, 2**32 - 1),
}

#: the torch dtype of each file dtype name (both importers')
TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16, "float64": torch.float64,
    "bfloat16": torch.bfloat16, "int32": torch.int32, "int64": torch.int64,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return TORCH_DTYPES[name]
    except KeyError:
        raise TFLiteLowerError(f"dtype {name} has no torch counterpart here") from None


def _dequantize_const(t: TFLTensor) -> np.ndarray:
    """Constant tensor -> compute-domain numpy: quantized weights and biases
    dequantize to float32 (per channel where the file says so); float16
    widens; other integer constants keep their dtype."""
    data = np.asarray(t.data)
    q = t.quant
    if q is None or t.dtype not in _QLIMITS:
        return data.astype(np.float32) if t.dtype == "float16" else data
    scale, zp = q.scale, q.zero_point.astype(np.float32)
    if q.per_channel:
        shape = [1] * data.ndim
        shape[q.quantized_dimension] = scale.size
        scale = scale.reshape(shape)
        zp = zp.reshape(shape)
    else:
        scale = scale[0]
        zp = zp[0]
    return (data.astype(np.float32) - zp) * scale


def _fake_quant(x, q: QuantParams, dtype: str):
    """Round-trip x through the tensor's integer grid."""
    lo, hi = _QLIMITS[dtype]
    scale = float(q.scale[0])
    zp = float(q.zero_point[0])
    qx = torch.clamp(torch.round(x / scale + zp), lo, hi)
    return (qx - zp) * scale


def _quantize_out(x, q: QuantParams, dtype: str):
    lo, hi = _QLIMITS[dtype]
    scale = float(q.scale[0])
    zp = float(q.zero_point[0])
    return torch.clamp(torch.round(x / scale + zp), lo, hi).to(torch_dtype(dtype))


def _dequantize_in(x, q: QuantParams):
    return (x.to(torch.float32) - float(q.zero_point[0])) * float(q.scale[0])


def _activate(x, name: Optional[str]):
    if name is None:
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if name == "relu_n1_to_1":
        return torch.clamp(x, -1.0, 1.0)
    if name == "tanh":
        return torch.tanh(x)
    raise TFLiteLowerError(f"fused activation {name!r} not supported")


def _same_pads(in_size: int, stride: int, kernel: int, dilation: int = 1) -> Tuple[int, int]:
    """TFLite/TF SAME padding (before, after) of one spatial dim."""
    eff_k = (kernel - 1) * dilation + 1
    out = -(-in_size // stride)
    total = max(0, (out - 1) * stride + eff_k - in_size)
    return total // 2, total - total // 2


def _conv_padding(opts, x_shape, k_h, k_w):
    """((top, bottom), (left, right)) of an NHWC op's options."""
    if opts["padding"] == "VALID":
        return [(0, 0), (0, 0)]
    return [
        _same_pads(x_shape[1], opts["stride_h"], k_h, opts.get("dilation_h", 1)),
        _same_pads(x_shape[2], opts["stride_w"], k_w, opts.get("dilation_w", 1)),
    ]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _padded_nchw(x, pads, value: float = 0.0):
    """NHWC ``x`` as NCHW with ((top, bottom), (left, right)) pads: the
    convolution's own symmetric padding where it can take them, else a
    padded copy.  Returns (tensor, conv padding)."""
    (t, b), (l, r) = pads
    x = _nchw(x)
    if t == b and l == r and value == 0.0:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def _resize_coords(out_size: int, in_size: int, align_corners: bool, half_pixel: bool,
                   device):
    """Source sampling coordinates of one spatial dim (TFLite's three
    conventions)."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners and out_size > 1:
        return i * ((in_size - 1) / (out_size - 1))
    scale = in_size / out_size
    if half_pixel:
        return torch.clamp_min((i + 0.5) * scale - 0.5, 0.0)
    return i * scale


def _resize_bilinear(x, out_h: int, out_w: int, align_corners: bool, half_pixel: bool):
    n, h, w, c = x.shape
    ys = _resize_coords(out_h, h, align_corners, half_pixel, x.device)
    xs = _resize_coords(out_w, w, align_corners, half_pixel, x.device)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0.to(torch.float32))[None, :, None, None]
    wx = (xs - x0.to(torch.float32))[None, None, :, None]
    top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
    bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def _resize_nearest(x, out_h: int, out_w: int, align_corners: bool, half_pixel: bool):
    n, h, w, c = x.shape
    ys = _resize_coords(out_h, h, align_corners, half_pixel, x.device)
    xs = _resize_coords(out_w, w, align_corners, half_pixel, x.device)
    # round half to even for half_pixel/align_corners, floor otherwise
    r = torch.round if (half_pixel or align_corners) else torch.floor
    yi = torch.clamp(r(ys).long(), 0, h - 1)
    xi = torch.clamp(r(xs).long(), 0, w - 1)
    return x[:, yi][:, :, xi]


def _pool(x, opts, kind: str):
    (t, b), (l, r) = _conv_padding(opts, x.shape, opts["filter_h"], opts["filter_w"])
    k = (opts["filter_h"], opts["filter_w"])
    s = (opts["stride_h"], opts["stride_w"])
    xn = _nchw(x)
    if kind == "max":
        out = F.max_pool2d(F.pad(xn, (l, r, t, b), value=-math.inf), k, s)
    else:
        # divide by the true (edge-clipped) window size, as TFLite does
        summed = F.avg_pool2d(F.pad(xn, (l, r, t, b)), k, s, divisor_override=1)
        ones = F.pad(torch.ones_like(xn[:1, :1]), (l, r, t, b))
        out = summed / F.avg_pool2d(ones, k, s, divisor_override=1)
    return _activate(_nhwc(out), opts.get("activation"))


class _Int8Layer:
    """What the int8 route of one quantized conv, depthwise or dense op
    holds from the file: the int8 weights in the kernels' layout (OHWI;
    depthwise (C, kh, kw, 1); dense (O, I)), the shifted zero points, the
    scales, the weight sums and the constant terms per input size."""

    def __init__(self, L: "_Lowering", op: TFLOp):
        t_in, t_w, _ = _int8_quant_triple(L, op)
        self.kind = op.opcode
        self.s_in = float(t_in.quant.scale[0])
        self.zp_in = int(t_in.quant.zero_point[0])
        self.shift_in = 128 if t_in.dtype == "uint8" else 0
        self.zp_in_p = self.zp_in - self.shift_in
        if t_w.quant.per_channel:
            w = np.asarray(t_w.data).astype(np.int8, copy=False)
            self.zp_w_p = 0
            self.s_w = t_w.quant.scale.astype(np.float32)
        else:
            w, shift_w = _to_i8(np.asarray(t_w.data), t_w.dtype)
            self.zp_w_p = int(t_w.quant.zero_point[0]) - shift_w
            self.s_w = float(t_w.quant.scale[0])
        if self.kind == "DEPTHWISE_CONV_2D":
            w = np.ascontiguousarray(np.transpose(w, (3, 1, 2, 0)))  # (C*m, kh, kw, 1)
        self.w_i8 = np.array(w)  # writable: a torch buffer is made of it
        o = op.options
        if self.kind != "FULLY_CONNECTED":
            self.kh, self.kw = w.shape[1], w.shape[2]
            self.stride = (o["stride_h"], o["stride_w"])
            if o.get("dilation_h", 1) != 1 or o.get("dilation_w", 1) != 1:
                raise TFLiteLowerError(
                    f"{op.opcode} with dilation {o.get('dilation_h', 1)}x"
                    f"{o.get('dilation_w', 1)} on the int8 route: the int8 kernels take no "
                    "dilation (ROADMAP A14)")
            if self.stride[0] != self.stride[1]:
                raise TFLiteLowerError(
                    f"{op.opcode} with strides {self.stride} on the int8 route: the int8 "
                    "kernels take one stride (ROADMAP A14)")
        # sum of the int8 weights per output channel and tap: (O, kh, kw)
        self.tap_sums = w.astype(np.int64).sum(axis=-1) if w.ndim == 4 else None
        self.sum_w = w.astype(np.int64).reshape(w.shape[0], -1).sum(axis=1)
        self._consts: Dict[Tuple[int, int, Any], torch.Tensor] = {}

    def const_term(self, h: int, w: int, pads, cg: int, device) -> torch.Tensor:
        """``-zp_in' * sum(w8) + K * zp_in' * zp_w'`` over each output
        position's valid taps, int32: (O,) where no tap leaves the image,
        else (Ho, Wo, O).  Cached per input size and device, except while
        ``torch.export`` traces (the program keeps its own constant)."""
        key = (h, w, tuple(pads), device)
        traced = _oplib.tracing()
        got = None if traced else self._consts.get(key)
        if got is not None:
            return got
        if self.tap_sums is None or not any(p for pair in pads for p in pair):
            k = self.w_i8[0].size
            term = -self.zp_in_p * self.sum_w + k * self.zp_in_p * self.zp_w_p
        else:
            (t, b), (l, r) = pads
            s = self.stride[0]
            ho = (h + t + b - self.kh) // s + 1
            wo = (w + l + r - self.kw) // s + 1
            iy = np.arange(ho)[None, :] * s - t + np.arange(self.kh)[:, None]
            ix = np.arange(wo)[None, :] * s - l + np.arange(self.kw)[:, None]
            my = ((iy >= 0) & (iy < h)).astype(np.int64)   # (kh, Ho)
            mx = ((ix >= 0) & (ix < w)).astype(np.int64)   # (kw, Wo)
            w_valid = np.einsum("ay,bx,oab->yxo", my, mx, self.tap_sums)
            cnt = np.einsum("ay,bx->yx", my, mx)[:, :, None] * cg
            term = -self.zp_in_p * w_valid + cnt * self.zp_in_p * self.zp_w_p
        got = torch.from_numpy(term.astype(np.int32)).to(device)
        if not traced:
            self._consts[key] = got
        return got


class _Lowering:
    """The graph's constants and ops; :meth:`run` replays the ops on torch
    tensors."""

    def __init__(self, model: TFLiteModel, fake_quant: bool = True,
                 int8_compute: bool = False):
        self.m = model
        self.fake_quant = fake_quant
        self.int8_compute = int8_compute
        #: shape constants folded from tensor shapes (SHAPE, BROADCAST_ARGS)
        self.static: Dict[int, np.ndarray] = {}
        #: frames folded into the leading dimension of this call, and the
        #: tensors that carry them (see the module docstring)
        self.fold = 1
        self.folding = False
        self.batched: set = set()
        #: float32 views of the constants, dequantized once at load
        self.consts: Dict[int, np.ndarray] = {}
        #: constants read as integers (shape, axis and pad arguments)
        self.raw_consts: Dict[int, np.ndarray] = {}
        for t in model.tensors:
            if t.is_const:
                self.raw_consts[t.index] = np.asarray(t.data)
                # writable: torch tensors are made of them
                self.consts[t.index] = np.array(_dequantize_const(t))
        unsupported = sorted({
            op.opcode for op in model.ops if op.opcode.split(":")[0] not in _OP_IMPLS})
        if unsupported:
            raise TFLiteLowerError(
                f"unsupported tflite ops: {', '.join(unsupported)} "
                f"(supported: {', '.join(sorted(_OP_IMPLS))})")
        #: the int8 route's layers, by op index
        self.int8_layers: Dict[int, _Int8Layer] = {}
        for i, op in enumerate(model.ops):
            if op.opcode in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED") and \
                    _int8_quant_triple(self, op)[2]:
                self.int8_layers[i] = _Int8Layer(self, op)
        #: the kernels' plain versions on any device (the card's bit-equal
        #: comparison); a CPU tensor takes them anyway
        self.plain = False
        self._op_index: Dict[int, int] = {id(op): i for i, op in enumerate(model.ops)}
        self.device = torch.device("cpu")

    def _int8_weight_indices(self) -> set:
        """Weights the int8 route reads as int8: their float copies stay
        out of :meth:`params`."""
        return {self.m.ops[i].inputs[1] for i in self.int8_layers}

    def params(self) -> Dict[int, np.ndarray]:
        """The constants, to be placed by the caller and passed to
        :meth:`run`; the int8 route's weights are not among them."""
        skip = self._int8_weight_indices()
        return {k: v for k, v in self.consts.items() if k not in skip}

    def int8_params(self) -> Dict[int, np.ndarray]:
        """The int8 route's weights in the kernels' layout, by op index."""
        return {i: layer.w_i8 for i, layer in self.int8_layers.items()}

    def output_keys(self) -> List[int]:
        """The outputs' tensor indices (``batched`` holds them after a
        folded call when they carry the frames)."""
        return list(self.m.outputs)

    def drop_host_consts(self) -> None:
        """Release the host copies of the dequantized constants once the
        caller holds :meth:`params`; ``raw_consts`` (the shape, axis and pad
        arguments) stay."""
        self.consts = {}

    # -- values during a call -------------------------------------------------
    def val(self, env, idx: int):
        """Compute-domain value of tensor ``idx``."""
        if idx < 0:
            return None
        if idx in env:
            return env[idx]
        return self._const(idx)

    def _const(self, idx: int) -> torch.Tensor:
        return torch.as_tensor(self.consts[idx], device=self.device)

    def raw(self, idx: int) -> np.ndarray:
        """Integer-domain constant (shape vectors, pad matrices, axes), from
        the file or folded from a shape (SHAPE, BROADCAST_ARGS)."""
        if idx in self.raw_consts:
            return self.raw_consts[idx]
        if idx in self.static:
            return self.static[idx]
        raise TFLiteLowerError(
            f"tensor {idx} must be a constant (a shape argument read from the card's values "
            "would cost a host copy per call)")

    # -- folded micro-batches -------------------------------------------------
    def set_fold(self, fold) -> None:
        """Fold ``fold`` frames into the leading dimension of this call.  A
        symbolic count (a traced program's batch) always folds: the program
        must hold for every count, so an op that mixes frames refuses."""
        self.fold = fold if isinstance(fold, torch.SymInt) else int(fold)
        self.folding = isinstance(fold, torch.SymInt) or self.fold > 1

    def is_batched(self, idx: int) -> bool:
        return self.folding and idx in self.batched

    def frame_shape(self, x) -> Tuple[int, ...]:
        """The shape one frame of a folded tensor has."""
        return (x.shape[0] // self.fold,) + tuple(x.shape[1:])

    def need(self, ok: bool, op: TFLOp, what: str) -> None:
        if not ok:
            raise Unfoldable(f"{op.opcode}: {what} mixes the frames of a folded micro-batch")

    def out_quant(self, x, idx: int):
        """Quantization boundary of an op output: the full round trip
        through the integer grid, or with ``fake_quant`` off only the range
        clamp (which carries fused ReLU6 in models that encode it in the
        output range)."""
        t = self.m.tensors[idx]
        if t.quant is None or t.dtype not in _QLIMITS or t.quant.per_channel:
            return x
        if self.fake_quant:
            return _fake_quant(x, t.quant, t.dtype)
        lo, hi = _QLIMITS[t.dtype]
        scale = float(t.quant.scale[0])
        zp = float(t.quant.zero_point[0])
        return torch.clamp(x, (lo - zp) * scale, (hi - zp) * scale)

    # -- the call ---------------------------------------------------------------
    def __call__(self, *inputs):
        return self.run(self.consts, *inputs)

    def run(self, consts: Dict[Any, Any], *inputs, int8_weights=None, fold: int = 1):
        """Run the graph.  ``consts`` maps tensor indices to their values
        (tensors placed by the caller, or the numpy constants), and
        ``int8_weights`` op indices to the int8 route's placed weights;
        with ``fold`` N every input holds N frames along its leading
        dimension."""
        m = self.m
        if len(inputs) != len(m.inputs):
            raise ValueError(f"model takes {len(m.inputs)} inputs, got {len(inputs)}")
        inputs = [torch.as_tensor(x) for x in inputs]
        self.device = inputs[0].device if inputs else torch.device("cpu")
        self.set_fold(fold)
        self.batched = set(m.inputs)
        env: Dict[int, Any] = {k: torch.as_tensor(v, device=self.device)
                               for k, v in consts.items()}
        self.int8_weights = int8_weights or {}
        self.static = {}
        for idx, x in zip(m.inputs, inputs):
            t = m.tensors[idx]
            if t.quant is not None and t.dtype in _QLIMITS:
                x = _dequantize_in(x, t.quant)
            elif x.dtype in (torch.uint8, torch.int8) and t.dtype == "float32":
                x = x.to(torch.float32)
            env[idx] = x
        for op in m.ops:
            _OP_IMPLS[op.opcode.split(":")[0]](self, env, op)
            if any(i in self.batched for i in op.inputs):
                self.batched.update(o for o in op.outputs if o not in self.static)
        outs = []
        for idx in m.outputs:
            t = m.tensors[idx]
            x = env[idx]
            if t.quant is not None and t.dtype in _QLIMITS:
                x = _quantize_out(x, t.quant, t.dtype)
            elif t.dtype in ("int32", "int64", "bool"):
                x = x.to(torch_dtype(t.dtype))
            outs.append(x)
        return tuple(outs)


# -- the int8 route ------------------------------------------------------------------

def _int8_quant_triple(L: _Lowering, op: TFLOp):
    """(input tensor, weight tensor, usable) for the int8 route: a per-tensor
    quantized input activation; weights per tensor, or per channel and
    symmetric int8 (zero points 0) along the output channels (dim 3 for
    depthwise, 0 otherwise).  Anything else takes fake-quant."""
    t_in = L.m.tensors[op.inputs[0]]
    t_w = L.m.tensors[op.inputs[1]]
    out_dim = 3 if op.opcode == "DEPTHWISE_CONV_2D" else 0
    w_ok = (
        t_w.quant is not None and t_w.is_const
        and t_w.dtype in ("uint8", "int8")
        and (not t_w.quant.per_channel
             or (t_w.dtype == "int8"
                 and not t_w.quant.zero_point.any()
                 and t_w.quant.quantized_dimension == out_dim))
    )
    ok = (
        L.int8_compute
        and t_in.quant is not None and not t_in.quant.per_channel
        and t_in.dtype in ("uint8", "int8")
        and w_ok
    )
    return t_in, t_w, ok


def _to_i8(q_vals: np.ndarray, dtype: str):
    """Quantized values -> int8 with the matching zero-point shift (uint8
    shifts by 128 so 0..255 fits int8)."""
    if dtype == "uint8":
        return (q_vals.astype(np.int32) - 128).astype(np.int8), 128
    return q_vals.astype(np.int8), 0


def _int8_input(layer: _Int8Layer, x):
    """The float activation on the input's static grid, int8-shifted:
    ``round(x / s_in) + zp_in - shift``, converted with saturation."""
    q = torch.round(x / layer.s_in) + (layer.zp_in - layer.shift_in)
    return torch.clamp(q, -128, 127).to(torch.int8)


def _int8_epilogue(L: _Lowering, env, op: TFLOp, acc, layer: _Int8Layer):
    """Accumulator -> float32 + bias + fused activation; a per-channel
    ``s_w`` broadcasts over the last (channel) axis."""
    if np.ndim(layer.s_w):
        y = acc.to(torch.float32) * torch.as_tensor(layer.s_in * layer.s_w, device=acc.device)
    else:
        y = acc.to(torch.float32) * (layer.s_in * layer.s_w)
    b = L.val(env, op.inputs[2]) if len(op.inputs) > 2 and op.inputs[2] >= 0 else None
    if b is not None:
        y = y + b
    return _activate(y, op.options["activation"])


def _unit_scales(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.float32, device=device)


def _conv_acc(L: _Lowering, xq, w, stride: int, groups: int, pads):
    """int32 accumulator of an int8 convolution, NHWC."""
    s_x = _unit_scales(xq.shape[0], xq.device)
    s_w = _unit_scales(w.shape[0], xq.device)
    fn = q8.conv_i8_plain if L.plain else q8.conv_i8
    return _nhwc(fn(xq, s_x, w, s_w, stride, groups, torch.int32, pads=pads))


def _int8_conv_core(L: _Lowering, env, op: TFLOp, x, depthwise: bool):
    """A quantized convolution as integer arithmetic (module docstring)."""
    i = L._op_index[id(op)]
    layer = L.int8_layers[i]
    w = L.int8_weights.get(i)
    if w is None:
        w = torch.from_numpy(layer.w_i8).to(x.device)
    xq = _int8_input(layer, x).contiguous()
    n, h, wd, c = xq.shape
    (t, b), (l, r) = pads = _conv_padding(op.options, xq.shape, layer.kh, layer.kw)
    flat = (t, b, l, r)
    s = layer.stride[0]
    groups = c if depthwise else 1
    acc = _conv_acc(L, xq, w, s, groups, flat)
    if layer.zp_w_p:
        if depthwise:
            ones = torch.ones((c, layer.kh, layer.kw, 1), dtype=torch.int8, device=x.device)
            psum = _conv_acc(L, xq, ones, s, c, flat)
            if acc.shape[-1] != c:  # depth multiplier: each channel's sums repeat
                psum = psum.repeat_interleave(acc.shape[-1] // c, dim=-1)
        elif layer.kh == layer.kw == 1 and s == 1:
            psum = xq.sum(dim=-1, keepdim=True, dtype=torch.int32)
        else:
            ones = torch.ones((1, layer.kh, layer.kw, c), dtype=torch.int8, device=x.device)
            psum = _conv_acc(L, xq, ones, s, 1, flat)
        acc = acc - layer.zp_w_p * psum
    acc = acc + layer.const_term(h, wd, pads, 1 if depthwise else c, x.device)
    return _int8_epilogue(L, env, op, acc, layer)


# -- op implementations -----------------------------------------------------------------
# Each: (lowering, env, op) -> writes env[op.outputs[...]]

def _op_conv2d(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    if L._op_index[id(op)] in L.int8_layers:
        y = _int8_conv_core(L, env, op, x, depthwise=False)
        env[op.outputs[0]] = L.out_quant(y, op.outputs[0])
        return
    w = L.val(env, op.inputs[1])            # [O, Kh, Kw, I]
    b = L.val(env, op.inputs[2]) if len(op.inputs) > 2 else None
    o = op.options
    xn, pad = _padded_nchw(x, _conv_padding(o, x.shape, w.shape[1], w.shape[2]))
    y = _nhwc(F.conv2d(xn, _nchw(w), stride=(o["stride_h"], o["stride_w"]), padding=pad,
                       dilation=(o["dilation_h"], o["dilation_w"])))
    if b is not None:
        y = y + b
    env[op.outputs[0]] = L.out_quant(_activate(y, o["activation"]), op.outputs[0])


def _op_depthwise(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    if L._op_index[id(op)] in L.int8_layers:
        y = _int8_conv_core(L, env, op, x, depthwise=True)
        env[op.outputs[0]] = L.out_quant(y, op.outputs[0])
        return
    w = L.val(env, op.inputs[1])            # [1, Kh, Kw, I*mult]
    b = L.val(env, op.inputs[2]) if len(op.inputs) > 2 else None
    o = op.options
    in_ch = x.shape[3]
    kh, kw = w.shape[1], w.shape[2]
    xn, pad = _padded_nchw(x, _conv_padding(o, x.shape, kh, kw))
    y = _nhwc(F.conv2d(xn, w.permute(3, 0, 1, 2), stride=(o["stride_h"], o["stride_w"]),
                       padding=pad, dilation=(o["dilation_h"], o["dilation_w"]), groups=in_ch))
    if b is not None:
        y = y + b
    env[op.outputs[0]] = L.out_quant(_activate(y, o["activation"]), op.outputs[0])


def _op_transpose_conv(L: _Lowering, env, op: TFLOp):
    # inputs: [output_shape (const), weights (O, Kh, Kw, I), x, (bias)]
    out_shape = tuple(int(v) for v in L.raw(op.inputs[0]))
    w = L.val(env, op.inputs[1])
    x = L.val(env, op.inputs[2])
    b = L.val(env, op.inputs[3]) if len(op.inputs) > 3 else None
    o = op.options
    sh, sw = o["stride_h"], o["stride_w"]
    kh, kw = w.shape[1], w.shape[2]
    pt = _same_pads(out_shape[1], sh, kh)[0] if o["padding"] == "SAME" else 0
    pl = _same_pads(out_shape[2], sw, kw)[0] if o["padding"] == "SAME" else 0
    # the full transposed convolution, then the window the padding keeps
    y = F.conv_transpose2d(_nchw(x), w.permute(3, 0, 1, 2), stride=(sh, sw))
    y = _nhwc(y[:, :, pt:pt + out_shape[1], pl:pl + out_shape[2]])
    if b is not None:
        y = y + b
    env[op.outputs[0]] = L.out_quant(_activate(y, o.get("activation")), op.outputs[0])


def _op_fully_connected(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    o = op.options
    if o.get("weights_format", 0) != 0:
        raise TFLiteLowerError("FULLY_CONNECTED shuffled-weights format")
    i = L._op_index[id(op)]
    if i in L.int8_layers:
        layer = L.int8_layers[i]
        w = L.int8_weights.get(i)
        if w is None:
            w = torch.from_numpy(layer.w_i8).to(x.device)
        in_features = layer.w_i8.shape[1]
        if not o.get("keep_num_dims", False):
            x = x.reshape(-1, in_features)
        xq = _int8_input(layer, x)
        rows = xq.reshape(-1, in_features).contiguous()
        fn = q8.dense_i8_plain if L.plain else q8.dense_i8
        acc = fn(rows, _unit_scales(rows.shape[0], x.device), w,
                 _unit_scales(w.shape[0], x.device), torch.int32)
        acc = acc.reshape(*xq.shape[:-1], w.shape[0])
        if layer.zp_w_p:
            acc = acc - layer.zp_w_p * xq.sum(dim=-1, keepdim=True, dtype=torch.int32)
        acc = acc + layer.const_term(1, 1, ((0, 0), (0, 0)), in_features, x.device)
        env[op.outputs[0]] = L.out_quant(_int8_epilogue(L, env, op, acc, layer), op.outputs[0])
        return
    w = L.val(env, op.inputs[1])            # [O, I]
    b = L.val(env, op.inputs[2]) if len(op.inputs) > 2 and op.inputs[2] >= 0 else None
    if not o.get("keep_num_dims", False):
        x = x.reshape(-1, w.shape[1])
    y = x @ w.T
    if b is not None:
        y = y + b
    env[op.outputs[0]] = L.out_quant(_activate(y, o["activation"]), op.outputs[0])


def _op_pool_avg(L: _Lowering, env, op: TFLOp):
    env[op.outputs[0]] = L.out_quant(_pool(L.val(env, op.inputs[0]), op.options, "avg"),
                                     op.outputs[0])


def _op_pool_max(L: _Lowering, env, op: TFLOp):
    env[op.outputs[0]] = L.out_quant(_pool(L.val(env, op.inputs[0]), op.options, "max"),
                                     op.outputs[0])


def _check_operands(L: _Lowering, op: TFLOp, xs) -> None:
    """A folded operand broadcasts against a constant one only where the
    constant's leading dim is 1 or it has fewer dims."""
    if not L.folding:
        return
    ranks = [x.dim() for x, i in xs if L.is_batched(i)]
    for x, i in xs:
        if not L.is_batched(i) and ranks and x.dim() >= max(ranks) and x.shape[0] != 1:
            raise Unfoldable(f"{op.opcode}: an operand of leading dim {x.shape[0]} mixes "
                             "the frames of a folded micro-batch")


def _binop(fn):
    def impl(L: _Lowering, env, op: TFLOp):
        a = L.val(env, op.inputs[0])
        b = L.val(env, op.inputs[1])
        _check_operands(L, op, [(a, op.inputs[0]), (b, op.inputs[1])])
        y = _activate(fn(a, b), op.options.get("activation"))
        env[op.outputs[0]] = L.out_quant(y, op.outputs[0])
    return impl


def _unop(fn, quant: bool = True):
    def impl(L: _Lowering, env, op: TFLOp):
        y = fn(L.val(env, op.inputs[0]))
        env[op.outputs[0]] = L.out_quant(y, op.outputs[0]) if quant else y
    return impl


def _resolve(shape: List[int], numel: int) -> List[int]:
    """A reshape target with its -1 resolved."""
    if -1 in shape:
        known = int(np.prod([d for d in shape if d != -1]))
        shape = [numel // known if d == -1 else d for d in shape]
    return shape


def _op_reshape(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    if len(op.inputs) > 1 and op.inputs[1] >= 0:
        shape = [int(v) for v in L.raw(op.inputs[1]).ravel()]
    else:
        shape = list(op.options.get("new_shape") or L.m.tensors[op.outputs[0]].shape)
    if L.is_batched(op.inputs[0]):
        frame = L.frame_shape(x)
        shape = _resolve(shape, int(np.prod(frame)))
        L.need(bool(shape) and shape[0] == frame[0], op, f"reshape {frame} -> {shape}")
        shape = [shape[0] * L.fold] + shape[1:]
    env[op.outputs[0]] = x.reshape(shape)


def _op_softmax(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    if L.is_batched(op.inputs[0]):
        L.need(x.dim() > 1, op, "softmax over axis 0")
    y = torch.softmax(x * op.options.get("beta", 1.0), dim=-1)
    env[op.outputs[0]] = L.out_quant(y, op.outputs[0])


def _axis(axis: int, rank: int) -> int:
    return axis % rank if rank else 0


def _op_concat(L: _Lowering, env, op: TFLOp):
    parts = [L.val(env, i) for i in op.inputs]
    axis = op.options["axis"]
    if L.folding and any(L.is_batched(i) for i in op.inputs):
        L.need(_axis(axis, parts[0].dim()) != 0 and all(L.is_batched(i) for i in op.inputs),
               op, "concatenation along axis 0")
    y = torch.cat(parts, dim=axis)
    env[op.outputs[0]] = L.out_quant(_activate(y, op.options.get("activation")), op.outputs[0])


def _pad_pairs(L: _Lowering, op: TFLOp, x, idx: int):
    pads = L.raw(idx).reshape(-1, 2)
    if L.is_batched(op.inputs[0]):
        L.need(not pads[0].any(), op, "padding axis 0")
    flat = []
    for a, b in reversed([(int(a), int(b)) for a, b in pads]):
        flat += [a, b]
    return flat


def _op_pad(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    value = 0.0
    if len(op.inputs) > 2 and op.inputs[2] >= 0:       # PADV2's constant
        value = float(np.asarray(L.raw(op.inputs[2])).ravel()[0])
    env[op.outputs[0]] = F.pad(x, _pad_pairs(L, op, x, op.inputs[1]), value=value)


def _op_mirror_pad(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    flat = _pad_pairs(L, op, x, op.inputs[1])
    if op.options["mode"] == "reflect":
        # F.pad reflects the last dims only: pad one dim at a time
        y = x
        for d in range(x.dim()):
            lo, hi = flat[2 * (x.dim() - 1 - d)], flat[2 * (x.dim() - 1 - d) + 1]
            if lo or hi:
                idx = torch.arange(-lo, y.shape[d] + hi, device=y.device).abs()
                n = y.shape[d]
                idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
                y = y.index_select(d, idx)
        env[op.outputs[0]] = y
    else:  # symmetric: the edge element repeats
        y = x
        for d in range(x.dim()):
            lo, hi = flat[2 * (x.dim() - 1 - d)], flat[2 * (x.dim() - 1 - d) + 1]
            if lo or hi:
                n = y.shape[d]
                idx = torch.arange(-lo, n + hi, device=y.device)
                idx = torch.where(idx < 0, -idx - 1, idx)
                idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
                y = y.index_select(d, idx)
        env[op.outputs[0]] = y


def _reduce(name: str):
    def impl(L: _Lowering, env, op: TFLOp):
        x = L.val(env, op.inputs[0])
        axes = tuple(sorted({_axis(int(v), x.dim()) for v in L.raw(op.inputs[1]).ravel()}))
        keep = op.options.get("keep_dims", False)
        if L.is_batched(op.inputs[0]):
            L.need(0 not in axes, op, "a reduction over axis 0")
        if not axes:
            y = x
        elif name == "prod":
            y = x
            for a in reversed(axes):
                y = torch.prod(y, dim=a, keepdim=keep)
        else:
            y = {"mean": torch.mean, "sum": torch.sum, "max": torch.amax,
                 "min": torch.amin}[name](x, dim=axes, keepdim=keep)
        env[op.outputs[0]] = L.out_quant(y, op.outputs[0])
    return impl


def _take(x, dim: int, idx: List[int]):
    """``x`` at the indices ``idx`` of ``dim``: a slice where they are a
    positive stride, else a gather."""
    if len(idx) > 1 and all(b - a == idx[1] - idx[0] for a, b in zip(idx, idx[1:])) \
            and idx[1] > idx[0]:
        return x.narrow(dim, idx[0], idx[-1] - idx[0] + 1)[
            (slice(None),) * dim + (slice(None, None, idx[1] - idx[0]),)]
    if len(idx) == 1:
        return x.narrow(dim, idx[0], 1)
    return x.index_select(dim, torch.as_tensor(idx, dtype=torch.long, device=x.device))


def _op_strided_slice(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    begin = L.raw(op.inputs[1]).ravel()
    end = L.raw(op.inputs[2]).ravel()
    strides = L.raw(op.inputs[3]).ravel()
    o = op.options
    if o.get("ellipsis_mask") or o.get("new_axis_mask"):
        raise TFLiteLowerError("STRIDED_SLICE ellipsis/new-axis masks")
    batched = L.is_batched(op.inputs[0])
    y, shrink = x, []
    for d in range(x.dim()):
        if d >= begin.size:
            continue
        size = L.frame_shape(x)[0] if (batched and d == 0) else x.shape[d]
        if (o["shrink_axis_mask"] >> d) & 1:
            L.need(not (batched and d == 0), op, "shrinking axis 0")
            shrink.append(d)
            y = y.narrow(d, int(begin[d]) % size, 1)
            continue
        b = None if (o["begin_mask"] >> d) & 1 else int(begin[d])
        e = None if (o["end_mask"] >> d) & 1 else int(end[d])
        idx = list(range(size))[slice(b, e, int(strides[d]))]
        if batched and d == 0:
            L.need(idx == list(range(size)), op, "slicing axis 0")
            continue
        if idx != list(range(size)):
            y = _take(y, d, idx) if idx else y.narrow(d, 0, 0)
    for d in reversed(shrink):
        y = y.squeeze(d)
    env[op.outputs[0]] = y


def _op_slice(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    begin = [int(v) for v in L.raw(op.inputs[1]).ravel()]
    size = [int(v) for v in L.raw(op.inputs[2]).ravel()]
    shape = L.frame_shape(x) if L.is_batched(op.inputs[0]) else tuple(x.shape)
    size = [shape[d] - begin[d] if s == -1 else s for d, s in enumerate(size)]
    y = x
    for d, (b, s) in enumerate(zip(begin, size)):
        b = min(max(b, 0), shape[d] - s)  # start indices clamp so the slice fits
        if L.is_batched(op.inputs[0]) and d == 0:
            L.need(b == 0 and s == shape[0], op, "slicing axis 0")
            continue
        y = y.narrow(d, b, s)
    env[op.outputs[0]] = y


def _op_transpose(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    perm = [int(v) for v in L.raw(op.inputs[1]).ravel()]
    if L.is_batched(op.inputs[0]):
        L.need(perm[0] == 0, op, "moving axis 0")
    env[op.outputs[0]] = x.permute(perm)


def _op_resize_bilinear(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    out_h, out_w = (int(v) for v in L.raw(op.inputs[1]).ravel())
    y = _resize_bilinear(x, out_h, out_w, op.options["align_corners"],
                         op.options["half_pixel_centers"])
    env[op.outputs[0]] = L.out_quant(y, op.outputs[0])


def _op_resize_nearest(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    out_h, out_w = (int(v) for v in L.raw(op.inputs[1]).ravel())
    y = _resize_nearest(x, out_h, out_w, op.options["align_corners"],
                        op.options["half_pixel_centers"])
    env[op.outputs[0]] = L.out_quant(y, op.outputs[0])


def _op_squeeze(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    shape = L.frame_shape(x) if L.is_batched(op.inputs[0]) else tuple(x.shape)
    dims = op.options.get("squeeze_dims") or [d for d, n in enumerate(shape) if n == 1]
    dims = sorted({_axis(d, x.dim()) for d in dims})
    if L.is_batched(op.inputs[0]):
        L.need(0 not in dims, op, "squeezing axis 0")
    for d in reversed(dims):
        x = x.squeeze(d)
    env[op.outputs[0]] = x


def _op_expand_dims(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    axis = int(L.raw(op.inputs[1]).ravel()[0])
    if L.is_batched(op.inputs[0]):
        L.need(_axis(axis, x.dim() + 1) != 0, op, "a new axis 0")
    env[op.outputs[0]] = x.unsqueeze(axis)


def _op_shape(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    shape = L.frame_shape(x) if L.is_batched(op.inputs[0]) else tuple(x.shape)
    L.static[op.outputs[0]] = np.asarray(shape, np.dtype(op.options.get("out_dtype") or "int32"))
    env[op.outputs[0]] = torch.tensor(shape, dtype=torch.int32, device=L.device)


def _op_broadcast_args(L: _Lowering, env, op: TFLOp):
    a = tuple(int(v) for v in L.raw(op.inputs[0]).ravel())
    b = tuple(int(v) for v in L.raw(op.inputs[1]).ravel())
    shape = np.asarray(np.broadcast_shapes(a, b), np.int32)
    L.static[op.outputs[0]] = shape
    env[op.outputs[0]] = torch.tensor(shape.tolist(), dtype=torch.int32, device=L.device)


def _op_broadcast_to(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    shape = [int(v) for v in L.raw(op.inputs[1]).ravel()]
    if L.is_batched(op.inputs[0]):
        L.need(x.dim() == len(shape) and shape[0] == L.frame_shape(x)[0], op,
               "broadcasting along axis 0")
        shape[0] = x.shape[0]
    env[op.outputs[0]] = x.broadcast_to(shape)


def _op_batch_matmul(L: _Lowering, env, op: TFLOp):
    a = L.val(env, op.inputs[0])
    b = L.val(env, op.inputs[1])
    if L.is_batched(op.inputs[1]):
        L.need(b.dim() > 2, op, "a folded right-hand matrix")
    _check_operands(L, op, [(a, op.inputs[0]), (b, op.inputs[1])] if b.dim() > 2
                    else [(a, op.inputs[0])])
    env[op.outputs[0]] = L.out_quant(torch.matmul(a, b), op.outputs[0])


def _op_cast(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    out_dtype = op.options.get("out_dtype") or L.m.tensors[op.outputs[0]].dtype
    env[op.outputs[0]] = x.to(torch_dtype(out_dtype))


def _arg(fn):
    def impl(L: _Lowering, env, op: TFLOp):
        x = L.val(env, op.inputs[0])
        axis = int(L.raw(op.inputs[1]).ravel()[0])
        if L.is_batched(op.inputs[0]):
            L.need(_axis(axis, x.dim()) != 0, op, "an arg over axis 0")
        env[op.outputs[0]] = fn(x, dim=axis).to(
            torch_dtype(op.options.get("output_type") or "int64"))
    return impl


def _op_gather(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    axis = _axis(op.options.get("axis", 0), x.dim())
    if op.inputs[1] in L.raw_consts:
        idx = torch.as_tensor(L.raw(op.inputs[1]).astype(np.int64), device=x.device)
    else:
        L.need(not L.is_batched(op.inputs[1]), op, "indices that are activations")
        idx = env[op.inputs[1]].long()
    if L.is_batched(op.inputs[0]):
        L.need(axis != 0, op, "gathering along axis 0")
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    y = x.index_select(axis, idx.reshape(-1))
    env[op.outputs[0]] = y.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _op_pack(L: _Lowering, env, op: TFLOp):
    parts = [L.val(env, i) for i in op.inputs]
    axis = op.options.get("axis", 0)
    if any(L.is_batched(i) for i in op.inputs):
        L.need(_axis(axis, parts[0].dim() + 1) != 0 and all(L.is_batched(i) for i in op.inputs),
               op, "packing along axis 0")
    env[op.outputs[0]] = torch.stack(parts, dim=axis)


def _op_unpack(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    axis = op.options.get("axis", 0)
    if L.is_batched(op.inputs[0]):
        L.need(_axis(axis, x.dim()) != 0, op, "unpacking axis 0")
    for j, out_idx in enumerate(op.outputs):
        env[out_idx] = x.select(axis, j)


def _op_split(L: _Lowering, env, op: TFLOp):
    # inputs: [axis (const), x]
    axis = int(L.raw(op.inputs[0]).ravel()[0])
    x = L.val(env, op.inputs[1])
    if L.is_batched(op.inputs[1]):
        L.need(_axis(axis, x.dim()) != 0, op, "splitting axis 0")
    n = len(op.outputs)
    if x.shape[axis] % n:
        raise ValueError(f"SPLIT: {x.shape[axis]} does not split into {n} equal parts")
    for out_idx, part in zip(op.outputs, torch.split(x, x.shape[axis] // n, dim=axis)):
        env[out_idx] = part


def _op_split_v(L: _Lowering, env, op: TFLOp):
    # inputs: [x, size_splits (const), axis (const)]
    x = L.val(env, op.inputs[0])
    sizes = [int(v) for v in L.raw(op.inputs[1]).ravel()]
    axis = int(L.raw(op.inputs[2]).ravel()[0])
    if L.is_batched(op.inputs[0]):
        L.need(_axis(axis, x.dim()) != 0, op, "splitting axis 0")
    bounds = np.cumsum(sizes)[:-1].tolist()
    for out_idx, part in zip(op.outputs, torch.tensor_split(x, bounds, dim=axis)):
        env[out_idx] = part


def _op_tile(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    reps = [int(v) for v in L.raw(op.inputs[1]).ravel()]
    reps = [1] * (x.dim() - len(reps)) + reps
    if L.is_batched(op.inputs[0]):
        L.need(len(reps) == x.dim() and reps[0] == 1, op, "tiling axis 0")
    env[op.outputs[0]] = x.repeat(reps)


def _op_space_to_depth(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    b = op.options["block_size"]
    n, h, w, c = x.shape
    y = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    env[op.outputs[0]] = y.reshape(n, h // b, w // b, c * b * b)


def _op_depth_to_space(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    b = op.options["block_size"]
    n, h, w, c = x.shape
    y = x.reshape(n, h, w, b, b, c // (b * b)).permute(0, 1, 3, 2, 4, 5)
    env[op.outputs[0]] = y.reshape(n, h * b, w * b, c // (b * b))


def _op_l2_norm(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    if L.is_batched(op.inputs[0]):
        L.need(x.dim() > 1, op, "a norm over axis 0")
    y = x / torch.sqrt(torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), 1e-6))
    env[op.outputs[0]] = L.out_quant(_activate(y, op.options.get("activation")), op.outputs[0])


def _op_prelu(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    alpha = L.val(env, op.inputs[1])
    _check_operands(L, op, [(x, op.inputs[0]), (alpha, op.inputs[1])])
    env[op.outputs[0]] = L.out_quant(torch.where(x >= 0, x, x * alpha), op.outputs[0])


def _op_leaky_relu(L: _Lowering, env, op: TFLOp):
    x = L.val(env, op.inputs[0])
    a = op.options.get("alpha", 0.0)
    env[op.outputs[0]] = L.out_quant(torch.where(x >= 0, x, x * a), op.outputs[0])


def _op_dequantize(L: _Lowering, env, op: TFLOp):
    # the value is already float here: pass it through
    env[op.outputs[0]] = L.val(env, op.inputs[0])


def _op_quantize(L: _Lowering, env, op: TFLOp):
    env[op.outputs[0]] = L.out_quant(L.val(env, op.inputs[0]), op.outputs[0])


def _floor_div(a, b):
    return torch.floor(a / b)


_OP_IMPLS: Dict[str, Callable] = {
    "CONV_2D": _op_conv2d,
    "DEPTHWISE_CONV_2D": _op_depthwise,
    "TRANSPOSE_CONV": _op_transpose_conv,
    "FULLY_CONNECTED": _op_fully_connected,
    "AVERAGE_POOL_2D": _op_pool_avg,
    "MAX_POOL_2D": _op_pool_max,
    "ADD": _binop(torch.add),
    "SUB": _binop(torch.sub),
    "MUL": _binop(torch.mul),
    "DIV": _binop(torch.div),
    "MAXIMUM": _binop(torch.maximum),
    "MINIMUM": _binop(torch.minimum),
    "SQUARED_DIFFERENCE": _binop(lambda a, b: (a - b) ** 2),
    "POW": _binop(torch.pow),
    "FLOOR_DIV": _binop(_floor_div),
    "GREATER": _binop(torch.gt),
    "EQUAL": _binop(torch.eq),
    "RELU": _unop(torch.relu),
    "RELU6": _unop(lambda x: torch.clamp(x, 0.0, 6.0)),
    "RELU_N1_TO_1": _unop(lambda x: torch.clamp(x, -1.0, 1.0)),
    "LOGISTIC": _unop(torch.sigmoid),
    "TANH": _unop(torch.tanh),
    "HARD_SWISH": _unop(lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0),
    "EXP": _unop(torch.exp),
    "LOG": _unop(torch.log),
    "SQRT": _unop(torch.sqrt),
    "RSQRT": _unop(lambda x: 1.0 / torch.sqrt(x)),
    "SQUARE": _unop(torch.square),
    "ABS": _unop(torch.abs),
    "NEG": _unop(torch.neg),
    "SIN": _unop(torch.sin),
    "SOFTMAX": _op_softmax,
    "RESHAPE": _op_reshape,
    "CONCATENATION": _op_concat,
    "PAD": _op_pad,
    "MIRROR_PAD": _op_mirror_pad,
    "MEAN": _reduce("mean"),
    "SUM": _reduce("sum"),
    "REDUCE_MAX": _reduce("max"),
    "REDUCE_MIN": _reduce("min"),
    "REDUCE_PROD": _reduce("prod"),
    "STRIDED_SLICE": _op_strided_slice,
    "SLICE": _op_slice,
    "TRANSPOSE": _op_transpose,
    "RESIZE_BILINEAR": _op_resize_bilinear,
    "RESIZE_NEAREST_NEIGHBOR": _op_resize_nearest,
    "SQUEEZE": _op_squeeze,
    "EXPAND_DIMS": _op_expand_dims,
    "SHAPE": _op_shape,
    "BROADCAST_ARGS": _op_broadcast_args,
    "BROADCAST_TO": _op_broadcast_to,
    "BATCH_MATMUL": _op_batch_matmul,
    "CAST": _op_cast,
    "ARG_MAX": _arg(torch.argmax),
    "ARG_MIN": _arg(torch.argmin),
    "GATHER": _op_gather,
    "PACK": _op_pack,
    "UNPACK": _op_unpack,
    "SPLIT": _op_split,
    "SPLIT_V": _op_split_v,
    "TILE": _op_tile,
    "SPACE_TO_DEPTH": _op_space_to_depth,
    "DEPTH_TO_SPACE": _op_depth_to_space,
    "L2_NORMALIZATION": _op_l2_norm,
    "PRELU": _op_prelu,
    "LEAKY_RELU": _op_leaky_relu,
    "DEQUANTIZE": _op_dequantize,
    "QUANTIZE": _op_quantize,
}


def lower_tflite(model: TFLiteModel, fake_quant: bool = True,
                 int8_compute: bool = False) -> Callable:
    """``fn(*inputs) -> tuple(outputs)`` of the graph on torch tensors (the
    device of the inputs).  Inputs and outputs have the model's declared
    dtypes (quantized models take and give uint8/int8)."""
    lowering = _Lowering(model, fake_quant=fake_quant, int8_compute=int8_compute)
    consts = {k: torch.from_numpy(np.array(v)) for k, v in lowering.params().items()}

    def fn(*inputs):
        dev = torch.as_tensor(inputs[0]).device if inputs else torch.device("cpu")
        with torch.inference_mode():
            return lowering.run({k: v.to(dev) for k, v in consts.items()}, *inputs)

    return fn
