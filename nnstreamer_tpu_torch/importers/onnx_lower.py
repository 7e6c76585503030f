"""Lower a parsed ONNX graph to a function of torch tensors.

Port of ``nnstreamer_tpu/importers/onnx_lower.py``, on the same design as
``tflite_lower.py``: a load-time pass checks every op and folds
``Constant`` nodes; a call replays the ops on torch tensors of one device
(NCHW, the layout ONNX uses; convolutions are cuDNN's in the float
graphs, and there is no integer route: ``QuantizeLinear`` and
``DequantizeLinear`` are elementwise boundaries).

Shape-computation chains (``Shape`` -> ``Gather`` -> ``Unsqueeze`` ->
``Concat`` -> ``Reshape``, the pattern torch exports emit, and
``ConstantOfShape``) fold to numpy constants from the tensors' shapes:
an op whose inputs are all known computes in numpy too and stays usable
as a shape or axis argument.  Nothing is read back from the card's
values, so a shape argument that depends on data is refused.  Folded
micro-batches follow ``tflite_lower.py``'s rules (:class:`Unfoldable`).
Unsupported ops raise :class:`OnnxLowerError` at load.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .onnx_reader import ONNX_DTYPES, OnnxModel, OnnxNode
from .tflite_lower import TORCH_DTYPES, Unfoldable, _resize_bilinear, _resize_nearest, _take


class OnnxLowerError(NotImplementedError):
    pass


def _torch_dtype(name: str) -> torch.dtype:
    if name not in TORCH_DTYPES:
        raise OnnxLowerError(f"dtype {name} has no torch counterpart here")
    return TORCH_DTYPES[name]


def _act_pads(pads: Sequence[int], ndim: int) -> List[Tuple[int, int]]:
    """ONNX pads [x1b, x2b, ..., x1e, x2e, ...] -> per-spatial (lo, hi)."""
    half = len(pads) // 2
    return [(int(pads[i]), int(pads[i + half])) for i in range(half)]


def _auto_pad(auto_pad: bytes, in_shape, kernel, strides, dilations):
    """SAME_UPPER / SAME_LOWER / VALID (deprecated, still emitted)."""
    mode = auto_pad.decode() if isinstance(auto_pad, bytes) else auto_pad
    if mode == "VALID":
        return [(0, 0)] * len(in_shape)
    out = []
    for size, k, s, d in zip(in_shape, kernel, strides, dilations):
        eff = (k - 1) * d + 1
        total = max(0, (-(-size // s) - 1) * s + eff - size)
        lo, hi = total // 2, total - total // 2
        if mode == "SAME_LOWER":
            lo, hi = hi, lo
        out.append((lo, hi))
    return out


def _pad_spatial(x, pads, value: float = 0.0):
    """``x`` (N, C, *spatial) padded by per-spatial (lo, hi): the op's own
    symmetric padding where it can take it (returned), else a copy."""
    if all(lo == hi for lo, hi in pads) and value == 0.0:
        return x, tuple(lo for lo, _ in pads)
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value), (0,) * len(pads)


class _Lowering:
    def __init__(self, model: OnnxModel):
        self.m = model
        self.consts: Dict[str, np.ndarray] = {k: np.array(v) for k, v in
                                              model.initializers.items()}
        # Constant nodes are initializers by another name: fold them at load
        for node in model.nodes:
            if node.op_type == "Constant":
                val = node.attrs.get("value")
                if val is None:
                    for k in ("value_float", "value_int"):
                        if k in node.attrs:
                            val = np.asarray(node.attrs[k])
                if val is None:
                    raise OnnxLowerError("Constant node without tensor value")
                self.consts[node.outputs[0]] = np.array(val)
        unsupported = sorted({
            n.op_type for n in model.nodes
            if n.op_type not in _OP_IMPLS and n.op_type != "Constant"})
        if unsupported:
            raise OnnxLowerError(
                f"unsupported onnx ops: {', '.join(unsupported)} "
                f"(supported: {', '.join(sorted(_OP_IMPLS))})")
        #: values known from shapes alone (shape chains); reset per call
        self.static: Dict[str, np.ndarray] = {}
        self.fold = 1
        self.batched: set = set()
        self.device = torch.device("cpu")

    def params(self) -> Dict[str, np.ndarray]:
        return dict(self.consts)

    def output_keys(self) -> List[str]:
        return [vi.name for vi in self.m.outputs]

    def drop_host_consts(self) -> None:
        """Keep only the small constants the ops read as shape and axis
        arguments; the caller's placed copies hold the weights."""
        self.consts = {k: v for k, v in self.consts.items() if v.size <= 256}

    # -- values -----------------------------------------------------------------
    def val(self, env, name: str):
        if not name:
            return None
        if name in env:
            return env[name]
        if name in self.consts:
            return torch.as_tensor(self.consts[name], device=self.device)
        raise OnnxLowerError(f"tensor {name!r} undefined (graph order?)")

    def static_val(self, env, name: str) -> np.ndarray:
        """An integer-domain value known without the card (shape vectors,
        axes, pads)."""
        got = self.maybe_static(env, name)
        if got is None:
            raise OnnxLowerError(
                f"tensor {name!r} must be known from shapes (a shape argument read from the "
                "card's values would cost a host copy per call)")
        return got

    def maybe_static(self, env, name: str) -> Optional[np.ndarray]:
        if name in self.static:
            return self.static[name]
        if name in self.consts:
            return np.asarray(self.consts[name])
        return None

    def set_out(self, env, node: OnnxNode, value, static=None) -> None:
        env[node.outputs[0]] = value
        if static is not None:
            self.static[node.outputs[0]] = np.asarray(static)

    # -- folded micro-batches ---------------------------------------------------
    def is_batched(self, name: str) -> bool:
        return self.fold > 1 and name in self.batched

    def frame_shape(self, x) -> Tuple[int, ...]:
        return (x.shape[0] // self.fold,) + tuple(x.shape[1:])

    def shape_of(self, x, name: str) -> Tuple[int, ...]:
        return self.frame_shape(x) if self.is_batched(name) else tuple(x.shape)

    def need(self, ok: bool, node: OnnxNode, what: str) -> None:
        if not ok:
            raise Unfoldable(f"{node.op_type}: {what} mixes the frames of a folded micro-batch")

    def check_operands(self, node: OnnxNode, names: Sequence[str], xs) -> None:
        """A folded operand broadcasts against a constant one only where the
        constant's leading dim is 1 or it has fewer dims."""
        if self.fold == 1:
            return
        ranks = [x.dim() for x, n in zip(xs, names) if self.is_batched(n)]
        for x, n in zip(xs, names):
            if ranks and not self.is_batched(n) and x.dim() >= max(ranks) and x.shape[0] != 1:
                raise Unfoldable(f"{node.op_type}: an operand of leading dim {x.shape[0]} mixes "
                                 "the frames of a folded micro-batch")

    # -- the call ---------------------------------------------------------------
    def __call__(self, *inputs):
        return self.run(self.consts, *inputs)

    def run(self, consts: Dict[str, Any], *inputs, int8_weights=None, fold: int = 1):
        m = self.m
        if len(inputs) != len(m.inputs):
            raise ValueError(f"model takes {len(m.inputs)} inputs, got {len(inputs)}")
        inputs = [torch.as_tensor(x) for x in inputs]
        self.device = inputs[0].device if inputs else torch.device("cpu")
        self.fold = int(fold)
        self.batched = {vi.name for vi in m.inputs}
        env: Dict[str, Any] = {k: torch.as_tensor(v, device=self.device)
                               for k, v in consts.items()}
        self.static = {}
        for vi, x in zip(m.inputs, inputs):
            env[vi.name] = x
        for node in m.nodes:
            if node.op_type == "Constant":
                continue  # folded at load
            _OP_IMPLS[node.op_type](self, env, node)
            if any(i in self.batched for i in node.inputs):
                self.batched.update(o for o in node.outputs if o not in self.static)
        return tuple(env[vi.name] for vi in m.outputs)


# -- op implementations ---------------------------------------------------------------

def _ints(node: OnnxNode, key: str, default=None):
    v = node.attrs.get(key, default)
    return None if v is None else [int(x) for x in v]


def _norm(axis: int, rank: int) -> int:
    return axis % rank if rank else 0


def _op_conv(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])            # NCHW
    w = L.val(env, node.inputs[1])            # [O, I/g, kH, kW]
    b = L.val(env, node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2] else None
    spatial = x.dim() - 2
    kernel = _ints(node, "kernel_shape") or list(w.shape[2:])
    strides = _ints(node, "strides") or [1] * spatial
    dilations = _ints(node, "dilations") or [1] * spatial
    group = int(node.attrs.get("group", 1))
    auto_pad = node.attrs.get("auto_pad", b"NOTSET")
    if auto_pad and auto_pad not in (b"NOTSET", "NOTSET"):
        pads = _auto_pad(auto_pad, x.shape[2:], kernel, strides, dilations)
    else:
        pads = _act_pads(_ints(node, "pads") or [0] * (2 * spatial), x.dim())
    if spatial not in (1, 2):
        raise OnnxLowerError(f"Conv with {spatial} spatial dims")
    xp, pad = _pad_spatial(x, pads)
    conv = F.conv1d if spatial == 1 else F.conv2d
    y = conv(xp, w, stride=strides, padding=pad, dilation=dilations, groups=group)
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * spatial)
    L.set_out(env, node, y)


def _op_conv_transpose(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])            # NCHW
    w = L.val(env, node.inputs[1])            # [I, O/g, kH, kW]
    b = L.val(env, node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2] else None
    if int(node.attrs.get("group", 1)) != 1:
        raise OnnxLowerError("grouped ConvTranspose")
    if x.dim() != 4:
        raise OnnxLowerError("ConvTranspose only 2-D")
    strides = _ints(node, "strides") or [1, 1]
    pads = _act_pads(_ints(node, "pads") or [0, 0, 0, 0], x.dim())
    out_pads = _ints(node, "output_padding") or [0, 0]
    # the full transposed convolution, then the window pads and
    # output_padding keep (an output_padding row past the full output is 0)
    y = F.conv_transpose2d(x, w, stride=strides)
    h = y.shape[2] - pads[0][0] - pads[0][1] + out_pads[0]
    wd = y.shape[3] - pads[1][0] - pads[1][1] + out_pads[1]
    y = F.pad(y, (0, out_pads[1], 0, out_pads[0]))
    y = y[:, :, pads[0][0]:pads[0][0] + h, pads[1][0]:pads[1][0] + wd]
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    L.set_out(env, node, y)


def _pool(L: _Lowering, env, node: OnnxNode, kind: str):
    x = L.val(env, node.inputs[0])
    spatial = x.dim() - 2
    kernel = _ints(node, "kernel_shape")
    strides = _ints(node, "strides") or [1] * spatial
    if _ints(node, "dilations", [1] * spatial) != [1] * spatial:
        raise OnnxLowerError(f"{node.op_type} with dilations")
    if int(node.attrs.get("ceil_mode", 0)):
        raise OnnxLowerError(f"{node.op_type} ceil_mode")
    if spatial != 2:
        raise OnnxLowerError(f"{node.op_type} with {spatial} spatial dims")
    auto_pad = node.attrs.get("auto_pad", b"NOTSET")
    if auto_pad and auto_pad not in (b"NOTSET", "NOTSET"):
        pads = _auto_pad(auto_pad, x.shape[2:], kernel, strides, [1] * spatial)
    else:
        pads = _act_pads(_ints(node, "pads") or [0] * (2 * spatial), x.dim())
    flat = [pads[1][0], pads[1][1], pads[0][0], pads[0][1]]
    if kind == "max":
        y = F.max_pool2d(F.pad(x, flat, value=-float("inf")), kernel, strides)
    else:
        summed = F.avg_pool2d(F.pad(x, flat), kernel, strides, divisor_override=1)
        if int(node.attrs.get("count_include_pad", 0)):
            y = summed / float(np.prod(kernel))
        else:
            ones = F.pad(torch.ones_like(x[:1, :1]), flat)
            y = summed / F.avg_pool2d(ones, kernel, strides, divisor_override=1)
    L.set_out(env, node, y)


def _op_gemm(L: _Lowering, env, node: OnnxNode):
    a = L.val(env, node.inputs[0])
    b = L.val(env, node.inputs[1])
    c = L.val(env, node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2] else None
    alpha = float(node.attrs.get("alpha", 1.0))
    beta = float(node.attrs.get("beta", 1.0))
    ta, tb = int(node.attrs.get("transA", 0)), int(node.attrs.get("transB", 0))
    if L.fold > 1:
        L.need(not (L.is_batched(node.inputs[0]) and ta) and not L.is_batched(node.inputs[1]),
               node, "a folded operand's rows in the contraction")
    if ta:
        a = a.T
    if tb:
        b = b.T
    y = alpha * (a @ b)
    if c is not None and beta:
        L.check_operands(node, [node.inputs[0], node.inputs[2]], [y, c])
        y = y + beta * c
    L.set_out(env, node, y)


def _op_matmul(L: _Lowering, env, node: OnnxNode):
    a = L.val(env, node.inputs[0])
    b = L.val(env, node.inputs[1])
    if L.is_batched(node.inputs[1]):
        L.need(b.dim() > 2, node, "a folded right-hand matrix")
    if b.dim() > 2:
        L.check_operands(node, node.inputs[:2], [a, b])
    sa, sb = L.maybe_static(env, node.inputs[0]), L.maybe_static(env, node.inputs[1])
    L.set_out(env, node, torch.matmul(a, b),
              None if sa is None or sb is None else np.matmul(sa, sb))


def _op_batchnorm(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    scale, bias, mean, var = (L.val(env, n) for n in node.inputs[1:5])
    eps = float(node.attrs.get("epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (x - mean.reshape(shape)) * (
        scale.reshape(shape) / torch.sqrt(var.reshape(shape) + eps)) + bias.reshape(shape)
    L.set_out(env, node, y)


def _op_layernorm(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    scale = L.val(env, node.inputs[1])
    bias = L.val(env, node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2] else None
    axis = _norm(int(node.attrs.get("axis", -1)), x.dim())
    if L.is_batched(node.inputs[0]):
        L.need(axis != 0, node, "a norm over axis 0")
    eps = float(node.attrs.get("epsilon", 1e-5))
    axes = tuple(range(axis, x.dim()))
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=axes, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps) * scale
    if bias is not None:
        y = y + bias
    L.set_out(env, node, y)


def _op_instancenorm(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    scale = L.val(env, node.inputs[1])
    bias = L.val(env, node.inputs[2])
    eps = float(node.attrs.get("epsilon", 1e-5))
    axes = tuple(range(2, x.dim()))
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=axes, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    L.set_out(env, node, (x - mu) / torch.sqrt(var + eps) * scale.reshape(shape)
              + bias.reshape(shape))


def _resolve(shape: List[int], numel: int) -> List[int]:
    if -1 in shape:
        known = int(np.prod([d for d in shape if d != -1]))
        shape = [numel // known if d == -1 else d for d in shape]
    return shape


def _op_reshape(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    shape = [int(v) for v in L.static_val(env, node.inputs[1]).ravel()]
    frame = L.shape_of(x, node.inputs[0])
    if not int(node.attrs.get("allowzero", 0)):
        shape = [frame[i] if s == 0 else s for i, s in enumerate(shape)]
    if L.is_batched(node.inputs[0]):
        shape = _resolve(shape, int(np.prod(frame)))
        L.need(bool(shape) and shape[0] == frame[0], node, f"reshape {frame} -> {shape}")
        shape = [shape[0] * L.fold] + shape[1:]
    s = L.maybe_static(env, node.inputs[0])
    L.set_out(env, node, x.reshape(shape), None if s is None else s.reshape(shape))


def _op_flatten(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    axis = int(node.attrs.get("axis", 1)) % (x.dim() + 1)
    if L.is_batched(node.inputs[0]):
        L.need(axis != 0, node, "flattening axis 0")
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    L.set_out(env, node, x.reshape(lead, -1))


def _op_transpose(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    perm = _ints(node, "perm") or list(range(x.dim()))[::-1]
    if L.is_batched(node.inputs[0]):
        L.need(perm[0] == 0, node, "moving axis 0")
    L.set_out(env, node, x.permute(perm))


def _op_concat(L: _Lowering, env, node: OnnxNode):
    parts = [L.val(env, n) for n in node.inputs]
    axis = int(node.attrs.get("axis", 0))
    if any(L.is_batched(n) for n in node.inputs):
        L.need(_norm(axis, parts[0].dim()) != 0 and all(L.is_batched(n) for n in node.inputs),
               node, "concatenation along axis 0")
    statics = [L.maybe_static(env, n) for n in node.inputs]
    static = (np.concatenate(statics, axis=axis)
              if all(s is not None for s in statics) else None)
    L.set_out(env, node, torch.cat(parts, dim=axis), static)


def _op_softmax(log: bool):
    def impl(L: _Lowering, env, node: OnnxNode):
        x = L.val(env, node.inputs[0])
        axis = int(node.attrs.get("axis", -1))
        if L.is_batched(node.inputs[0]):
            L.need(_norm(axis, x.dim()) != 0, node, "a softmax over axis 0")
        L.set_out(env, node, (torch.log_softmax if log else torch.softmax)(x, dim=axis))
    return impl


def _op_clip(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    lo = (L.val(env, node.inputs[1]) if len(node.inputs) > 1 and node.inputs[1]
          else node.attrs.get("min"))
    hi = (L.val(env, node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2]
          else node.attrs.get("max"))
    y = x
    if lo is not None:
        y = torch.maximum(y, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        y = torch.minimum(y, torch.as_tensor(hi, dtype=x.dtype, device=x.device))
    L.set_out(env, node, y)


def _op_shape(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    shape = np.asarray(L.shape_of(x, node.inputs[0]), np.int64)
    L.set_out(env, node, torch.tensor(shape.tolist(), dtype=torch.int32, device=L.device),
              shape)


def _op_gather(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    axis = _norm(int(node.attrs.get("axis", 0)), x.dim())
    idx_static = L.maybe_static(env, node.inputs[1])
    x_static = L.maybe_static(env, node.inputs[0])
    static = None
    if idx_static is not None and x_static is not None:
        static = np.take(x_static, idx_static.astype(np.int64), axis=axis)
    if idx_static is not None:
        idx = torch.as_tensor(idx_static.astype(np.int64), device=x.device)
    else:
        L.need(not L.is_batched(node.inputs[1]), node, "indices that are activations")
        idx = env[node.inputs[1]].long()
    if L.is_batched(node.inputs[0]):
        L.need(axis != 0, node, "gathering along axis 0")
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    y = x.index_select(axis, idx.reshape(-1)).reshape(
        tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))
    L.set_out(env, node, y, static)


def _op_unsqueeze(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    if len(node.inputs) > 1:                   # opset >= 13: the axes input
        axes = [int(v) for v in L.static_val(env, node.inputs[1]).ravel()]
    else:
        axes = _ints(node, "axes")
    axes = sorted(a % (x.dim() + len(axes)) for a in axes)
    if L.is_batched(node.inputs[0]):
        L.need(0 not in axes, node, "a new axis 0")
    y = x
    for ax in axes:
        y = y.unsqueeze(ax)
    s = L.maybe_static(env, node.inputs[0])
    static = None
    if s is not None:
        static = s
        for ax in sorted(a % (s.ndim + len(axes)) for a in axes):
            static = np.expand_dims(static, ax)
    L.set_out(env, node, y, static)


def _op_squeeze(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    shape = L.shape_of(x, node.inputs[0])
    if len(node.inputs) > 1 and node.inputs[1]:
        axes = tuple(int(v) % x.dim() for v in L.static_val(env, node.inputs[1]).ravel())
    else:
        axes = tuple(_ints(node, "axes") or [i for i, d in enumerate(shape) if d == 1])
    axes = sorted(a % x.dim() for a in axes)
    if L.is_batched(node.inputs[0]):
        L.need(0 not in axes, node, "squeezing axis 0")
    for a in reversed(axes):
        x = x.squeeze(a)
    L.set_out(env, node, x)


def _op_slice(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    if len(node.inputs) > 1:                   # opset >= 10: inputs
        starts = L.static_val(env, node.inputs[1]).ravel()
        ends = L.static_val(env, node.inputs[2]).ravel()
        axes = (L.static_val(env, node.inputs[3]).ravel()
                if len(node.inputs) > 3 and node.inputs[3] else np.arange(len(starts)))
        steps = (L.static_val(env, node.inputs[4]).ravel()
                 if len(node.inputs) > 4 and node.inputs[4] else np.ones(len(starts), np.int64))
    else:                                      # opset 1: attributes
        starts = np.asarray(_ints(node, "starts"))
        ends = np.asarray(_ints(node, "ends"))
        axes = np.asarray(_ints(node, "axes") or range(len(starts)))
        steps = np.ones(len(starts), np.int64)
    shape = L.shape_of(x, node.inputs[0])
    idx: List[Any] = [slice(None)] * x.dim()
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % x.dim()
        idx[ax] = slice(int(st), None if en >= 2**31 - 1 else int(en), int(sp))
    y = x
    for d, sl in enumerate(idx):
        keep = list(range(shape[d]))[sl]
        if keep == list(range(shape[d])):
            continue
        if L.is_batched(node.inputs[0]) and d == 0:
            L.need(False, node, "slicing axis 0")
        y = _take(y, d, keep)
    s = L.maybe_static(env, node.inputs[0])
    L.set_out(env, node, y, s[tuple(idx)] if s is not None else None)


def _op_split(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    axis = int(node.attrs.get("axis", 0)) % x.dim()
    if L.is_batched(node.inputs[0]):
        L.need(axis != 0, node, "splitting axis 0")
    if len(node.inputs) > 1 and node.inputs[1]:
        sizes = [int(v) for v in L.static_val(env, node.inputs[1]).ravel()]
    else:
        sizes = _ints(node, "split")
    if sizes:
        parts = torch.tensor_split(x, np.cumsum(sizes)[:-1].tolist(), dim=axis)
    else:
        n = len(node.outputs)
        if x.shape[axis] % n:
            raise ValueError(f"Split: {x.shape[axis]} does not split into {n} equal parts")
        parts = torch.split(x, x.shape[axis] // n, dim=axis)
    for name, part in zip(node.outputs, parts):
        env[name] = part


def _op_pad(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    mode = node.attrs.get("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if len(node.inputs) > 1:
        pads = [int(v) for v in L.static_val(env, node.inputs[1]).ravel()]
        value = 0.0
        if len(node.inputs) > 2 and node.inputs[2]:
            value = float(np.asarray(L.static_val(env, node.inputs[2])).ravel()[0])
    else:
        pads = _ints(node, "pads")
        value = float(node.attrs.get("value", 0.0))
    half = len(pads) // 2
    widths = [(pads[i], pads[i + half]) for i in range(half)]
    if L.is_batched(node.inputs[0]):
        L.need(widths[0] == (0, 0), node, "padding axis 0")
    if mode not in ("constant", "reflect", "edge"):
        raise OnnxLowerError(f"Pad mode {mode!r}")
    y = x
    for d, (lo, hi) in enumerate(widths):
        if not (lo or hi):
            continue
        n = y.shape[d]
        if mode == "constant":
            shape = list(y.shape)
            parts = []
            for w in (lo, hi):
                shape[d] = w
                parts.append(torch.full(shape, value, dtype=y.dtype, device=y.device))
            y = torch.cat([parts[0], y, parts[1]], dim=d)
            continue
        i = torch.arange(-lo, n + hi, device=y.device)
        if mode == "reflect":
            i = i.abs()
            i = torch.where(i >= n, 2 * (n - 1) - i, i)
        else:
            i = i.clamp(0, n - 1)
        y = y.index_select(d, i)
    L.set_out(env, node, y)


def _op_resize(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])             # NCHW
    if x.dim() != 4:
        raise OnnxLowerError("Resize only 4-D NCHW")

    def sizes_from_scales(scales) -> Optional[List[int]]:
        scales = np.asarray(scales, np.float64).ravel()
        if not scales.size:
            return None
        return [int(round(d * s)) for d, s in zip(x.shape, scales)]

    sizes = None
    if len(node.inputs) > 3 and node.inputs[3]:
        sizes = [int(v) for v in L.static_val(env, node.inputs[3]).ravel()]
    elif len(node.inputs) > 2 and node.inputs[2]:
        sizes = sizes_from_scales(L.static_val(env, node.inputs[2]))
    elif len(node.inputs) > 1 and node.inputs[1]:
        sizes = sizes_from_scales(L.static_val(env, node.inputs[1]))
    elif node.attrs.get("scales"):
        sizes = sizes_from_scales(node.attrs["scales"])
    if sizes is None:
        raise OnnxLowerError("Resize/Upsample without static scales/sizes")
    mode = node.attrs.get("mode", b"nearest")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    coord = node.attrs.get("coordinate_transformation_mode", b"half_pixel")
    coord = coord.decode() if isinstance(coord, bytes) else coord
    xn = x.permute(0, 2, 3, 1)
    align = coord == "align_corners"
    half = coord in ("half_pixel", "pytorch_half_pixel")
    if mode == "nearest":
        yn = _resize_nearest(xn, sizes[2], sizes[3], align, half)
    elif mode in ("linear", "cubic"):          # cubic approximated as linear
        yn = _resize_bilinear(xn, sizes[2], sizes[3], align, half)
    else:
        raise OnnxLowerError(f"Resize mode {mode!r}")
    L.set_out(env, node, yn.permute(0, 3, 1, 2))


def _op_cast(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    to = ONNX_DTYPES.get(int(node.attrs.get("to", 1)), "float32")
    s = L.maybe_static(env, node.inputs[0])
    L.set_out(env, node, x.to(_torch_dtype(to)), None if s is None else s.astype(np.dtype(
        "float32" if to == "bfloat16" else to)))


def _op_constant_of_shape(L: _Lowering, env, node: OnnxNode):
    shape = [int(v) for v in L.static_val(env, node.inputs[0]).ravel()]
    value = node.attrs.get("value")
    fill = float(np.asarray(value).ravel()[0]) if value is not None else 0.0
    dtype = np.asarray(value).dtype if value is not None else np.dtype(np.float32)
    static = np.full(shape, fill, dtype)
    L.set_out(env, node, torch.as_tensor(static, device=L.device), static)


def _op_expand(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    shape = [int(v) for v in L.static_val(env, node.inputs[1]).ravel()]
    if L.is_batched(node.inputs[0]):
        L.need(len(shape) <= x.dim() and (len(shape) < x.dim() or shape[0] in (
            1, L.frame_shape(x)[0])), node, "broadcasting along axis 0")
        if len(shape) == x.dim():
            shape[0] = 1
    full = list(np.broadcast_shapes(tuple(x.shape), tuple(shape)))
    L.set_out(env, node, x.broadcast_to(full))


def _op_reduce(name: str, default_keep: int = 1):
    def impl(L: _Lowering, env, node: OnnxNode):
        x = L.val(env, node.inputs[0])
        if len(node.inputs) > 1 and node.inputs[1]:   # opset >= 18
            axes = tuple(int(v) % x.dim() for v in L.static_val(env, node.inputs[1]).ravel())
        else:
            raw = _ints(node, "axes")
            axes = tuple(a % x.dim() for a in raw) if raw else tuple(range(x.dim()))
        axes = tuple(sorted(set(axes)))
        if L.is_batched(node.inputs[0]):
            L.need(0 not in axes, node, "a reduction over axis 0")
        keep = bool(int(node.attrs.get("keepdims", default_keep)))
        if name == "prod":
            y = x
            for a in reversed(axes):
                y = torch.prod(y, dim=a, keepdim=keep)
        else:
            y = {"mean": torch.mean, "sum": torch.sum, "max": torch.amax,
                 "min": torch.amin}[name](x, dim=axes, keepdim=keep)
        L.set_out(env, node, y)
    return impl


def _op_argmax(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    axis = int(node.attrs.get("axis", 0))
    if L.is_batched(node.inputs[0]):
        L.need(_norm(axis, x.dim()) != 0, node, "an argmax over axis 0")
    keep = bool(int(node.attrs.get("keepdims", 1)))
    L.set_out(env, node, torch.argmax(x, dim=axis, keepdim=keep).to(torch.int32))


def _binop(fn, np_fn):
    def impl(L: _Lowering, env, node: OnnxNode):
        a = L.val(env, node.inputs[0])
        b = L.val(env, node.inputs[1])
        L.check_operands(node, node.inputs[:2], [a, b])
        sa = L.maybe_static(env, node.inputs[0])
        sb = L.maybe_static(env, node.inputs[1])
        static = None
        if sa is not None and sb is not None:
            try:
                static = np_fn(sa, sb)
            except Exception:  # noqa: BLE001 -- folding is best-effort
                static = None
        L.set_out(env, node, fn(a, b), static)
    return impl


def _unop(fn):
    def impl(L: _Lowering, env, node: OnnxNode):
        L.set_out(env, node, fn(L.val(env, node.inputs[0])))
    return impl


def _op_identity(L: _Lowering, env, node: OnnxNode):
    L.set_out(env, node, L.val(env, node.inputs[0]), L.maybe_static(env, node.inputs[0]))


def _op_dropout(L: _Lowering, env, node: OnnxNode):
    # inference: the identity; the optional mask output is all true
    x = L.val(env, node.inputs[0])
    env[node.outputs[0]] = x
    if len(node.outputs) > 1:
        env[node.outputs[1]] = torch.ones(x.shape, dtype=torch.bool, device=x.device)


def _qparams(L: _Lowering, env, node: OnnxNode):
    """(scale, zero point, axis) of Quantize/DequantizeLinear."""
    scale = np.asarray(L.static_val(env, node.inputs[1]), np.float32)
    zp = (np.asarray(L.static_val(env, node.inputs[2]))
          if len(node.inputs) > 2 and node.inputs[2] else np.zeros_like(scale, np.int64))
    return scale, zp, int(node.attrs.get("axis", 1))


def _per_axis(L: _Lowering, node: OnnxNode, x, axis: int, scale, zp):
    """Scale and zero point broadcast along ``axis`` (or scalars)."""
    if scale.size > 1:
        axis = axis % x.dim()
        if L.is_batched(node.inputs[0]):
            L.need(axis != 0, node, "per-axis scales along axis 0")
        shape = [1] * x.dim()
        shape[axis] = scale.size
        return (torch.as_tensor(scale.reshape(shape), device=x.device),
                torch.as_tensor(zp.astype(np.float32).reshape(shape), device=x.device))
    return float(scale.ravel()[0]), float(zp.ravel()[0])


def _op_quantize_linear(L: _Lowering, env, node: OnnxNode):
    """A QDQ quantization boundary: ``clip(round(x / s) + zp)`` in the zero
    point's integer dtype (uint8 where it is absent)."""
    x = L.val(env, node.inputs[0])
    scale, zp, axis = _qparams(L, env, node)
    if zp.dtype == np.int64:
        name = "uint8"
    elif zp.dtype in (np.dtype("int8"), np.dtype("uint8"), np.dtype("int16"),
                      np.dtype("uint16"), np.dtype("int32")):
        name = zp.dtype.name
    else:
        raise OnnxLowerError(f"QuantizeLinear to {zp.dtype} not supported")
    lo, hi = np.iinfo(np.dtype(name)).min, np.iinfo(np.dtype(name)).max
    s, z = _per_axis(L, node, x, axis, scale, zp)
    # the spec's order: round(x / s), then add zp (an odd zp must not move a
    # round-half-even tie)
    q = torch.clamp(torch.round(x / s) + z, lo, hi)
    env[node.outputs[0]] = q.to(torch.int32 if name == "uint16" else _torch_dtype(name))


def _op_dequantize_linear(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    scale, zp, axis = _qparams(L, env, node)
    s, z = _per_axis(L, node, x, axis, scale, zp)
    env[node.outputs[0]] = (x.to(torch.float32) - z) * s


def _op_where(L: _Lowering, env, node: OnnxNode):
    c, a, b = (L.val(env, n) for n in node.inputs[:3])
    L.check_operands(node, node.inputs[:3], [c, a, b])
    L.set_out(env, node, torch.where(c.to(torch.bool), a, b))


def _op_prelu(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])
    alpha = L.val(env, node.inputs[1])
    L.check_operands(node, node.inputs[:2], [x, alpha])
    L.set_out(env, node, torch.where(x >= 0, x, x * alpha))


def _op_lrn(L: _Lowering, env, node: OnnxNode):
    x = L.val(env, node.inputs[0])             # NCHW
    size = int(node.attrs["size"])
    alpha = float(node.attrs.get("alpha", 1e-4))
    beta = float(node.attrs.get("beta", 0.75))
    bias = float(node.attrs.get("k", 1.0))
    half = size // 2
    sq = F.pad(x * x, (0, 0) * (x.dim() - 2) + (half, size - 1 - half))
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(size))
    L.set_out(env, node, x / (bias + alpha / size * acc) ** beta)


def _leaky_relu(L: _Lowering, e, n):
    x = L.val(e, n.inputs[0])
    L.set_out(e, n, torch.where(x >= 0, x, x * float(n.attrs.get("alpha", 0.01))))


def _hard_sigmoid(L: _Lowering, e, n):
    x = L.val(e, n.inputs[0])
    L.set_out(e, n, torch.clamp(x * float(n.attrs.get("alpha", 0.2))
                                + float(n.attrs.get("beta", 0.5)), 0.0, 1.0))


def _global_pool(fn):
    return _unop(lambda x: fn(x, dim=tuple(range(2, x.dim())), keepdim=True))


_OP_IMPLS: Dict[str, Callable] = {
    "Conv": _op_conv,
    "ConvTranspose": _op_conv_transpose,
    "MaxPool": lambda L, e, n: _pool(L, e, n, "max"),
    "AveragePool": lambda L, e, n: _pool(L, e, n, "avg"),
    "GlobalAveragePool": _global_pool(torch.mean),
    "GlobalMaxPool": _global_pool(torch.amax),
    "Gemm": _op_gemm,
    "MatMul": _op_matmul,
    "BatchNormalization": _op_batchnorm,
    "LayerNormalization": _op_layernorm,
    "InstanceNormalization": _op_instancenorm,
    "LRN": _op_lrn,
    "Relu": _unop(torch.relu),
    "LeakyRelu": _leaky_relu,
    "PRelu": _op_prelu,
    "Sigmoid": _unop(torch.sigmoid),
    "HardSigmoid": _hard_sigmoid,
    "Tanh": _unop(torch.tanh),
    "Erf": _unop(torch.erf),
    "Gelu": _unop(lambda x: F.gelu(x, approximate="tanh")),  # jax.nn.gelu's default
    "Softplus": _unop(lambda x: torch.logaddexp(x, torch.zeros_like(x))),
    "Softmax": _op_softmax(log=False),
    "LogSoftmax": _op_softmax(log=True),
    "Clip": _op_clip,
    "Add": _binop(torch.add, np.add),
    "Sub": _binop(torch.sub, np.subtract),
    "Mul": _binop(torch.mul, np.multiply),
    "Div": _binop(torch.div, np.divide),
    "Pow": _binop(torch.pow, np.power),
    "Min": _binop(torch.minimum, np.minimum),
    "Max": _binop(torch.maximum, np.maximum),
    "Equal": _binop(torch.eq, np.equal),
    "Greater": _binop(torch.gt, np.greater),
    "Less": _binop(torch.lt, np.less),
    "Sqrt": _unop(torch.sqrt),
    "Exp": _unop(torch.exp),
    "Log": _unop(torch.log),
    "Abs": _unop(torch.abs),
    "Neg": _unop(torch.neg),
    "Floor": _unop(torch.floor),
    "Ceil": _unop(torch.ceil),
    "Reciprocal": _unop(lambda x: 1.0 / x),
    "Reshape": _op_reshape,
    "Flatten": _op_flatten,
    "Transpose": _op_transpose,
    "Concat": _op_concat,
    "Shape": _op_shape,
    "Gather": _op_gather,
    "Unsqueeze": _op_unsqueeze,
    "Squeeze": _op_squeeze,
    "Slice": _op_slice,
    "Split": _op_split,
    "Pad": _op_pad,
    "Resize": _op_resize,
    "Upsample": _op_resize,
    "Cast": _op_cast,
    "ConstantOfShape": _op_constant_of_shape,
    "Expand": _op_expand,
    "ReduceMean": _op_reduce("mean"),
    "ReduceSum": _op_reduce("sum"),
    "ReduceMax": _op_reduce("max"),
    "ReduceMin": _op_reduce("min"),
    "ReduceProd": _op_reduce("prod"),
    "ArgMax": _op_argmax,
    "Identity": _op_identity,
    "Dropout": _op_dropout,
    "Where": _op_where,
    "QuantizeLinear": _op_quantize_linear,
    "DequantizeLinear": _op_dequantize_linear,
}


def lower_onnx(model: OnnxModel) -> Callable:
    """``fn(*inputs) -> tuple(outputs)`` of the ONNX graph on torch tensors
    (the device of the inputs)."""
    lowering = _Lowering(model)
    consts = {k: torch.from_numpy(v) for k, v in lowering.params().items()}

    def fn(*inputs):
        dev = torch.as_tensor(inputs[0]).device if inputs else torch.device("cpu")
        with torch.inference_mode():
            return lowering.run({k: v.to(dev) for k, v in consts.items()}, *inputs)

    return fn
