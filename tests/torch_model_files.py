"""Model files for the port's importers, written with ``struct`` and numpy
alone (no ``flatbuffers``, no ``onnx``), so they can be made wherever the
port runs: ``chip_smoke.py`` and the CPU tests share them.

* :func:`tflite_bytes` serializes a ``TFLiteModel`` (the port's or the JAX
  package's dataclasses: the same fields) as a ``.tflite`` flatbuffer
  against the public TFLite schema (file identifier ``TFL3``).
* :func:`onnx_bytes` serializes an ``OnnxModel`` as an ``.onnx`` protobuf.
* :func:`mobilenet_v2_tflite` and :func:`mobilenet_v2_onnx` build
  MobileNet-v2 files from the port's zoo model: BatchNorm folded into the
  convolutions; the ``.tflite`` quantized as TensorFlow's hosted
  ``mobilenet_v2_1.0_224_quant.tflite`` is (``CONV_2D`` and
  ``DEPTHWISE_CONV_2D`` with fused RELU6, ``ADD``, ``AVERAGE_POOL_2D``, the
  classifier as a 1 x 1 ``CONV_2D``, ``RESHAPE``; uint8 per-tensor), or to
  TFLite's int8 spec (int8 per-channel symmetric weights, int8 asymmetric
  activations), with activation ranges from a float forward over
  calibration frames; the ``.onnx`` in float32 at opset 13.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from nnstreamer_tpu_torch.importers.onnx_reader import (
    OnnxModel, OnnxNode, OnnxValueInfo)
from nnstreamer_tpu_torch.importers.tflite_reader import (
    ACTIVATIONS, BUILTIN_OPS, PADDING, TENSOR_DTYPES, QuantParams, TFLiteModel, TFLOp,
    TFLTensor)

# -- a flatbuffer writer ----------------------------------------------------------

_SCALAR = {"i8": "<b", "u8": "<B", "bool": "<?", "i32": "<i", "u32": "<I", "i64": "<q",
           "f32": "<f"}


class _Flatbuffer:
    """Writes front to back: a table, then the objects its offsets name
    (uoffsets point forward); vtables sit just before their tables."""

    def __init__(self, ident: bytes):
        self.buf = bytearray(8)
        self.buf[4:8] = ident

    def _align(self, n: int, extra: int = 0) -> None:
        while (len(self.buf) + extra) % n:
            self.buf.append(0)

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def table(self, fields: Sequence[Tuple[int, str, Any]]) -> int:
        """``fields``: (slot, kind, value); kind a scalar kind, or "off"
        with a callable that writes the child and returns its position."""
        slots = max((s for s, _, _ in fields), default=-1) + 1
        layout, size = {}, 4  # after the soffset to the vtable
        for slot, kind, _ in sorted(fields, key=lambda f: -struct.calcsize(
                _SCALAR.get(f[1], "<I"))):
            width = struct.calcsize(_SCALAR.get(kind, "<I"))
            size = -(-size // width) * width
            layout[slot] = size
            size += width
        vt = struct.pack(f"<{2 + slots}H", 4 + 2 * slots, size,
                         *[layout.get(s, 0) for s in range(slots)])
        self._align(8, len(vt))
        vt_pos = len(self.buf)
        self.buf += vt
        pos = len(self.buf)
        self.buf += bytes(size)
        struct.pack_into("<i", self.buf, pos, pos - vt_pos)
        children = []
        for slot, kind, value in fields:
            if kind == "off":
                children.append((pos + layout[slot], value))
            else:
                struct.pack_into(_SCALAR[kind], self.buf, pos + layout[slot], value)
        for at, write in children:
            self._patch(at, write())
        return pos

    def vector(self, kind: str, values) -> int:
        width = struct.calcsize(_SCALAR[kind])
        self._align(max(4, width), 4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(values))
        self.buf += struct.pack(f"<{len(values)}{_SCALAR[kind][1]}", *values)
        return pos

    def raw(self, data: bytes, align: int = 16) -> int:
        self._align(align, 4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(data)) + data
        return pos

    def string(self, s: str) -> int:
        self._align(4)
        pos = len(self.buf)
        b = s.encode()
        self.buf += struct.pack("<I", len(b)) + b + b"\0"
        return pos

    def tables(self, writers: Sequence[Callable[[], int]]) -> int:
        self._align(4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(writers)) + bytes(4 * len(writers))
        for j, write in enumerate(writers):
            self._patch(pos + 4 + 4 * j, write())
        return pos

    def finish(self, root: Callable[[], int]) -> bytes:
        struct.pack_into("<I", self.buf, 0, root())
        return bytes(self.buf)


# -- TFLite -------------------------------------------------------------------------

_OPCODES = {name: code for code, name in BUILTIN_OPS.items()}
_DTYPE_CODES = {name: code for code, name in TENSOR_DTYPES.items()}
_PAD = {v: k for k, v in PADDING.items()}
_ACT = {v: k for k, v in ACTIVATIONS.items()}
_MIRROR = {"reflect": 0, "symmetric": 1}

# opcode -> (BuiltinOptions member, [(slot, kind, key, encoding)]), the
# inverse of the readers' options decoders
_POOL = [(0, "i8", "padding", _PAD), (1, "i32", "stride_w", None), (2, "i32", "stride_h", None),
         (3, "i32", "filter_w", None), (4, "i32", "filter_h", None),
         (5, "i8", "activation", _ACT)]
_ACT_ONLY = [(0, "i8", "activation", _ACT)]
_REDUCER = (27, [(0, "bool", "keep_dims", None)])
_OPTIONS: Dict[str, Tuple[int, list]] = {
    "CONV_2D": (1, [(0, "i8", "padding", _PAD), (1, "i32", "stride_w", None),
                    (2, "i32", "stride_h", None), (3, "i8", "activation", _ACT),
                    (4, "i32", "dilation_w", None), (5, "i32", "dilation_h", None)]),
    "DEPTHWISE_CONV_2D": (2, [(0, "i8", "padding", _PAD), (1, "i32", "stride_w", None),
                              (2, "i32", "stride_h", None), (3, "i32", "depth_multiplier", None),
                              (4, "i8", "activation", _ACT), (5, "i32", "dilation_w", None),
                              (6, "i32", "dilation_h", None)]),
    "AVERAGE_POOL_2D": (5, _POOL),
    "MAX_POOL_2D": (5, _POOL),
    "FULLY_CONNECTED": (8, [(0, "i8", "activation", _ACT), (1, "i8", "weights_format", None),
                            (2, "bool", "keep_num_dims", None)]),
    "SOFTMAX": (9, [(0, "f32", "beta", None)]),
    "CONCATENATION": (10, [(0, "i32", "axis", None), (1, "i8", "activation", _ACT)]),
    "ADD": (11, _ACT_ONLY),
    "L2_NORMALIZATION": (12, _ACT_ONLY),
    "RESIZE_BILINEAR": (15, [(2, "bool", "align_corners", None),
                             (3, "bool", "half_pixel_centers", None)]),
    "RESHAPE": (17, [(0, "vi32", "new_shape", None)]),
    "SPACE_TO_DEPTH": (19, [(0, "i32", "block_size", None)]),
    "MUL": (21, _ACT_ONLY),
    "GATHER": (23, [(0, "i32", "axis", None), (1, "i32", "batch_dims", None)]),
    "MEAN": _REDUCER, "SUM": _REDUCER, "REDUCE_MAX": _REDUCER, "REDUCE_MIN": _REDUCER,
    "REDUCE_PROD": _REDUCER,
    "SUB": (28, _ACT_ONLY),
    "DIV": (29, _ACT_ONLY),
    "SQUEEZE": (30, [(0, "vi32", "squeeze_dims", None)]),
    "STRIDED_SLICE": (32, [(0, "i32", "begin_mask", None), (1, "i32", "end_mask", None),
                           (2, "i32", "ellipsis_mask", None), (3, "i32", "new_axis_mask", None),
                           (4, "i32", "shrink_axis_mask", None)]),
    "SPLIT": (35, [(0, "i32", "num_splits", None)]),
    "CAST": (37, [(0, "i8", "in_dtype", _DTYPE_CODES), (1, "i8", "out_dtype", _DTYPE_CODES)]),
    "ARG_MAX": (40, [(0, "i8", "output_type", _DTYPE_CODES)]),
    "TRANSPOSE_CONV": (49, [(0, "i8", "padding", _PAD), (1, "i32", "stride_w", None),
                            (2, "i32", "stride_h", None), (3, "i8", "activation", _ACT)]),
    "SHAPE": (55, [(0, "i8", "out_dtype", _DTYPE_CODES)]),
    "ARG_MIN": (57, [(0, "i8", "output_type", _DTYPE_CODES)]),
    "PACK": (59, [(0, "i32", "values_count", None), (1, "i32", "axis", None)]),
    "UNPACK": (64, [(0, "i32", "num", None), (1, "i32", "axis", None)]),
    "RESIZE_NEAREST_NEIGHBOR": (74, [(0, "bool", "align_corners", None),
                                     (1, "bool", "half_pixel_centers", None)]),
    "LEAKY_RELU": (75, [(0, "f32", "alpha", None)]),
    "MIRROR_PAD": (77, [(0, "i8", "mode", _MIRROR)]),
    "DEPTH_TO_SPACE": (94, [(0, "i32", "block_size", None)]),
}


def _opcode(name: str) -> Tuple[int, Optional[str]]:
    if name.startswith("CUSTOM:"):
        return 32, name.split(":", 1)[1]
    if name.startswith("BUILTIN_"):
        return int(name.split("_", 1)[1]), None
    return _OPCODES[name], None


def tflite_bytes(model: TFLiteModel, description: str = "") -> bytes:
    """``model`` as a ``.tflite`` flatbuffer; each constant tensor gets a
    buffer of its own (buffer 0 is the empty one)."""
    fb = _Flatbuffer(b"TFL3")
    opnames = sorted({op.opcode for op in model.ops}, key=[op.opcode for op in model.ops].index)
    consts = [t for t in model.tensors if t.data is not None]
    buffer_of = {t.index: j + 1 for j, t in enumerate(consts)}

    def opcode_table(name):
        code, custom = _opcode(name)
        fields = [(0, "i8", min(code, 127)), (3, "i32", code)]
        if custom is not None:
            fields.append((1, "off", lambda: fb.string(custom)))
        return lambda: fb.table(fields)

    def quant_table(q: QuantParams):
        return lambda: fb.table([
            (2, "off", lambda: fb.vector("f32", [float(v) for v in q.scale])),
            (3, "off", lambda: fb.vector("i64", [int(v) for v in q.zero_point])),
            (6, "i32", int(q.quantized_dimension))])

    def tensor_table(t: TFLTensor):
        fields = [(0, "off", lambda: fb.vector("i32", list(t.shape))),
                  (1, "i8", _DTYPE_CODES[t.dtype]),
                  (2, "u32", buffer_of.get(t.index, 0)),
                  (3, "off", lambda: fb.string(t.name))]
        if t.quant is not None:
            fields.append((4, "off", quant_table(t.quant)))
        return lambda: fb.table(fields)

    def options_table(op: TFLOp):
        member, spec = _OPTIONS[op.opcode]
        fields = []
        for slot, kind, key, enc in spec:
            if key not in op.options:
                continue
            v = op.options[key]
            if kind == "vi32":
                fields.append((slot, "off", lambda v=v: fb.vector("i32", list(v))))
            else:
                fields.append((slot, kind, enc[v] if enc is not None else v))
        return member, lambda: fb.table(fields)

    def op_table(op: TFLOp):
        fields = [(0, "u32", opnames.index(op.opcode)),
                  (1, "off", lambda: fb.vector("i32", list(op.inputs))),
                  (2, "off", lambda: fb.vector("i32", list(op.outputs)))]
        if op.opcode in _OPTIONS and op.options:
            member, write = options_table(op)
            fields += [(3, "u8", member), (4, "off", write)]
        return lambda: fb.table(fields)

    def buffer_table(data: Optional[np.ndarray]):
        if data is None:
            return lambda: fb.table([])
        raw = np.ascontiguousarray(data).tobytes()
        return lambda: fb.table([(0, "off", lambda: fb.raw(raw))])

    def subgraph():
        return fb.table([
            (0, "off", lambda: fb.tables([tensor_table(t) for t in model.tensors])),
            (1, "off", lambda: fb.vector("i32", list(model.inputs))),
            (2, "off", lambda: fb.vector("i32", list(model.outputs))),
            (3, "off", lambda: fb.tables([op_table(op) for op in model.ops]))])

    def root():
        return fb.table([
            (0, "u32", int(model.version)),
            (1, "off", lambda: fb.tables([opcode_table(n) for n in opnames])),
            (2, "off", lambda: fb.tables([subgraph])),
            (3, "off", lambda: fb.string(description or model.description)),
            (4, "off", lambda: fb.tables([buffer_table(None)]
                                         + [buffer_table(t.data) for t in consts]))])

    return fb.finish(root)


# -- ONNX ---------------------------------------------------------------------------

_ONNX_CODES = {"float32": 1, "uint8": 2, "int8": 3, "uint16": 4, "int16": 5, "int32": 6,
               "int64": 7, "bool": 9, "float16": 10, "float64": 11, "uint32": 12,
               "uint64": 13}


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fno: int, wt: int, payload) -> bytes:
    key = _varint(fno << 3 | wt)
    if wt == 0:
        return key + _varint(int(payload))
    if wt == 2:
        return key + _varint(len(payload)) + bytes(payload)
    return key + bytes(payload)  # 32-bit (wt 5)


def _str(fno: int, s: str) -> bytes:
    return _field(fno, 2, s.encode())


def _tensor_proto(name: str, a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    out = b"".join(_field(1, 0, d) for d in a.shape)
    out += _field(2, 0, _ONNX_CODES[a.dtype.name]) + _str(8, name)
    return out + _field(9, 2, a.tobytes())


def _attr(name: str, value) -> bytes:
    out = _str(1, name)
    if isinstance(value, bool) or isinstance(value, (int, np.integer)):
        return out + _field(3, 0, int(value)) + _field(20, 0, 2)
    if isinstance(value, (float, np.floating)):
        return out + _field(2, 5, struct.pack("<f", float(value))) + _field(20, 0, 1)
    if isinstance(value, (bytes, str)):
        b = value.encode() if isinstance(value, str) else value
        return out + _field(4, 2, b) + _field(20, 0, 3)
    if isinstance(value, np.ndarray):
        return out + _field(5, 2, _tensor_proto("", value)) + _field(20, 0, 4)
    values = list(value)
    if values and all(isinstance(v, (float, np.floating)) for v in values):
        return out + _field(7, 2, struct.pack(f"<{len(values)}f", *values)) + _field(20, 0, 6)
    return out + _field(8, 2, b"".join(_varint(int(v)) for v in values)) + _field(20, 0, 7)


def _value_info(vi: OnnxValueInfo) -> bytes:
    tensor_type = _field(1, 0, _ONNX_CODES[vi.dtype])
    if vi.shape is not None:  # no shape field: the shape is unknown
        dims = b"".join(_field(1, 2, _field(1, 0, d) if d is not None else b"")
                        for d in vi.shape)
        tensor_type += _field(2, 2, dims)
    return _str(1, vi.name) + _field(2, 2, _field(1, 2, tensor_type))


def onnx_bytes(model: OnnxModel) -> bytes:
    """``model`` as an ``.onnx`` ``ModelProto``."""
    graph = b""
    for i, n in enumerate(model.nodes):
        body = b"".join(_str(1, x) for x in n.inputs) + b"".join(_str(2, x) for x in n.outputs)
        body += _str(3, n.name or f"n{i}") + _str(4, n.op_type)
        body += b"".join(_field(5, 2, _attr(k, v)) for k, v in n.attrs.items())
        graph += _field(1, 2, body)
    graph += _str(2, "graph")
    graph += b"".join(_field(5, 2, _tensor_proto(k, v)) for k, v in model.initializers.items())
    graph += b"".join(_field(11, 2, _value_info(vi)) for vi in model.inputs)
    graph += b"".join(_field(12, 2, _value_info(vi)) for vi in model.outputs)
    opset = _str(1, "") + _field(2, 0, model.opset)
    return _field(1, 0, model.ir_version) + _field(8, 2, opset) + _field(7, 2, graph)


# -- MobileNet-v2 files from the zoo model ---------------------------------------------

def _fold(conv_bn) -> Tuple[np.ndarray, np.ndarray]:
    """A ConvBN's convolution with its BatchNorm folded in: (OIHW weight,
    bias) in float32."""
    import torch

    w = conv_bn.conv.weight.detach().to(torch.float32).cpu().numpy()
    bn = conv_bn.bn
    g = (bn.weight / torch.sqrt(bn.running_var + bn.eps)).detach().float().cpu().numpy()
    b = (bn.bias - bn.running_mean * bn.weight / torch.sqrt(bn.running_var + bn.eps))
    return w * g[:, None, None, None], b.detach().float().cpu().numpy()


def _layers(module):
    """The zoo MobileNet-v2 as a list of layers: ("conv", ConvBN, stride,
    groups, relu6), ("add",) closing a residual block, ("pool",),
    ("classifier", Linear)."""
    out = [("conv", module.stem)]
    for block in module.blocks:
        start = len(out)
        out += [("conv", cb) for cb in block.layers]
        if block.residual:
            out.append(("add", start))
    out += [("conv", module.head), ("pool",), ("classifier", module.classifier)]
    return out


def activation_ranges(module, frames, device="cpu") -> List[Tuple[float, float]]:
    """(min, max) of every layer output of :func:`_layers` over ``frames``
    (uint8 NHWC), by a float32 forward of the module's folded layers."""
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.quantize import same_pads

    x = torch.as_tensor(frames, device=device).float() * (1 / 128.0) - 1.0
    x = x.permute(0, 3, 1, 2)
    ranges, outs = [], []
    for layer in _layers(module):
        if layer[0] == "conv":
            cb = layer[1]
            w, b = _fold(cb)
            k, s, g = cb.conv.kernel_size[0], cb.conv.stride[0], cb.conv.groups
            t, bo = same_pads(x.shape[2], k, s)
            left, r = same_pads(x.shape[3], k, s)
            x = F.conv2d(F.pad(x, (left, r, t, bo)), torch.as_tensor(w, device=device),
                         torch.as_tensor(b, device=device), stride=s, groups=g)
            if cb.act:
                x = torch.clamp(x, 0.0, 6.0)
        elif layer[0] == "add":
            x = x + outs[layer[1] - 1]
        elif layer[0] == "pool":
            x = x.mean(dim=(2, 3), keepdim=True)
        else:
            lin = layer[1]
            x = F.conv2d(x, lin.weight.detach().float().to(device)[:, :, None, None],
                         lin.bias.detach().float().to(device))
        outs.append(x)
        ranges.append((min(0.0, float(x.min())), max(0.0, float(x.max()))))
    return ranges


def _asym(lo: float, hi: float, dtype: str) -> QuantParams:
    qmin, qmax = (0, 255) if dtype == "uint8" else (-128, 127)
    scale = max(hi - lo, 1e-8) / 255.0
    zp = int(np.clip(round(qmin - lo / scale), qmin, qmax))
    return QuantParams(np.array([scale], np.float32), np.array([zp], np.int64))


def mobilenet_v2_tflite(module, frames, spec: str = "uint8", device="cpu") -> bytes:
    """The zoo MobileNet-v2 ``module`` (float32 weights) as a quantized
    ``.tflite``.  ``spec`` "uint8": uint8 weights and activations, per-tensor
    scales and zero points (the hosted file's scheme); "int8": TFLite's int8
    spec (weights int8 per output channel, symmetric, ``quantized_dimension``
    0, or 3 for depthwise; activations int8 asymmetric; input int8).
    Activation ranges come from ``frames`` (uint8 NHWC calibration frames);
    the input is (1, H, W, 3) with scale 1/128 around zero point 128 (uint8)
    or 0 (int8)."""
    act = "uint8" if spec == "uint8" else "int8"
    ranges = activation_ranges(module, frames, device)
    h, w = frames.shape[1:3]
    tensors: List[TFLTensor] = []
    ops: List[TFLOp] = []

    def add(shape, dtype, quant, data=None, name=""):
        tensors.append(TFLTensor(len(tensors), name or f"t{len(tensors)}", tuple(shape), dtype,
                                 0, quant, data))
        return len(tensors) - 1

    in_q = QuantParams(np.array([1 / 128.0], np.float32),
                       np.array([128 if act == "uint8" else 0], np.int64))
    x = add((1, h, w, 3), act, in_q, name="input")
    outs, shape = [], (1, h, w, 3)

    def weight(wt: np.ndarray, depthwise: bool):
        """TFLite layout and quantization of an OIHW float weight."""
        tfl = (np.transpose(wt, (1, 2, 3, 0)) if depthwise  # (1, kh, kw, C)
               else np.transpose(wt, (0, 2, 3, 1)))          # (O, kh, kw, I)
        if spec == "uint8":
            lo, hi = min(0.0, float(tfl.min())), max(0.0, float(tfl.max()))
            q = _asym(lo, hi, "uint8")
            data = np.clip(np.round(tfl / q.scale[0]) + q.zero_point[0], 0, 255).astype(np.uint8)
            return data, q, "uint8"
        axis = 3 if depthwise else 0
        amax = np.abs(tfl).max(axis=tuple(d for d in range(4) if d != axis))
        scale = np.maximum(amax, 1e-8).astype(np.float32) / 127.0
        shp = [1] * 4
        shp[axis] = -1
        data = np.clip(np.round(tfl / scale.reshape(shp)), -127, 127).astype(np.int8)
        return data, QuantParams(scale, np.zeros(scale.size, np.int64), axis), "int8"

    for layer, (lo, hi) in zip(_layers(module), ranges):
        q_out = _asym(lo, hi, act)
        if layer[0] in ("conv", "classifier"):
            if layer[0] == "conv":
                cb = layer[1]
                wt, b = _fold(cb)
                k, s, g = cb.conv.kernel_size[0], cb.conv.stride[0], cb.conv.groups
                relu6 = cb.act
            else:
                wt = layer[1].weight.detach().float().cpu().numpy()[:, :, None, None]
                b = layer[1].bias.detach().float().cpu().numpy()
                k, s, g, relu6 = 1, 1, 1, False
            depthwise = g > 1
            data, q_w, w_dtype = weight(wt, depthwise)
            s_in = tensors[x].quant.scale[0]
            b_scale = (s_in * q_w.scale).astype(np.float32)
            b_q = np.round(b / b_scale).astype(np.int32)
            wi = add(data.shape, w_dtype, q_w, data)
            bi = add(b.shape, "int32", QuantParams(b_scale, np.zeros(b_scale.size, np.int64)),
                     b_q)
            ho, wo = -(-shape[1] // s), -(-shape[2] // s)
            shape = (1, ho, wo, wt.shape[0])
            y = add(shape, act, q_out)
            opts = {"padding": "SAME", "stride_w": s, "stride_h": s,
                    "activation": "relu6" if relu6 else None, "dilation_w": 1, "dilation_h": 1}
            if depthwise:
                opts["depth_multiplier"] = 1
            ops.append(TFLOp("DEPTHWISE_CONV_2D" if depthwise else "CONV_2D", [x, wi, bi], [y],
                             opts))
        elif layer[0] == "add":
            y = add(shape, act, q_out)
            ops.append(TFLOp("ADD", [outs[layer[1] - 1], x], [y], {"activation": None}))
        else:  # the average pool over the whole map
            y = add((1, 1, 1, shape[3]), act, q_out)
            ops.append(TFLOp("AVERAGE_POOL_2D", [x], [y], {
                "padding": "VALID", "stride_w": 1, "stride_h": 1, "filter_w": shape[2],
                "filter_h": shape[1], "activation": None}))
            shape = (1, 1, 1, shape[3])
        outs.append(y)
        x = y
    classes = shape[3]
    new_shape = add((2,), "int32", None, np.array([1, classes], np.int32))
    y = add((1, classes), act, tensors[x].quant, name="output")
    ops.append(TFLOp("RESHAPE", [x, new_shape], [y], {"new_shape": [1, classes]}))
    model = TFLiteModel(3, f"mobilenet_v2 {spec}", tensors, [0], [y], ops)
    return tflite_bytes(model)


def mobilenet_v2_onnx(module, h: int = 224, w: int = 224) -> bytes:
    """The zoo MobileNet-v2 ``module`` as a float32 ``.onnx`` at opset 13:
    the zoo's input mapping (``Cast``, ``Mul`` by 2/255, ``Add`` -1,
    ``Transpose`` to NCHW), then ``Conv`` (with ``group``, BatchNorm folded
    in, explicit SAME pads), ``Clip`` 0..6, ``Add``, ``GlobalAveragePool``,
    ``Flatten``, ``Gemm``; input (1, H, W, 3) uint8 as the zoo model takes
    frames, output (1, classes) float32."""
    from nnstreamer_tpu_torch.ops.quantize import same_pads

    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {
        "clip_min": np.array(0.0, np.float32), "clip_max": np.array(6.0, np.float32),
        "in_scale": np.array(2.0 / 255.0, np.float32), "in_bias": np.array(-1.0, np.float32)}
    nodes += [OnnxNode("Cast", ["input"], ["in_f"], attrs={"to": 1}),
              OnnxNode("Mul", ["in_f", "in_scale"], ["in_s"]),
              OnnxNode("Add", ["in_s", "in_bias"], ["in_n"]),
              OnnxNode("Transpose", ["in_n"], ["x"], attrs={"perm": [0, 3, 1, 2]})]
    x, outs, size = "x", [], (h, w)
    zero, six = "clip_min", "clip_max"
    for i, layer in enumerate(_layers(module)):
        y = f"t{i}"
        if layer[0] == "conv":
            cb = layer[1]
            wt, b = _fold(cb)
            k, s, g = cb.conv.kernel_size[0], cb.conv.stride[0], cb.conv.groups
            (t, bo), (left, r) = same_pads(size[0], k, s), same_pads(size[1], k, s)
            inits[f"w{i}"], inits[f"b{i}"] = wt.astype(np.float32), b.astype(np.float32)
            conv_out = f"c{i}" if cb.act else y
            nodes.append(OnnxNode("Conv", [x, f"w{i}", f"b{i}"], [conv_out], attrs={
                "kernel_shape": [k, k], "strides": [s, s], "pads": [t, left, bo, r],
                "group": g}))
            if cb.act:
                nodes.append(OnnxNode("Clip", [conv_out, zero, six], [y]))
            size = (-(-size[0] // s), -(-size[1] // s))
        elif layer[0] == "add":
            nodes.append(OnnxNode("Add", [outs[layer[1] - 1], x], [y]))
        elif layer[0] == "pool":
            nodes.append(OnnxNode("GlobalAveragePool", [x], [f"p{i}"]))
            nodes.append(OnnxNode("Flatten", [f"p{i}"], [y], attrs={"axis": 1}))
        else:
            lin = layer[1]
            inits["fc_w"] = lin.weight.detach().float().cpu().numpy()
            inits["fc_b"] = lin.bias.detach().float().cpu().numpy()
            y = "output"
            nodes.append(OnnxNode("Gemm", [x, "fc_w", "fc_b"], [y], attrs={"transB": 1}))
            classes = inits["fc_w"].shape[0]
        outs.append(y)
        x = y
    model = OnnxModel(8, 13, nodes, inits,
                      [OnnxValueInfo("input", "uint8", (1, h, w, 3))],
                      [OnnxValueInfo("output", "float32", (1, classes))])
    return onnx_bytes(model)
