"""ONNX model reader: a protobuf wire-format reader on ``struct``, no
``onnx`` package.

Port of ``nnstreamer_tpu/importers/onnx_reader.py`` (the same code: it
never imported JAX).  ``.onnx`` files (``ModelProto``) are walked record by
record, with the field numbers of the public ``onnx/onnx.proto3`` schema;
only what the lowering reads is kept (graph topology, initializers, value
info shapes, node attributes).  Every malformed input fails with
:class:`OnnxParseError`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np


class OnnxParseError(ValueError):
    pass


# -- protobuf wire-format primitives ----------------------------------------

def _read_varint(buf: memoryview, off: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if off >= len(buf):
            raise OnnxParseError("truncated varint")
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7
        if shift > 70:
            raise OnnxParseError("varint too long")


def _signed(v: int) -> int:
    """Interpret a varint as two's-complement int64 (protobuf int64)."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, payload).  Payload is an int for
    varint/fixed types, a memoryview for length-delimited."""
    off = 0
    n = len(buf)
    while off < n:
        key, off = _read_varint(buf, off)
        fno, wt = key >> 3, key & 7
        if wt == 0:          # varint
            val, off = _read_varint(buf, off)
            yield fno, wt, val
        elif wt == 1:        # 64-bit
            if off + 8 > n:
                raise OnnxParseError("truncated 64-bit field")
            val = buf[off:off + 8]
            off += 8
            yield fno, wt, val
        elif wt == 2:        # length-delimited
            ln, off = _read_varint(buf, off)
            if off + ln > n:
                raise OnnxParseError("truncated length-delimited field")
            yield fno, wt, buf[off:off + ln]
            off += ln
        elif wt == 5:        # 32-bit
            if off + 4 > n:
                raise OnnxParseError("truncated 32-bit field")
            val = buf[off:off + 4]
            off += 4
            yield fno, wt, val
        else:
            raise OnnxParseError(f"unsupported wire type {wt}")


def _packed_varints(view: memoryview, signed: bool = True) -> List[int]:
    out = []
    off = 0
    while off < len(view):
        v, off = _read_varint(view, off)
        out.append(_signed(v) if signed else v)
    return out


# -- ONNX data types ---------------------------------------------------------

ONNX_DTYPES = {
    1: "float32", 2: "uint8", 3: "int8", 4: "uint16", 5: "int16",
    6: "int32", 7: "int64", 9: "bool", 10: "float16", 11: "float64",
    12: "uint32", 13: "uint64", 16: "bfloat16",
}


@dataclass
class OnnxAttr:
    name: str
    value: Any  # float | int | bytes | np.ndarray | list[...]


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OnnxValueInfo:
    name: str
    dtype: Optional[str]
    shape: Optional[Tuple[Optional[int], ...]]  # None dim = dynamic


@dataclass
class OnnxModel:
    ir_version: int
    opset: int
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[OnnxValueInfo]      # graph inputs MINUS initializers
    outputs: List[OnnxValueInfo]

    def op_histogram(self) -> Dict[str, int]:
        h: Dict[str, int] = {}
        for n in self.nodes:
            h[n.op_type] = h.get(n.op_type, 0) + 1
        return h


# -- message decoders --------------------------------------------------------

def _decode_tensor(view: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = 1
    raw: Optional[memoryview] = None
    name = ""
    float_data: List[float] = []
    int_data: List[int] = []
    for fno, wt, val in iter_fields(view):
        if fno == 1:                      # dims
            if wt == 2:
                dims.extend(_packed_varints(val))
            else:
                dims.append(_signed(val))
        elif fno == 2 and wt == 0:        # data_type
            data_type = val
        elif fno == 4:                    # float_data (packed or not)
            if wt == 2:
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", bytes(val)))
            else:
                float_data.append(struct.unpack("<f", bytes(val))[0])
        elif fno == 5:                    # int32_data
            if wt == 2:
                int_data.extend(_packed_varints(val))
            else:
                int_data.append(_signed(val))
        elif fno == 7:                    # int64_data
            if wt == 2:
                int_data.extend(_packed_varints(val))
            else:
                int_data.append(_signed(val))
        elif fno == 8 and wt == 2:        # name
            name = bytes(val).decode("utf-8", "replace")
        elif fno == 9 and wt == 2:        # raw_data
            raw = val
        elif fno == 10:                   # double_data
            if wt == 2:
                float_data.extend(
                    struct.unpack(f"<{len(val) // 8}d", bytes(val)))
            else:
                float_data.append(struct.unpack("<d", bytes(val))[0])
    dtype_name = ONNX_DTYPES.get(data_type)
    if dtype_name is None:
        raise OnnxParseError(f"tensor {name!r}: unsupported data_type "
                             f"{data_type}")
    np_dtype = (np.dtype(np.uint16) if dtype_name == "bfloat16"
                else np.dtype(dtype_name))
    shape = tuple(int(d) for d in dims)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dtype)
    elif int_data:
        if dtype_name in ("float16", "bfloat16"):
            # spec: fp16/bf16 ride int32_data as raw BIT PATTERNS
            arr = np.asarray(int_data, np.uint16).view(np_dtype)
        else:
            arr = np.asarray(int_data, dtype=np_dtype)
    else:
        if int(np.prod(shape, dtype=np.int64)) > (1 << 28):
            raise OnnxParseError(
                f"tensor {name!r}: declared dims {shape} with no data")
        arr = np.zeros(shape, np_dtype)
    if dtype_name == "bfloat16":
        # widen via bit manipulation: bf16 is the top half of f32
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return name, arr.reshape(shape) if shape else arr.reshape(())


def _decode_attr(view: memoryview) -> OnnxAttr:
    name = ""
    atype = 0
    f_val = i_val = s_val = t_val = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fno, wt, val in iter_fields(view):
        if fno == 1 and wt == 2:
            name = bytes(val).decode()
        elif fno == 2 and wt == 5:
            f_val = struct.unpack("<f", bytes(val))[0]
        elif fno == 3 and wt == 0:
            i_val = _signed(val)
        elif fno == 4 and wt == 2:
            s_val = bytes(val)
        elif fno == 5 and wt == 2:
            t_val = _decode_tensor(val)[1]
        elif fno == 7:
            if wt == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
            else:
                floats.append(struct.unpack("<f", bytes(val))[0])
        elif fno == 8:
            if wt == 2:
                ints.extend(_packed_varints(val))
            else:
                ints.append(_signed(val))
        elif fno == 9 and wt == 2:
            strings.append(bytes(val))
        elif fno == 20 and wt == 0:
            atype = val
    # AttributeType: FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6 INTS=7 STRINGS=8
    if atype == 1 or (atype == 0 and f_val is not None):
        return OnnxAttr(name, f_val)
    if atype == 2 or (atype == 0 and i_val is not None):
        return OnnxAttr(name, i_val)
    if atype == 3 or (atype == 0 and s_val is not None):
        return OnnxAttr(name, s_val)
    if atype == 4 or (atype == 0 and t_val is not None):
        return OnnxAttr(name, t_val)
    if atype == 6 or floats:
        return OnnxAttr(name, list(floats))
    if atype == 7 or ints:
        return OnnxAttr(name, list(ints))
    if atype == 8 or strings:
        return OnnxAttr(name, strings)
    return OnnxAttr(name, None)


def _decode_node(view: memoryview) -> OnnxNode:
    node = OnnxNode("", [], [])
    for fno, wt, val in iter_fields(view):
        if fno == 1 and wt == 2:
            node.inputs.append(bytes(val).decode())
        elif fno == 2 and wt == 2:
            node.outputs.append(bytes(val).decode())
        elif fno == 3 and wt == 2:
            node.name = bytes(val).decode()
        elif fno == 4 and wt == 2:
            node.op_type = bytes(val).decode()
        elif fno == 5 and wt == 2:
            a = _decode_attr(val)
            node.attrs[a.name] = a.value
    return node


def _decode_value_info(view: memoryview) -> OnnxValueInfo:
    name = ""
    dtype = None
    shape: Optional[Tuple[Optional[int], ...]] = None
    for fno, wt, val in iter_fields(view):
        if fno == 1 and wt == 2:
            name = bytes(val).decode()
        elif fno == 2 and wt == 2:           # TypeProto
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1 and w2 == 2:      # tensor_type
                    dims: List[Optional[int]] = []
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 1 and w3 == 0:   # elem_type
                            dtype = ONNX_DTYPES.get(v3)
                        elif f3 == 2 and w3 == 2:  # shape
                            for f4, w4, v4 in iter_fields(v3):
                                if f4 == 1 and w4 == 2:  # dim
                                    dv: Optional[int] = None
                                    for f5, w5, v5 in iter_fields(v4):
                                        if f5 == 1 and w5 == 0:
                                            dv = _signed(v5)
                                    dims.append(dv)
                    shape = tuple(dims)
    return OnnxValueInfo(name, dtype, shape)


def read_onnx(path_or_bytes) -> OnnxModel:
    """Parse a .onnx file (or bytes) into an OnnxModel.

    Model files cross trust boundaries; every malformed input fails with
    :class:`OnnxParseError` — low-level decode errors (struct/unicode/
    numpy) never escape raw."""
    try:
        return _read_onnx(path_or_bytes)
    except OnnxParseError:
        raise
    except (struct.error, UnicodeDecodeError, ValueError, IndexError,
            KeyError, OverflowError, TypeError, MemoryError) as e:
        raise OnnxParseError(f"malformed onnx protobuf: {e}") from e


def _read_onnx(path_or_bytes) -> OnnxModel:
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        buf = memoryview(bytes(path_or_bytes))
    else:
        with open(path_or_bytes, "rb") as f:
            buf = memoryview(f.read())

    ir_version = 0
    opset = 0
    graph_view: Optional[memoryview] = None
    try:
        for fno, wt, val in iter_fields(buf):
            if fno == 1 and wt == 0:
                ir_version = val
            elif fno == 8 and wt == 2:       # opset_import
                for f2, w2, v2 in iter_fields(val):
                    if f2 == 2 and w2 == 0:
                        opset = max(opset, _signed(v2))
            elif fno == 7 and wt == 2:
                graph_view = val
    except OnnxParseError as e:
        raise OnnxParseError(f"not an ONNX protobuf: {e}") from None
    if graph_view is None:
        raise OnnxParseError("no GraphProto in model (field 7 missing) — "
                             "is this really an .onnx file?")

    nodes: List[OnnxNode] = []
    initializers: Dict[str, np.ndarray] = {}
    inputs: List[OnnxValueInfo] = []
    outputs: List[OnnxValueInfo] = []
    for fno, wt, val in iter_fields(graph_view):
        if fno == 1 and wt == 2:
            nodes.append(_decode_node(val))
        elif fno == 5 and wt == 2:
            name, arr = _decode_tensor(val)
            initializers[name] = arr
        elif fno == 11 and wt == 2:
            inputs.append(_decode_value_info(val))
        elif fno == 12 and wt == 2:
            outputs.append(_decode_value_info(val))

    # graph.input lists initializers too (pre-IR4 style); real runtime
    # inputs are the ones without initializer data
    inputs = [vi for vi in inputs if vi.name not in initializers]
    return OnnxModel(
        ir_version=ir_version,
        opset=opset,
        nodes=nodes,
        initializers=initializers,
        inputs=inputs,
        outputs=outputs,
    )
