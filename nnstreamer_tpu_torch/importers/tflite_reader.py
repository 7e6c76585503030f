"""TFLite flatbuffer reader: ``struct`` and numpy, no TensorFlow and no
``flatbuffers`` package.

Port of ``nnstreamer_tpu/importers/tflite_reader.py``.  The file is read
against the public TFLite schema (``tensorflow/lite/schema/schema.fbs``,
file identifier ``TFL3``): the vtable slot numbers below follow the
schema's field declaration order, which flatc assigns and TFLite's
compatibility guarantee freezes.  :class:`_Table` reads a table's fields
as the ``flatbuffers`` runtime's ``Table`` does (the same offsets, the same
range checks), so both packages give the same :class:`TFLiteModel` for a
file and refuse the same malformed ones, with :class:`TFLiteParseError`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

FILE_IDENTIFIER = b"TFL3"

# -- schema enums -------------------------------------------------------------

# TensorType (schema.fbs)
TENSOR_DTYPES = {
    0: "float32", 1: "float16", 2: "int32", 3: "uint8", 4: "int64",
    5: "string", 6: "bool", 7: "int16", 8: "complex64", 9: "int8",
    10: "float64", 11: "complex128", 12: "uint64", 13: "resource",
    14: "variant", 15: "uint32", 16: "uint16", 17: "int4",
}

# BuiltinOperator: the codes the lowering handles, and a few neighbours so
# the error for an unsupported model names its op
BUILTIN_OPS = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 5: "DEPTH_TO_SPACE", 6: "DEQUANTIZE",
    9: "FULLY_CONNECTED", 11: "L2_NORMALIZATION", 14: "LOGISTIC",
    17: "MAX_POOL_2D", 18: "MUL", 19: "RELU", 20: "RELU_N1_TO_1",
    21: "RELU6", 22: "RESHAPE", 23: "RESIZE_BILINEAR", 25: "SOFTMAX",
    26: "SPACE_TO_DEPTH", 28: "TANH", 32: "CUSTOM", 34: "PAD",
    36: "GATHER", 39: "TRANSPOSE", 40: "MEAN", 41: "SUB", 42: "DIV",
    43: "SQUEEZE", 45: "STRIDED_SLICE", 47: "EXP", 49: "SPLIT",
    53: "CAST", 54: "PRELU", 55: "MAXIMUM", 56: "ARG_MAX", 57: "MINIMUM",
    59: "NEG", 61: "GREATER", 65: "SLICE", 66: "SIN", 67: "TRANSPOSE_CONV",
    69: "TILE", 70: "EXPAND_DIMS", 71: "EQUAL", 73: "LOG", 74: "SUM",
    75: "SQRT", 76: "RSQRT", 77: "SHAPE", 78: "POW", 79: "ARG_MIN",
    81: "REDUCE_PROD", 82: "REDUCE_MAX", 83: "PACK", 88: "UNPACK",
    89: "REDUCE_MIN", 90: "FLOOR_DIV", 92: "SQUARE", 97: "RESIZE_NEAREST_NEIGHBOR",
    98: "LEAKY_RELU", 99: "SQUARED_DIFFERENCE", 100: "MIRROR_PAD",
    101: "ABS", 102: "SPLIT_V", 114: "QUANTIZE", 117: "HARD_SWISH",
    126: "BATCH_MATMUL", 130: "BROADCAST_TO", 145: "BROADCAST_ARGS",
}

PADDING = {0: "SAME", 1: "VALID"}
ACTIVATIONS = {0: None, 1: "relu", 2: "relu_n1_to_1", 3: "relu6",
               4: "tanh", 5: "sign_bit"}

# -- the flatbuffer access layer --------------------------------------------------

_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
_U16 = struct.Struct("<H")

#: scalar kinds: (struct, numpy dtype of a vector of them)
_KINDS = {
    "i8": (struct.Struct("<b"), np.dtype("<i1")),
    "u8": (struct.Struct("<B"), np.dtype("<u1")),
    "bool": (struct.Struct("<?"), np.dtype("<?")),
    "i32": (_I32, np.dtype("<i4")),
    "u32": (_U32, np.dtype("<u4")),
    "i64": (struct.Struct("<q"), np.dtype("<i8")),
    "f32": (struct.Struct("<f"), np.dtype("<f4")),
}


def _uoffset(off: int) -> int:
    """An offset must be a uoffset_t value (the runtime's ``enforce_number``)."""
    if not 0 <= off < 1 << 32:
        raise TypeError(f"offset {off} out of range")
    return off


class _Table:
    """One flatbuffer table at ``pos`` of ``buf``: the ``flatbuffers``
    runtime's ``Table`` accessors, on ``struct``."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos

    def _u32(self, off: int) -> int:
        return _U32.unpack_from(self.buf, _uoffset(off))[0]

    def offset(self, slot: int) -> int:
        """The field's offset from the table, 0 where it is absent."""
        vtable = self.pos - _I32.unpack_from(self.buf, _uoffset(self.pos))[0]
        vt = 4 + 2 * slot
        if vt < _U16.unpack_from(self.buf, _uoffset(vtable))[0]:
            return _U16.unpack_from(self.buf, _uoffset(vtable + vt))[0]
        return 0

    def scalar(self, slot: int, kind: str, default):
        o = self.offset(slot)
        if o == 0:
            return default
        return _KINDS[kind][0].unpack_from(self.buf, _uoffset(self.pos + o))[0]

    def string(self, slot: int) -> Optional[str]:
        o = self.offset(slot)
        if o == 0:
            return None
        off = self.pos + o
        off += self._u32(off)
        n = self._u32(off)
        return bytes(self.buf[off + 4:off + 4 + n]).decode("utf-8", "replace")

    def table(self, slot: int) -> Optional["_Table"]:
        o = self.offset(slot)
        if o == 0:
            return None
        off = self.pos + o
        return _Table(self.buf, off + self._u32(off))

    def _vector(self, o: int) -> Tuple[int, int]:
        """(first element, length) of the vector at field offset ``o``."""
        off = self.pos + o
        off += self._u32(off)
        return off + 4, self._u32(off)

    def vec_np(self, slot: int, kind: str) -> np.ndarray:
        dtype = _KINDS[kind][1]
        o = self.offset(slot)
        if o == 0:
            return np.zeros(0, dtype)
        start, n = self._vector(o)
        return np.frombuffer(self.buf, dtype=dtype, count=n, offset=start)

    def vec_tables(self, slot: int) -> List["_Table"]:
        o = self.offset(slot)
        if o == 0:
            return []
        start, n = self._vector(o)
        if n * 4 > len(self.buf):
            # a table-offset vector cannot outnumber the file's bytes / 4: a
            # corrupted count must not drive a near-endless loop
            raise TFLiteParseError(f"corrupt vector length {n}")
        return [_Table(self.buf, start + 4 * j + self._u32(start + 4 * j)) for j in range(n)]

    def vec_bytes(self, slot: int) -> Optional[memoryview]:
        """A [ubyte] vector as a view into the file's bytes."""
        o = self.offset(slot)
        if o == 0:
            return None
        start, n = self._vector(o)
        return memoryview(self.buf)[start:start + n]


class _EmptyTable:
    """An omitted options table: every field reads as absent, so the
    decoders give the schema's defaults."""

    def offset(self, slot):
        return 0

    def scalar(self, slot, kind, default):
        return default

    def vec_np(self, slot, kind):
        return np.zeros(0, _KINDS[kind][1])


_EMPTY_TABLE = _EmptyTable()

# -- the parsed model ---------------------------------------------------------------


@dataclass
class QuantParams:
    scale: np.ndarray          # per tensor (length 1) or per channel
    zero_point: np.ndarray
    quantized_dimension: int = 0

    @property
    def per_channel(self) -> bool:
        return self.scale.size > 1


@dataclass
class TFLTensor:
    index: int
    name: str
    shape: Tuple[int, ...]
    dtype: str
    buffer: int
    quant: Optional[QuantParams] = None
    data: Optional[np.ndarray] = None   # constant data (None for activations)

    @property
    def is_const(self) -> bool:
        return self.data is not None


@dataclass
class TFLOp:
    opcode: str
    inputs: List[int]           # tensor indices; -1 = optional, absent
    outputs: List[int]
    options: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TFLiteModel:
    version: int
    description: str
    tensors: List[TFLTensor]
    inputs: List[int]
    outputs: List[int]
    ops: List[TFLOp]

    def op_histogram(self) -> Dict[str, int]:
        h: Dict[str, int] = {}
        for op in self.ops:
            h[op.opcode] = h.get(op.opcode, 0) + 1
        return h


# -- options ------------------------------------------------------------------------
# Each decoder maps an options table to the fields the lowering reads; the
# slots are each options table's declaration order in the schema.

def _opt_conv2d(t) -> Dict[str, Any]:
    return {
        "padding": PADDING[t.scalar(0, "i8", 0)],
        "stride_w": t.scalar(1, "i32", 1) or 1,
        "stride_h": t.scalar(2, "i32", 1) or 1,
        "activation": ACTIVATIONS.get(t.scalar(3, "i8", 0)),
        "dilation_w": t.scalar(4, "i32", 1) or 1,
        "dilation_h": t.scalar(5, "i32", 1) or 1,
    }


def _opt_depthwise(t) -> Dict[str, Any]:
    return {
        "padding": PADDING[t.scalar(0, "i8", 0)],
        "stride_w": t.scalar(1, "i32", 1) or 1,
        "stride_h": t.scalar(2, "i32", 1) or 1,
        "depth_multiplier": t.scalar(3, "i32", 1) or 1,
        "activation": ACTIVATIONS.get(t.scalar(4, "i8", 0)),
        "dilation_w": t.scalar(5, "i32", 1) or 1,
        "dilation_h": t.scalar(6, "i32", 1) or 1,
    }


def _opt_pool2d(t) -> Dict[str, Any]:
    return {
        "padding": PADDING[t.scalar(0, "i8", 0)],
        "stride_w": t.scalar(1, "i32", 1) or 1,
        "stride_h": t.scalar(2, "i32", 1) or 1,
        "filter_w": t.scalar(3, "i32", 1) or 1,
        "filter_h": t.scalar(4, "i32", 1) or 1,
        "activation": ACTIVATIONS.get(t.scalar(5, "i8", 0)),
    }


def _opt_fully_connected(t) -> Dict[str, Any]:
    return {
        "activation": ACTIVATIONS.get(t.scalar(0, "i8", 0)),
        "weights_format": t.scalar(1, "i8", 0),
        "keep_num_dims": bool(t.scalar(2, "bool", 0)),
    }


def _opt_softmax(t) -> Dict[str, Any]:
    return {"beta": t.scalar(0, "f32", 1.0) or 1.0}


def _opt_activation_only(t) -> Dict[str, Any]:
    return {"activation": ACTIVATIONS.get(t.scalar(0, "i8", 0))}


def _opt_reshape(t) -> Dict[str, Any]:
    return {"new_shape": t.vec_np(0, "i32").tolist()}


def _opt_concat(t) -> Dict[str, Any]:
    return {"axis": t.scalar(0, "i32", 0),
            "activation": ACTIVATIONS.get(t.scalar(1, "i8", 0))}


def _opt_reducer(t) -> Dict[str, Any]:
    return {"keep_dims": bool(t.scalar(0, "bool", 0))}


def _opt_strided_slice(t) -> Dict[str, Any]:
    return {
        "begin_mask": t.scalar(0, "i32", 0),
        "end_mask": t.scalar(1, "i32", 0),
        "ellipsis_mask": t.scalar(2, "i32", 0),
        "new_axis_mask": t.scalar(3, "i32", 0),
        "shrink_axis_mask": t.scalar(4, "i32", 0),
    }


def _opt_resize_bilinear(t) -> Dict[str, Any]:
    return {"align_corners": bool(t.scalar(2, "bool", 0)),
            "half_pixel_centers": bool(t.scalar(3, "bool", 0))}


def _opt_resize_nearest(t) -> Dict[str, Any]:
    return {"align_corners": bool(t.scalar(0, "bool", 0)),
            "half_pixel_centers": bool(t.scalar(1, "bool", 0))}


def _opt_leaky_relu(t) -> Dict[str, Any]:
    return {"alpha": t.scalar(0, "f32", 0.0)}


def _opt_pack(t) -> Dict[str, Any]:
    return {"values_count": t.scalar(0, "i32", 0), "axis": t.scalar(1, "i32", 0)}


def _opt_unpack(t) -> Dict[str, Any]:
    return {"num": t.scalar(0, "i32", 0), "axis": t.scalar(1, "i32", 0)}


def _opt_gather(t) -> Dict[str, Any]:
    return {"axis": t.scalar(0, "i32", 0), "batch_dims": t.scalar(1, "i32", 0)}


def _opt_arg_minmax(t) -> Dict[str, Any]:
    return {"output_type": TENSOR_DTYPES.get(t.scalar(0, "i8", 4), "int64")}


def _opt_split(t) -> Dict[str, Any]:
    return {"num_splits": t.scalar(0, "i32", 0)}


def _opt_squeeze(t) -> Dict[str, Any]:
    return {"squeeze_dims": t.vec_np(0, "i32").tolist()}


def _opt_cast(t) -> Dict[str, Any]:
    return {"in_dtype": TENSOR_DTYPES.get(t.scalar(0, "i8", 0)),
            "out_dtype": TENSOR_DTYPES.get(t.scalar(1, "i8", 0))}


def _opt_space_depth(t) -> Dict[str, Any]:
    return {"block_size": t.scalar(0, "i32", 0)}


def _opt_mirror_pad(t) -> Dict[str, Any]:
    return {"mode": {0: "reflect", 1: "symmetric"}[t.scalar(0, "i8", 0)]}


def _opt_transpose_conv(t) -> Dict[str, Any]:
    return {
        "padding": PADDING[t.scalar(0, "i8", 0)],
        "stride_w": t.scalar(1, "i32", 1) or 1,
        "stride_h": t.scalar(2, "i32", 1) or 1,
        "activation": ACTIVATIONS.get(t.scalar(3, "i8", 0)),
    }


def _opt_shape(t) -> Dict[str, Any]:
    return {"out_dtype": TENSOR_DTYPES.get(t.scalar(0, "i8", 2), "int32")}


# opcode name -> options decoder (the schema fixes which BuiltinOptions
# member goes with each op, so the opcode picks the decoder)
_OPT_DECODERS = {
    "CONV_2D": _opt_conv2d,
    "DEPTHWISE_CONV_2D": _opt_depthwise,
    "AVERAGE_POOL_2D": _opt_pool2d,
    "MAX_POOL_2D": _opt_pool2d,
    "FULLY_CONNECTED": _opt_fully_connected,
    "SOFTMAX": _opt_softmax,
    "ADD": _opt_activation_only,
    "SUB": _opt_activation_only,
    "MUL": _opt_activation_only,
    "DIV": _opt_activation_only,
    "L2_NORMALIZATION": _opt_activation_only,
    "RESHAPE": _opt_reshape,
    "CONCATENATION": _opt_concat,
    "MEAN": _opt_reducer,
    "SUM": _opt_reducer,
    "REDUCE_MAX": _opt_reducer,
    "REDUCE_MIN": _opt_reducer,
    "REDUCE_PROD": _opt_reducer,
    "STRIDED_SLICE": _opt_strided_slice,
    "RESIZE_BILINEAR": _opt_resize_bilinear,
    "RESIZE_NEAREST_NEIGHBOR": _opt_resize_nearest,
    "LEAKY_RELU": _opt_leaky_relu,
    "PACK": _opt_pack,
    "UNPACK": _opt_unpack,
    "GATHER": _opt_gather,
    "ARG_MAX": _opt_arg_minmax,
    "ARG_MIN": _opt_arg_minmax,
    "SPLIT": _opt_split,
    "SQUEEZE": _opt_squeeze,
    "CAST": _opt_cast,
    "SPACE_TO_DEPTH": _opt_space_depth,
    "DEPTH_TO_SPACE": _opt_space_depth,
    "MIRROR_PAD": _opt_mirror_pad,
    "TRANSPOSE_CONV": _opt_transpose_conv,
    "SHAPE": _opt_shape,
}


# -- the parse ----------------------------------------------------------------------

class TFLiteParseError(ValueError):
    pass


def _parse_quant(t: Optional[_Table]) -> Optional[QuantParams]:
    if t is None:
        return None
    scale = t.vec_np(2, "f32")
    zp = t.vec_np(3, "i64")
    if scale.size == 0:
        return None
    if zp.size == 0:
        zp = np.zeros_like(scale, dtype=np.int64)
    return QuantParams(scale=scale.astype(np.float32), zero_point=zp.astype(np.int64),
                       quantized_dimension=t.scalar(6, "i32", 0))


def read_tflite(path_or_bytes, subgraph: int = 0) -> TFLiteModel:
    """Parse a .tflite file (or its bytes) into a :class:`TFLiteModel`.

    Model files cross trust boundaries: every malformed input fails with
    :class:`TFLiteParseError`; low-level decode errors never escape raw."""
    try:
        return _read_tflite(path_or_bytes, subgraph)
    except TFLiteParseError:
        raise
    except (TypeError, ValueError, IndexError, KeyError, OverflowError,
            UnicodeDecodeError, MemoryError, struct.error) as e:
        raise TFLiteParseError(f"malformed tflite flatbuffer: {e}") from e


def _read_tflite(path_or_bytes, subgraph: int = 0) -> TFLiteModel:
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    if len(buf) < 8:
        raise TFLiteParseError("file too small to be a tflite flatbuffer")
    if buf[4:8] != FILE_IDENTIFIER:
        raise TFLiteParseError(
            f"bad file identifier {buf[4:8]!r} (expected {FILE_IDENTIFIER!r})")

    root = _Table(buf, _U32.unpack_from(buf, 0)[0])
    version = root.scalar(0, "u32", 0)

    # operator_codes: newer files put the code in the int32 `builtin_code`
    # (slot 3) and clamp the legacy int8 field (slot 0) at 127; the larger
    # of the two is the schema's rule
    opcodes: List[str] = []
    for oc in root.vec_tables(1):
        code = max(int(oc.scalar(0, "i8", 0)), int(oc.scalar(3, "i32", 0)))
        name = BUILTIN_OPS.get(code, f"BUILTIN_{code}")
        if name == "CUSTOM":
            name = f"CUSTOM:{oc.string(1) or '?'}"
        opcodes.append(name)

    buffers = root.vec_tables(4)
    subgraphs = root.vec_tables(2)
    if not subgraphs:
        raise TFLiteParseError("model has no subgraphs")
    if subgraph >= len(subgraphs):
        raise TFLiteParseError(f"subgraph {subgraph} out of range ({len(subgraphs)} present)")
    sg = subgraphs[subgraph]

    tensors: List[TFLTensor] = []
    for i, tt in enumerate(sg.vec_tables(0)):
        shape = tuple(int(x) for x in tt.vec_np(0, "i32"))
        dtype_code = tt.scalar(1, "i8", 0)
        dtype = TENSOR_DTYPES.get(dtype_code)
        if dtype is None:
            raise TFLiteParseError(f"tensor {i}: unknown TensorType code {dtype_code}")
        buf_idx = tt.scalar(2, "u32", 0)
        data = None
        if 0 < buf_idx < len(buffers):
            raw = buffers[buf_idx].vec_bytes(0)
            if raw is not None and len(raw) > 0:
                if dtype in ("string", "resource", "variant"):
                    raise TFLiteParseError(f"tensor {i}: unsupported constant dtype {dtype}")
                arr = np.frombuffer(raw, dtype=np.dtype(dtype))
                data = arr.reshape(shape) if shape else arr.reshape(())
        tensors.append(TFLTensor(
            index=i, name=tt.string(3) or f"t{i}", shape=shape, dtype=dtype,
            buffer=buf_idx, quant=_parse_quant(tt.table(4)), data=data))

    ops: List[TFLOp] = []
    for ot in sg.vec_tables(3):
        idx = ot.scalar(0, "u32", 0)
        if idx >= len(opcodes):
            raise TFLiteParseError(f"opcode index {idx} out of range")
        name = opcodes[idx]
        decoder = _OPT_DECODERS.get(name)
        options: Dict[str, Any] = {}
        if decoder is not None:
            opt_table = ot.table(4)
            options = decoder(opt_table if opt_table is not None else _EMPTY_TABLE)
        ops.append(TFLOp(opcode=name, inputs=[int(x) for x in ot.vec_np(1, "i32")],
                         outputs=[int(x) for x in ot.vec_np(2, "i32")], options=options))

    return TFLiteModel(
        version=version, description=root.string(3) or "", tensors=tensors,
        inputs=[int(x) for x in sg.vec_np(1, "i32")],
        outputs=[int(x) for x in sg.vec_np(2, "i32")], ops=ops)
