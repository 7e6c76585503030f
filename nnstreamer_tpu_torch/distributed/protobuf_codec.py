"""Protobuf wire codec for tensor frames.

Port of ``nnstreamer_tpu/distributed/protobuf_codec.py``: the same
``nns_tensors.proto`` messages, byte for byte, written and parsed with
``struct`` instead of a protobuf runtime::

    message Tensor { string name = 1; TensorType type = 2;
                     repeated uint64 dimension = 3; bytes data = 4; }
    message TensorFrame { uint32 num_tensors = 1; repeated Tensor tensor = 2;
                          double pts = 3; uint64 seq = 4; string meta_json = 5; }

Encoding follows the protobuf runtime's: fields in number order, proto3
scalars left out at their zero value, ``dimension`` packed.  Decoding takes
any well-formed message as the runtime does (fields in any order; unknown
fields, and known ones of another wire type, skipped; packed or unpacked
dimensions; the last scalar winning); a message it would refuse raises
:class:`WireCorruptionError`.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Iterator, Tuple

import numpy as np

from ..core.buffer import TensorFrame
from ..core.types import BFLOAT16, RANK_LIMIT, TENSOR_COUNT_LIMIT
from .wire import WireCorruptionError, WireError, _clean_meta, host_arrays

_TO_PB = {
    "int32": 0, "uint32": 1, "int16": 2, "uint16": 3, "int8": 4,
    "uint8": 5, "float64": 6, "float32": 7, "int64": 8, "uint64": 9,
    "float16": 10, "bfloat16": 11,
}
_FROM_PB = {v: k for k, v in _TO_PB.items()}
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5  # wire types


def _np_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        if BFLOAT16 is None:
            raise WireError("a bfloat16 tensor needs ml_dtypes, which is not installed")
        return BFLOAT16
    return np.dtype(name)


def _varint(n: int) -> bytes:
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint(field << 3 | wire_type)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, _LEN) + _varint(len(payload)) + payload


def _tensor(arr: np.ndarray) -> bytes:
    name = str(arr.dtype)
    if name not in _TO_PB:
        raise WireError(f"dtype {name} not representable in nns_tensors.proto")
    out = b""
    if _TO_PB[name]:
        out += _key(2, _VARINT) + _varint(_TO_PB[name])
    if arr.ndim:
        out += _len_field(3, b"".join(_varint(d) for d in arr.shape))
    if arr.nbytes:
        out += _len_field(4, arr.tobytes())
    return out


def encode_frame(frame: TensorFrame) -> bytes:
    arrays = host_arrays(frame)
    parts = []
    if arrays:
        parts.append(_key(1, _VARINT) + _varint(len(arrays)))
    parts += [_len_field(2, _tensor(a)) for a in arrays]
    pts = struct.pack("<d", frame.pts if frame.pts is not None else math.nan)
    if pts != bytes(8):  # proto3 leaves out +0.0 (and only it)
        parts.append(_key(3, _I64) + pts)
    if frame.seq:
        parts.append(_key(4, _VARINT) + _varint(frame.seq & 0xFFFFFFFFFFFFFFFF))
    parts.append(_len_field(5, json.dumps(_clean_meta(frame.meta)).encode()))
    return b"".join(parts)


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        if off >= len(buf) or shift > 63:
            raise WireCorruptionError("malformed protobuf frame: bad varint")
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if b < 0x80:
            return n & 0xFFFFFFFFFFFFFFFF, off
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of every field of one message;
    a length-delimited value is its bytes, any other an int."""
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wt = key >> 3, key & 7
        if field == 0:
            raise WireCorruptionError("malformed protobuf frame: field number 0")
        if wt == _VARINT:
            value, off = _read_varint(buf, off)
        elif wt in (_I64, _I32):
            size = 8 if wt == _I64 else 4
            if off + size > len(buf):
                raise WireCorruptionError("malformed protobuf frame: truncated fixed field")
            value = int.from_bytes(buf[off:off + size], "little")
            off += size
        elif wt == _LEN:
            n, off = _read_varint(buf, off)
            if off + n > len(buf):
                raise WireCorruptionError("malformed protobuf frame: truncated field")
            value = buf[off:off + n]
            off += n
        else:
            raise WireCorruptionError(f"malformed protobuf frame: wire type {wt}")
        yield field, wt, value


def _text(raw: bytes) -> str:
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:  # proto3 strings must be valid UTF-8
        raise WireCorruptionError(f"malformed protobuf frame: {e}") from None


def _parse_tensor(buf: bytes):
    type_id, dims, data = 0, [], b""
    for field, wt, value in _fields(buf):
        if (field, wt) == (1, _LEN):
            _text(value)
        elif (field, wt) == (2, _VARINT):
            type_id = value - (1 << 64) if value >= 1 << 63 else value
            type_id = (type_id + (1 << 31)) % (1 << 32) - (1 << 31)  # an int32 enum
        elif (field, wt) == (3, _LEN):
            off = 0
            while off < len(value):
                d, off = _read_varint(value, off)
                dims.append(d)
        elif (field, wt) == (3, _VARINT):
            dims.append(value)
        elif (field, wt) == (4, _LEN):
            data = value
    return type_id, dims, data


def decode_frame(buf, verify: bool = True) -> TensorFrame:
    """``verify`` is accepted for the codec API (the schema has no
    checksum field): integrity here is structural validation only."""
    del verify
    buf = bytes(buf)
    raw_tensors, pts, seq, meta_json = [], 0.0, 0, ""
    for field, wt, value in _fields(buf):
        if (field, wt) == (2, _LEN):
            raw_tensors.append(_parse_tensor(value))
        elif (field, wt) == (3, _I64):
            pts = struct.unpack("<d", value.to_bytes(8, "little"))[0]
        elif (field, wt) == (4, _VARINT):
            seq = value
        elif (field, wt) == (5, _LEN):
            meta_json = _text(value)
    if len(raw_tensors) > TENSOR_COUNT_LIMIT:
        raise WireCorruptionError(
            f"tensor count {len(raw_tensors)} exceeds limit {TENSOR_COUNT_LIMIT}")
    tensors = []
    for type_id, dims, data in raw_tensors:
        if type_id not in _FROM_PB:
            raise WireCorruptionError(f"unknown tensor type id {type_id}")
        dtype = _np_dtype(_FROM_PB[type_id])
        if len(dims) > RANK_LIMIT:
            raise WireCorruptionError(f"rank {len(dims)} exceeds limit {RANK_LIMIT}")
        shape = tuple(dims)
        # math.prod: exact ints, where np.prod would wrap at int64
        expect = math.prod(shape) * dtype.itemsize if shape else dtype.itemsize
        if len(data) != expect:
            raise WireError(f"tensor payload {len(data)}B != shape {shape} x {dtype}")
        tensors.append(np.frombuffer(data, dtype=dtype).reshape(shape))
    try:
        meta = json.loads(meta_json) if meta_json else {}
    except ValueError as e:
        raise WireCorruptionError(f"malformed frame meta: {e}") from None
    if not isinstance(meta, dict):
        raise WireCorruptionError("frame meta is not a JSON object")
    frame = TensorFrame(tensors, pts=None if math.isnan(pts) else pts, meta=meta)
    frame.seq = seq
    return frame
