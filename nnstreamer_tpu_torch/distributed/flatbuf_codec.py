"""FlatBuffers wire codec speaking the reference's ``nnstreamer.fbs``.

Port of ``nnstreamer_tpu/distributed/flatbuf_codec.py``: root table
``Tensors`` (``num_tensor``, an inline ``frame_rate`` struct, a vector of
``Tensor`` tables — name / type enum / uint32[16] dimension / ubyte data —
and a ``format`` enum).  The flatbuffers runtime is not needed: a small
builder here lays the buffer out as the runtime's ``Builder`` does
(back to front, each scalar aligned to its size from the buffer's end,
vtables shared when equal), so the bytes equal the JAX package's, and the
reader follows the runtime's generic ``Table`` accessors.

Schema limits: no pts, seq or meta on the wire (the reference's flatbuf
path drops buffer metadata too); dimensions ride innermost first, padded
to rank 16 with zeros.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..core.buffer import TensorFrame
from ..core.types import RANK_LIMIT as _REPO_RANK_LIMIT
from .wire import WireCorruptionError, WireError, host_arrays

_RANK_LIMIT = 16  # NNS_TENSOR_RANK_LIMIT (tensor_typedef.h:34)

# Tensor_type enum (nnstreamer.fbs): the indices are the wire contract
_TO_FB = {
    "int32": 0, "uint32": 1, "int16": 2, "uint16": 3, "int8": 4,
    "uint8": 5, "float64": 6, "float32": 7, "int64": 8, "uint64": 9,
}
_FROM_FB = {v: k for k, v in _TO_FB.items()}

# vtable slots in schema declaration order
_TENSOR_NAME, _TENSOR_TYPE, _TENSOR_DIM, _TENSOR_DATA = 0, 1, 2, 3
_TENSORS_NUM, _TENSORS_FR, _TENSORS_VEC, _TENSORS_FORMAT = 0, 1, 2, 3
_NNS_END = 10  # Tensor.type's schema default
_FORMAT_STATIC = 0  # Tensor_format enum
_U32_MAX = 0xFFFFFFFF


def _slot(i: int) -> int:
    """Slot index -> vtable byte offset (4 + 2*i)."""
    return 4 + 2 * i


class _Builder:
    """The subset of the flatbuffers ``Builder`` this schema needs.  The
    buffer grows at its front; an offset counts bytes from its end."""

    def __init__(self):
        self.buf = bytearray()
        self.minalign = 1
        self.vtable = None
        self.object_end = 0
        self.vtables = {}

    def offset(self) -> int:
        return len(self.buf)

    def prep(self, size: int, additional: int) -> None:
        """Align so that `size` bytes written after `additional` more land
        on a multiple of `size` from the end."""
        self.minalign = max(self.minalign, size)
        self.buf[:0] = bytes(-(len(self.buf) + additional) & (size - 1))

    def place(self, fmt: str, x) -> None:
        self.buf[:0] = struct.pack(fmt, x)

    def prepend(self, fmt: str, x) -> None:
        self.prep(struct.calcsize(fmt), 0)
        self.place(fmt, x)

    def prepend_uoffset(self, off: int) -> None:
        self.prep(4, 0)
        self.place("<I", self.offset() - off + 4)

    def _vector(self, payload: bytes, n: int, trailer: bytes = b"") -> int:
        self.prep(4, len(payload) + len(trailer))
        self.buf[:0] = payload + trailer
        self.place("<I", n)
        return self.offset()

    def string(self, s: str) -> int:
        x = s.encode()
        return self._vector(x, len(x), b"\x00")

    def byte_vector(self, x: bytes) -> int:
        return self._vector(x, len(x))

    def u32_vector(self, x: np.ndarray) -> int:
        return self._vector(x.astype("<u4").tobytes(), x.size)

    def start_vector(self, elem_size: int, n: int) -> None:
        self.prep(4, elem_size * n)

    def end_vector(self, n: int) -> int:
        self.place("<I", n)
        return self.offset()

    def start_object(self, nfields: int) -> None:
        self.vtable = [0] * nfields
        self.object_end = self.offset()

    def slot(self, i: int) -> None:
        self.vtable[i] = self.offset()

    def prepend_slot(self, fmt: str, i: int, x, default) -> None:
        if x != default:
            self.prepend(fmt, x)
            self.slot(i)

    def prepend_uoffset_slot(self, i: int, x: int, default: int) -> None:
        if x != default:
            self.prepend_uoffset(x)
            self.slot(i)

    def end_object(self) -> int:
        """Write the object's vtable (or share an equal earlier one)."""
        self.prep(4, 0)
        self.place("<i", 0)  # the vtable's soffset, set below
        obj = self.offset()
        fields = [obj - e if e else 0 for e in self.vtable]
        while fields and not fields[-1]:
            fields.pop()  # trailing absent fields are left out
        size = obj - self.object_end
        key = (*reversed(fields), size)
        shared = self.vtables.get(key)
        if shared is None:
            for f in reversed(fields):
                self.prepend("<H", f)
            self.prepend("<H", size)
            self.prepend("<H", (len(fields) + 2) * 2)
            shared = self.vtables[key] = self.offset()
        struct.pack_into("<i", self.buf, len(self.buf) - obj, shared - obj)
        self.vtable = None
        return obj

    def finish(self, root: int) -> bytes:
        self.prep(self.minalign, 4)
        self.prepend_uoffset(root)
        return bytes(self.buf)


def encode_frame(frame: TensorFrame) -> bytes:
    b = _Builder()
    tensor_offs = []
    for arr in host_arrays(frame):
        name = str(arr.dtype)
        if name not in _TO_FB:
            raise WireError(f"dtype {name} not representable in nnstreamer.fbs")
        if arr.ndim > _RANK_LIMIT:
            raise WireError(f"rank {arr.ndim} exceeds fbs limit {_RANK_LIMIT}")
        if 0 in arr.shape:  # 0 terminates the dimensions on this wire
            raise WireError(f"zero-size tensor shape {arr.shape} not representable in "
                            "nnstreamer.fbs")
        dims = np.zeros(_RANK_LIMIT, np.uint32)
        dims[:arr.ndim] = arr.shape[::-1]  # reference dialect: innermost first
        name_off = b.string(frame.meta.get("tensor_name", "") or "")
        dim_off = b.u32_vector(dims)
        data_off = b.byte_vector(arr.tobytes())
        b.start_object(4)
        b.prepend_uoffset_slot(_TENSOR_NAME, name_off, 0)
        b.prepend_slot("<i", _TENSOR_TYPE, _TO_FB[name], _NNS_END)
        b.prepend_uoffset_slot(_TENSOR_DIM, dim_off, 0)
        b.prepend_uoffset_slot(_TENSOR_DATA, data_off, 0)
        tensor_offs.append(b.end_object())
    b.start_vector(4, len(tensor_offs))
    for off in reversed(tensor_offs):
        b.prepend_uoffset(off)
    vec_off = b.end_vector(len(tensor_offs))
    rate_n, rate_d = _framerate_of(frame)
    b.start_object(4)
    b.prepend_slot("<i", _TENSORS_NUM, len(tensor_offs), 0)
    b.prep(4, 8)  # the frame_rate struct, inline in its table
    b.prepend("<i", rate_d)
    b.prepend("<i", rate_n)
    b.slot(_TENSORS_FR)
    b.prepend_uoffset_slot(_TENSORS_VEC, vec_off, 0)
    b.prepend_slot("<i", _TENSORS_FORMAT, _FORMAT_STATIC, 0)
    return b.finish(b.end_object())


def _framerate_of(frame: TensorFrame):
    fr = frame.meta.get("framerate")
    if isinstance(fr, (list, tuple)) and len(fr) == 2:
        try:
            return int(fr[0]), int(fr[1])
        except (TypeError, ValueError):
            pass
    return 0, 1


class _Table:
    """A table at `pos` of `buf`, read as the runtime's generic accessors
    read it (every position checked to be a uint32 first)."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = _u32(pos)

    def get(self, fmt: str, off: int):
        return struct.unpack_from(fmt, self.buf, _u32(off))[0]

    def offset(self, slot: int) -> int:
        vtable = self.pos - self.get("<i", self.pos)
        if slot < self.get("<H", vtable):
            return self.get("<H", vtable + slot)
        return 0

    def indirect(self, off: int) -> int:
        return _u32(off) + struct.unpack_from("<I", self.buf, off)[0]

    def string(self, off: int) -> bytes:
        off = self.indirect(off)
        n = struct.unpack_from("<I", self.buf, off)[0]
        return bytes(self.buf[off + 4:off + 4 + n])

    def vector(self, off: int) -> int:
        off = _u32(off) + self.pos
        return off + self.get("<I", off) + 4

    def vector_len(self, off: int) -> int:
        off = _u32(off) + self.pos
        return struct.unpack_from("<I", self.buf, off + struct.unpack_from("<I", self.buf, off)[0])[0]

    def numpy(self, dtype, off: int) -> np.ndarray:
        start = self.vector(off)
        return np.frombuffer(self.buf, dtype=dtype, count=self.vector_len(off), offset=start)


def _u32(n: int) -> int:
    if not 0 <= n <= _U32_MAX:
        raise TypeError(f"bad offset {n}")
    return n


def decode_frame(buf, verify: bool = True) -> TensorFrame:
    """``verify`` is accepted for the codec API; the schema has no checksum
    field (structural validation only)."""
    del verify
    data = buf if isinstance(buf, (bytes, bytearray)) else bytes(buf)
    try:
        tab = _Table(data, struct.unpack_from("<I", data, 0)[0])
        tensors, names = [], []
        o = tab.offset(_slot(_TENSORS_VEC))
        num_o = tab.offset(_slot(_TENSORS_NUM))
        n_declared = tab.get("<i", num_o + tab.pos) if num_o else 0
        if o:
            vec = tab.vector(o)
            for i in range(tab.vector_len(o)):
                tt = _Table(data, tab.indirect(vec + i * 4))
                to = tt.offset(_slot(_TENSOR_TYPE))
                type_id = tt.get("<i", to + tt.pos) if to else _NNS_END
                if type_id not in _FROM_FB:
                    raise WireError(f"unknown Tensor_type {type_id}")
                dtype = np.dtype(_FROM_FB[type_id])
                do = tt.offset(_slot(_TENSOR_DIM))
                dims = tt.numpy("<u4", do) if do else np.zeros(0, np.uint32)
                keep = []
                for d in dims:  # innermost first, zero-terminated
                    if d == 0:
                        break
                    keep.append(int(d))
                shape = tuple(reversed(keep))
                po = tt.offset(_slot(_TENSOR_DATA))
                payload = tt.numpy(np.uint8, po) if po else np.zeros(0, np.uint8)
                expect = math.prod(shape) * dtype.itemsize  # exact, where np.prod wraps
                if payload.nbytes != expect:
                    raise WireError(f"tensor payload {payload.nbytes}B != shape {shape} x {dtype}")
                if len(shape) > _REPO_RANK_LIMIT:
                    raise WireError(f"rank {len(shape)} over limit")
                tensors.append(payload.view(dtype).reshape(shape))
                no = tt.offset(_slot(_TENSOR_NAME))
                names.append(tt.string(no + tt.pos).decode() if no else "")
        if n_declared and n_declared != len(tensors):
            raise WireError(f"num_tensor={n_declared} != {len(tensors)} tensors present")
        fo = tab.offset(_slot(_TENSORS_FR))
        meta = {}
        if fo:
            rate_n = tab.get("<i", fo + tab.pos)
            rate_d = tab.get("<i", fo + tab.pos + 4)
            if rate_d:
                meta["framerate"] = [int(rate_n), int(rate_d)]
        name = next((n for n in names if n), "")
        if name:
            meta["tensor_name"] = name
    except WireError:
        raise
    except Exception as e:  # out-of-range offsets, short buffers, bad UTF-8
        raise WireCorruptionError(f"malformed flatbuffers frame: {e}") from None
    return TensorFrame(tensors, meta=meta)
