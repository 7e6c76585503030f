"""Tensor type system and stream-schema ("caps") negotiation.

Port of ``nnstreamer_tpu/core/types.py``, reduced to what the pipeline
and its elements need: per-tensor specs, stream specs, their
compatibility check and intersection, the schema strings of the
reference's dialect (``tensors,format=static,num=1,dimensions=3:224:224,
types=uint8``; dimensions innermost first), the dtype names, the
flexible-tensor header and the sparse payload encoding.  Shapes are numpy order (outermost first);
``None`` marks a flexible dimension.  dtypes are numpy dtypes: schemas
describe the host side of the stream, whatever device the tensors live on.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, replace
from fractions import Fraction
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

RANK_LIMIT = 16
TENSOR_COUNT_LIMIT = 256

_TYPE_NAMES = {
    name: np.dtype(name)
    for name in (
        "int8", "uint8", "int16", "uint16", "int32", "uint32", "int64",
        "uint64", "float16", "float32", "float64",
    )
}
try:  # numpy has no bfloat16 of its own; ml_dtypes adds it where installed
    import ml_dtypes

    _TYPE_NAMES["bfloat16"] = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover — the main path needs no bf16 schema
    pass

_NAME_BY_DTYPE = {v: k for k, v in _TYPE_NAMES.items()}

#: numpy's bfloat16 (``ml_dtypes``), or None where ml_dtypes is not installed
BFLOAT16: Optional[np.dtype] = _TYPE_NAMES.get("bfloat16")

FORMAT_STATIC = "static"
FORMAT_FLEXIBLE = "flexible"
FORMAT_SPARSE = "sparse"
FORMATS = (FORMAT_STATIC, FORMAT_FLEXIBLE, FORMAT_SPARSE)

DimsT = Tuple[Optional[int], ...]


def dtype_from_name(name: str) -> np.dtype:
    """Map a type name ("float32") to a numpy dtype."""
    key = name.strip().lower()
    if key not in _TYPE_NAMES:
        raise ValueError(f"unknown tensor element type: {name!r}")
    return _TYPE_NAMES[key]


def dtype_to_name(dtype) -> str:
    """Map a numpy dtype to its canonical name."""
    dt = np.dtype(dtype)
    if dt not in _NAME_BY_DTYPE:
        raise ValueError(f"unsupported tensor element type: {dtype!r}")
    return _NAME_BY_DTYPE[dt]


def parse_dims_string(text: str) -> DimsT:
    """A reference-dialect dimension string as a numpy-order shape:
    "3:224:224:1" (innermost first) is ``(1, 224, 224, 3)``; a 0, '?' or
    '*' component is a flexible dimension (``None``)."""
    parts = [p.strip() for p in text.strip().split(":") if p.strip() != ""]
    if not parts:
        raise ValueError(f"empty dimension string: {text!r}")
    if len(parts) > RANK_LIMIT:
        raise ValueError(f"rank {len(parts)} exceeds limit {RANK_LIMIT}")
    dims: list = []
    for p in parts:
        if p in ("?", "*"):
            dims.append(None)
            continue
        v = int(p)
        if v < 0:
            raise ValueError(f"negative dimension in {text!r}")
        dims.append(None if v == 0 else v)
    return tuple(reversed(dims))


def ref_dim_to_axis(ref_dim: int, rank: int) -> int:
    """A reference-dialect dimension index (innermost first) as a numpy
    axis, range-checked: the one owner of ``rank - 1 - dim`` for every
    element with a reference dim property (merge, split, aggregator,
    transform)."""
    axis = rank - 1 - int(ref_dim)
    if not 0 <= axis < rank:
        raise ValueError(f"dimension index {ref_dim} out of range for rank {rank}")
    return axis


def dims_to_string(shape: Sequence[Optional[int]]) -> str:
    """Innermost-first dimension string ("3:224:224"), the reference's
    dialect; 0 marks a flexible dimension."""
    return ":".join("0" if d is None else str(d) for d in reversed(tuple(shape)))


@dataclass(frozen=True)
class TensorSpec:
    """Static description of one tensor in a stream (name, dtype, dims)."""

    shape: DimsT
    dtype: np.dtype = np.dtype(np.float32)
    name: str = ""

    def __post_init__(self):
        norm = []
        for d in self.shape:
            if d is None:
                norm.append(None)
                continue
            if isinstance(d, bool) or not isinstance(d, (int, np.integer)) or int(d) <= 0:
                raise ValueError(f"bad dimension {d!r} in shape {tuple(self.shape)!r}")
            norm.append(int(d))
        object.__setattr__(self, "shape", tuple(norm))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        if len(self.shape) > RANK_LIMIT:
            raise ValueError(f"rank {len(self.shape)} exceeds limit {RANK_LIMIT}")
        if self.dtype not in _NAME_BY_DTYPE:
            raise ValueError(f"unsupported dtype {self.dtype!r}")

    @property
    def is_static(self) -> bool:
        return all(d is not None for d in self.shape)

    @property
    def num_elements(self) -> Optional[int]:
        """prod(dims); None if any dim is flexible."""
        if not self.is_static:
            return None
        return int(math.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> Optional[int]:
        """Bytes of one frame of this tensor; None if any dim is flexible."""
        n = self.num_elements
        return None if n is None else n * self.dtype.itemsize

    def is_compatible(self, other: "TensorSpec") -> bool:
        """True if a buffer described by `other` can flow where `self` is
        expected (flexible dims act as wildcards)."""
        if self.dtype != np.dtype(other.dtype) or len(self.shape) != len(other.shape):
            return False
        return all(a is None or b is None or a == b for a, b in zip(self.shape, other.shape))

    def intersect(self, other: "TensorSpec") -> Optional["TensorSpec"]:
        """The most specific common spec, or None if incompatible."""
        if not self.is_compatible(other):
            return None
        shape = tuple(a if a is not None else b for a, b in zip(self.shape, other.shape))
        return TensorSpec(shape, self.dtype, self.name or other.name)

    def to_string(self) -> str:
        return f"{dtype_to_name(self.dtype)}:{dims_to_string(self.shape)}"

    @classmethod
    def from_string(cls, text: str, name: str = "") -> "TensorSpec":
        """Parse "float32:3:224:224:1" (type:dims, reference dialect)."""
        head, _, rest = text.strip().partition(":")
        return cls(parse_dims_string(rest), dtype_from_name(head), name)

    def with_batch(self, batch: int) -> "TensorSpec":
        """Prepend a batch dimension."""
        return replace(self, shape=(batch,) + self.shape)


@dataclass(frozen=True)
class StreamSpec:
    """Schema of a tensor stream: N tensors per frame + format + rate."""

    tensors: Tuple[TensorSpec, ...] = ()
    fmt: str = FORMAT_STATIC
    framerate: Optional[Fraction] = None

    def __post_init__(self):
        object.__setattr__(self, "tensors", tuple(self.tensors))
        if self.fmt not in FORMATS:
            raise ValueError(f"unknown stream format {self.fmt!r}")
        if len(self.tensors) > TENSOR_COUNT_LIMIT:
            raise ValueError(f"{len(self.tensors)} tensors exceeds limit {TENSOR_COUNT_LIMIT}")
        if self.framerate is not None:
            object.__setattr__(self, "framerate", Fraction(self.framerate))

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    @property
    def is_static(self) -> bool:
        return self.fmt == FORMAT_STATIC and all(t.is_static for t in self.tensors)

    @property
    def is_any(self) -> bool:
        """A zero-tensor flexible schema is the wildcard (≙ ANY caps)."""
        return self.fmt == FORMAT_FLEXIBLE and not self.tensors

    def is_compatible(self, other: "StreamSpec") -> bool:
        if self.is_any or other.is_any:
            return True
        if self.fmt != other.fmt:
            return False
        if self.fmt != FORMAT_STATIC:
            return True
        if self.num_tensors != other.num_tensors:
            return False
        return all(a.is_compatible(b) for a, b in zip(self.tensors, other.tensors))

    def intersect(self, other: "StreamSpec") -> Optional["StreamSpec"]:
        """The most specific common schema, or None if incompatible."""
        if self.is_any:
            return other
        if other.is_any:
            return self
        if not self.is_compatible(other):
            return None
        if self.fmt != FORMAT_STATIC:
            return self
        merged = []
        for a, b in zip(self.tensors, other.tensors):
            m = a.intersect(b)
            if m is None:
                return None
            merged.append(m)
        fr = self.framerate if self.framerate is not None else other.framerate
        return StreamSpec(tuple(merged), self.fmt, fr)

    def to_string(self) -> str:
        """Reference-caps-like text, e.g.
        ``tensors,format=static,num=1,dimensions=3:224:224,types=uint8``."""
        parts = [f"tensors,format={self.fmt}", f"num={self.num_tensors}"]
        if self.tensors:
            parts.append("dimensions=" + ".".join(dims_to_string(t.shape) for t in self.tensors))
            parts.append("types=" + ".".join(dtype_to_name(t.dtype) for t in self.tensors))
        if self.framerate is not None:
            parts.append(f"framerate={self.framerate.numerator}/{self.framerate.denominator}")
        return ",".join(parts)

    @classmethod
    def from_string(cls, text: str) -> "StreamSpec":
        """Parse a ``tensors,...`` (or ``other/tensors,...``) schema string."""
        fields = {}
        head, *rest = [p.strip() for p in text.strip().split(",")]
        if head not in ("tensors", "other/tensors"):
            raise ValueError(f"not a tensors schema: {text!r}")
        for item in rest:
            k, _, v = item.partition("=")
            fields[k.strip()] = v.strip()
        fr = None
        if "framerate" in fields:
            n, _, d = fields["framerate"].partition("/")
            fr = Fraction(int(n), int(d or "1"))
        tensors: Tuple[TensorSpec, ...] = ()
        if "dimensions" in fields:
            dims = [parse_dims_string(s) for s in fields["dimensions"].split(".")]
            types = [dtype_from_name(s) for s in fields.get("types", "").split(".")]
            if len(dims) != len(types):
                raise ValueError("dimensions/types count mismatch")
            tensors = tuple(TensorSpec(d, t) for d, t in zip(dims, types))
        return cls(tensors, fields.get("format", FORMAT_STATIC), fr)

    def pick(self, indices: Iterable[int]) -> "StreamSpec":
        """Subset/reorder tensors (``input-combination`` semantics)."""
        return replace(self, tensors=tuple(self.tensors[i] for i in indices))


# Wildcard schema: matches anything (reference: ANY caps).
ANY = StreamSpec((), FORMAT_FLEXIBLE, None)


# Flexible-tensor self-describing header (the reference's
# GstTensorMetaInfo, one per memory of a format=flexible stream); the same
# bytes as the JAX package's.
_FLEX_MAGIC = 0x5450534E  # "NSPT"
_FLEX_VERSION = 1
# layout: magic u32 | version u32 | dtype-name-len u8 | rank u8 | pad u16 |
#         dims i32 * rank | dtype-name bytes
_FLEX_FIXED = struct.Struct("<IIBBH")


def pack_flex_header(spec: TensorSpec) -> bytes:
    """Serialize a per-tensor self-describing header (flexible streams)."""
    if not spec.is_static:
        raise ValueError("flex header requires concrete shape")
    name = dtype_to_name(spec.dtype).encode()
    head = _FLEX_FIXED.pack(_FLEX_MAGIC, _FLEX_VERSION, len(name), len(spec.shape), 0)
    dims = struct.pack(f"<{len(spec.shape)}i", *spec.shape) if spec.shape else b""
    return head + dims + name


class FlexHeaderTruncated(ValueError):
    """The header declares more bytes than the buffer holds (as against a
    corrupt header: bad magic, unknown dtype, absurd rank)."""


def unpack_flex_header(buf) -> Tuple[TensorSpec, int]:
    """Parse a flex header; returns (spec, header size).  Every declared
    size is checked against the limits and the buffer before use, so a
    corrupt header raises :class:`ValueError` (or
    :class:`FlexHeaderTruncated`), never ``struct.error``."""
    try:
        magic, version, nlen, rank, _ = _FLEX_FIXED.unpack_from(buf, 0)
    except struct.error:
        raise FlexHeaderTruncated(f"truncated flexible-tensor header: {len(buf)} byte(s), "
                                  f"need {_FLEX_FIXED.size}") from None
    if magic != _FLEX_MAGIC:
        raise ValueError("bad flexible-tensor header magic")
    if version != _FLEX_VERSION:
        raise ValueError(f"unsupported flex header version {version}")
    if rank > RANK_LIMIT:
        raise ValueError(f"flex header rank {rank} exceeds limit {RANK_LIMIT}")
    off = _FLEX_FIXED.size
    try:
        dims = struct.unpack_from(f"<{rank}i", buf, off) if rank else ()
    except struct.error:
        raise FlexHeaderTruncated("truncated flexible-tensor header: dims") from None
    off += 4 * rank
    name = bytes(buf[off:off + nlen])
    if len(name) != nlen:
        raise FlexHeaderTruncated("truncated flexible-tensor header: dtype name")
    dtype = dtype_from_name(name.decode())  # UnicodeDecodeError is a ValueError
    return TensorSpec(tuple(dims), dtype), off + nlen


def sparse_encode(dense: np.ndarray) -> Tuple[np.ndarray, np.ndarray, TensorSpec]:
    """A dense host array as (values, uint32 linear indices of its nonzeros)
    and its spec (the reference's sparse payload)."""
    flat = np.ascontiguousarray(dense).reshape(-1)
    idx = np.flatnonzero(flat).astype(np.uint32)
    return flat[idx], idx, TensorSpec(tuple(dense.shape), dense.dtype)


def sparse_decode(values: np.ndarray, indices: np.ndarray, spec: TensorSpec) -> np.ndarray:
    """Inverse of :func:`sparse_encode`."""
    if not spec.is_static:
        raise ValueError("sparse decode requires concrete spec")
    flat = np.zeros(spec.num_elements, dtype=spec.dtype)
    flat[indices.astype(np.int64)] = values.astype(spec.dtype, copy=False)
    return flat.reshape(spec.shape)
