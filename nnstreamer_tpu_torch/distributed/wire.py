"""Wire serialization of tensor frames: the codec half of
``nnstreamer_tpu/distributed/wire.py``, byte for byte.

Frame layout (little-endian):

  v1: u32 magic 'NNSQ' | u16 version=1 | u64 seq | f64 pts (NaN = none) |
      u32 meta_len | meta JSON | u16 ntensors |
      per tensor: flex header | u64 payload_len | raw bytes

  v2: the same with version=2, and the fixed header grows a trailing u32
      CRC-32 (zlib) over the whole encoded frame with the crc field zeroed.

Batch envelope (wire micro-batching):

  v1: u32 magic 'NNSB' | u16 count | per frame: u64 len | NNSQ bytes
  v2: u32 magic 'NNSC' | u16 count | u32 crc | per frame: u64 len | bytes
      The batch crc covers the skeleton (the header with the crc zeroed and
      every u64 length prefix); each frame carries its own v2 checksum.

Decoding validates every declared size against hard limits and the buffer
before any allocation, and every malformed input raises a typed
:class:`WireError`: :class:`WireTruncationError` (the buffer ends before
its declared data) or :class:`WireCorruptionError` (checksum mismatch,
implausible or inconsistent fields).  v2 decoders accept v1 frames.
Payloads on the card come to the host through ``materialize``; decoded
tensors are read-only host views of the buffer.  Encoders hand out their
output as a list of buffers (``encode_frame_parts``,
``encode_frames_parts``) that a transport gather-sends with no payload
copy.
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib
from typing import Any, Dict

import numpy as np

from ..core.buffer import TensorFrame, materialize
from ..core.liveness import DEADLINE_META
from ..core.telemetry import TL_PREFIX
from ..core.tracer import META_SRC_TS
from ..core.types import (
    TENSOR_COUNT_LIMIT,
    FlexHeaderTruncated,
    TensorSpec,
    pack_flex_header,
    unpack_flex_header,
)

_MAGIC = 0x4E4E5351  # 'NNSQ'
V1 = 1
V2 = 2

#: hard cap on any declared body or payload length before allocation
MAX_BODY = 512 * 1024 * 1024
#: bound on the JSON meta blob inside one frame
MAX_META = 16 * 1024 * 1024

_HEAD1 = struct.Struct("<IHQdI")
_HEAD2 = struct.Struct("<IHQdII")  # v2: + u32 crc32 (over the frame, crc zeroed)
_MAGVER = struct.Struct("<IH")
_CRC_OFF = _HEAD1.size  # the crc field rides at the end of the v2 header
_ZERO4 = b"\x00\x00\x00\x00"
_NT = struct.Struct("<H")
_PLEN = struct.Struct("<Q")


def default_version() -> int:
    """The envelope version encoders use when none is given: v2, or v1
    with ``NNS_WIRE_V=1`` (decoders accept both)."""
    return V1 if os.environ.get("NNS_WIRE_V", "") == "1" else V2


class WireError(ValueError):
    """Base class of every malformed-wire-data condition."""


class WireCorruptionError(WireError):
    """Bytes parsed but cannot be trusted: checksum mismatch, bad magic, or
    inconsistent or implausible declared fields."""

    nns_transient = True  # a property of one transmission


class WireTruncationError(WireError):
    """The buffer ends before the data its headers declare."""

    nns_transient = True


def get_codec(name: str):
    """(encode, decode) for a wire IDL name: ``flex``/``nnsq`` (this
    module, the default), ``protobuf`` or ``flatbuf``.  Every decode takes
    ``verify=`` (only the flex codec has a checksum to check)."""
    if name in ("", "flex", "nnsq"):
        return encode_frame, decode_frame
    if name == "protobuf":
        from . import protobuf_codec

        return protobuf_codec.encode_frame, protobuf_codec.decode_frame
    if name == "flatbuf":
        from . import flatbuf_codec

        return flatbuf_codec.encode_frame, flatbuf_codec.decode_frame
    raise WireError(f"unknown wire idl {name!r} (flex|protobuf|flatbuf)")


def _clean_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    """The meta that crosses the wire: JSON-serializable entries that are
    not host-local instants (the deadline stamp, the tracer's source stamp
    and every trace-local telemetry key; only durations travel)."""
    out = {}
    for k, v in meta.items():
        if k in (DEADLINE_META, META_SRC_TS) or k.startswith(TL_PREFIX):
            continue
        try:
            json.dumps(v)
        except (TypeError, ValueError):
            continue  # non-serializable entries stay process-local
        out[k] = v
    return out


def host_arrays(frame: TensorFrame) -> list:
    """The frame's payloads as C-contiguous host arrays."""
    return [np.ascontiguousarray(a) for a in materialize(frame.tensors)]


def _check_version(version) -> int:
    version = int(version)
    if version not in (V1, V2):
        raise WireError(f"cannot encode wire version {version} (have 1|2)")
    return version


def encode_frame_parts(frame: TensorFrame, version: int = None) -> list:
    """One frame as a list of buffers with no payload copy: the payloads
    ride as memoryviews of the host arrays.  v2 (the default) computes its
    CRC in one pass over the parts."""
    version = default_version() if version is None else _check_version(version)
    meta = json.dumps(_clean_meta(frame.meta)).encode()
    pts = frame.pts if frame.pts is not None else math.nan
    head = (_HEAD2.pack(_MAGIC, V2, frame.seq, pts, len(meta), 0) if version == V2
            else _HEAD1.pack(_MAGIC, V1, frame.seq, pts, len(meta)))
    parts = [head, meta, _NT.pack(len(frame.tensors))]
    for arr in host_arrays(frame):
        parts.append(pack_flex_header(TensorSpec(tuple(arr.shape), arr.dtype)))
        parts.append(_PLEN.pack(arr.nbytes))
        parts.append(arr.reshape(-1).view(np.uint8).data)
    if version == V2:
        crc = 0
        for p in parts:
            crc = zlib.crc32(p, crc)
        parts[0] = _HEAD2.pack(_MAGIC, V2, frame.seq, pts, len(meta), crc)
    return parts


def parts_nbytes(parts) -> int:
    return sum(memoryview(p).nbytes for p in parts)


def _join(parts) -> bytes:
    return b"".join(p if isinstance(p, bytes) else bytes(p) for p in parts)


def encode_frame(frame: TensorFrame, version: int = None) -> bytes:
    return _join(encode_frame_parts(frame, version=version))


# -- multi-frame envelope (wire micro-batching) -------------------------------
_BMAGIC = 0x4E4E5342   # 'NNSB' (v1, no checksum)
_B2MAGIC = 0x4E4E5343  # 'NNSC' (v2, skeleton crc)
_BHEAD = struct.Struct("<IH")
_B2HEAD = struct.Struct("<IHI")
_BLEN = struct.Struct("<Q")


def encode_frames_parts(frames, version: int = None) -> list:
    """Several frames in ONE envelope, as gather parts with no payload
    copy.  v2 adds a skeleton CRC-32 (the batch header and every length
    prefix); the frames inside carry their own v2 checksums."""
    version = default_version() if version is None else _check_version(version)
    if version == V1:
        parts = [_BHEAD.pack(_BMAGIC, len(frames))]
        for f in frames:
            fparts = encode_frame_parts(f, version=V1)
            parts.append(_BLEN.pack(parts_nbytes(fparts)))
            parts.extend(fparts)
        return parts
    head0 = _B2HEAD.pack(_B2MAGIC, len(frames), 0)
    parts = [head0]
    crc = zlib.crc32(head0)
    for f in frames:
        fparts = encode_frame_parts(f, version=V2)
        blen = _BLEN.pack(parts_nbytes(fparts))
        crc = zlib.crc32(blen, crc)
        parts.append(blen)
        parts.extend(fparts)
    parts[0] = _B2HEAD.pack(_B2MAGIC, len(frames), crc)
    return parts


def encode_frames(frames, version: int = None) -> bytes:
    return _join(encode_frames_parts(frames, version=version))


def _need(have: int, off: int, n: int, what: str) -> None:
    """The bounds gate before every read of declared data."""
    if off + n > have:
        raise WireTruncationError(
            f"truncated: {what} needs {n} byte(s) at offset {off}, buffer has {have}")


def decode_frames(buf, verify: bool = True):
    """Inverse of :func:`encode_frames`: a list of frames.  Every entry
    length is checked against :data:`MAX_BODY` and the buffer before any
    slice; ``verify`` checks a v2 envelope's skeleton CRC first."""
    mv = memoryview(buf)
    total = len(mv)
    _need(total, 0, 4, "batch magic")
    (magic,) = struct.unpack_from("<I", mv, 0)
    if magic == _BMAGIC:
        _need(total, 0, _BHEAD.size, "batch header")
        _, count = _BHEAD.unpack_from(mv, 0)
        off = _BHEAD.size
        crc = None
    elif magic == _B2MAGIC:
        _need(total, 0, _B2HEAD.size, "batch header")
        _, count, crc = _B2HEAD.unpack_from(mv, 0)
        off = _B2HEAD.size
    else:
        raise WireCorruptionError(f"bad batch magic 0x{magic:08x}")

    def entries():
        """(index, offset of the frame, its length) with the bounds checks."""
        o = off
        for i in range(count):
            _need(total, o, _BLEN.size, f"batch entry {i} length")
            (blen,) = _BLEN.unpack_from(mv, o)
            if blen > MAX_BODY:
                raise WireCorruptionError(f"batch frame {i} declares {blen} bytes (cap {MAX_BODY})")
            _need(total, o + _BLEN.size, blen, f"batch frame {i}")
            yield o, o + _BLEN.size, blen
            o += _BLEN.size + blen

    if crc is not None and verify:
        actual = zlib.crc32(_B2HEAD.pack(_B2MAGIC, count, 0))
        for lo, _, _ in entries():
            actual = zlib.crc32(mv[lo:lo + _BLEN.size], actual)
        if actual != crc:
            raise WireCorruptionError(
                f"batch checksum mismatch (crc32 {actual:#010x} != declared {crc:#010x})")
    frames = []
    end = off
    for _, fo, blen in entries():
        frames.append(decode_frame(mv[fo:fo + blen], verify=verify))
        end = fo + blen
    if end != total:
        raise WireCorruptionError(f"{total - end} trailing byte(s) after batch envelope")
    return frames


def is_batch_payload(buf) -> bool:
    return len(buf) >= 4 and struct.unpack_from("<I", memoryview(buf), 0)[0] in (_BMAGIC, _B2MAGIC)


def frame_version(buf) -> int:
    """The envelope version of one encoded frame."""
    mv = memoryview(buf)
    _need(len(mv), 0, _MAGVER.size, "frame magic/version")
    magic, version = _MAGVER.unpack_from(mv, 0)
    if magic != _MAGIC:
        raise WireCorruptionError(f"bad frame magic 0x{magic:08x}")
    return version


def decode_frame(buf, verify: bool = True) -> TensorFrame:
    """Decode one frame (v1 or v2) with no payload copy; ``verify`` checks
    the v2 CRC first."""
    mv = memoryview(buf)
    have = len(mv)
    version = frame_version(mv)
    if version == V2:
        _need(have, 0, _HEAD2.size, "v2 frame header")
        _, _, seq, pts, meta_len, crc = _HEAD2.unpack_from(mv, 0)
        if verify:
            actual = zlib.crc32(mv[_HEAD2.size:], zlib.crc32(_ZERO4, zlib.crc32(mv[:_CRC_OFF])))
            if actual != crc:
                raise WireCorruptionError(
                    f"frame checksum mismatch (crc32 {actual:#010x} != declared {crc:#010x})")
        off = _HEAD2.size
    elif version == V1:
        _need(have, 0, _HEAD1.size, "frame header")
        _, _, seq, pts, meta_len = _HEAD1.unpack_from(mv, 0)
        off = _HEAD1.size
    else:  # a flipped bit in the version field evades the CRC
        raise WireCorruptionError(f"unsupported wire version {version}")
    if meta_len > MAX_META:
        raise WireCorruptionError(f"implausible meta length {meta_len} (cap {MAX_META})")
    _need(have, off, meta_len, "frame meta")
    meta = {}
    if meta_len:
        try:
            meta = json.loads(bytes(mv[off:off + meta_len]).decode())
        except (UnicodeDecodeError, ValueError) as e:
            raise WireCorruptionError(f"malformed frame meta: {e}") from None
        if not isinstance(meta, dict):
            raise WireCorruptionError("frame meta is not a JSON object")
    off += meta_len
    _need(have, off, _NT.size, "tensor count")
    (ntensors,) = _NT.unpack_from(mv, off)
    off += _NT.size
    if ntensors > TENSOR_COUNT_LIMIT:
        raise WireCorruptionError(f"tensor count {ntensors} exceeds limit {TENSOR_COUNT_LIMIT}")
    tensors = []
    for i in range(ntensors):
        try:
            spec, hlen = unpack_flex_header(mv[off:])
        except FlexHeaderTruncated as e:
            raise WireTruncationError(f"tensor {i}: {e}") from None
        except ValueError as e:
            raise WireCorruptionError(f"tensor {i}: {e}") from None
        off += hlen
        _need(have, off, _PLEN.size, f"tensor {i} payload length")
        (plen,) = _PLEN.unpack_from(mv, off)
        off += _PLEN.size
        if plen != spec.nbytes:  # corruption, checked before the buffer's length
            raise WireCorruptionError(
                f"tensor {i} payload {plen}B contradicts header {tuple(spec.shape)} x "
                f"{spec.dtype} ({spec.nbytes}B)")
        _need(have, off, plen, f"tensor {i} payload")
        # a read-only view of the receive buffer: an in-place transform
        # downstream cannot corrupt the other frames decoded from it
        arr = np.frombuffer(mv[off:off + plen], dtype=spec.dtype)
        arr.flags.writeable = False
        tensors.append(arr.reshape(spec.shape))
        off += plen
    if off != have:
        raise WireCorruptionError(f"{have - off} trailing byte(s) after frame")
    frame = TensorFrame(tensors, pts=None if math.isnan(pts) else pts, meta=meta)
    frame.seq = seq
    return frame
