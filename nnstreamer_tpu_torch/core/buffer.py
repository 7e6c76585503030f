"""Stream payload and event objects.

Port of ``nnstreamer_tpu/core/buffer.py``: ``TensorFrame`` (N tensors +
timestamps + meta), ``BatchFrame`` (a micro-batch travelling as one stream
item), the in-band events, the asynchronous device-to-host copies of the
filter's dispatch window (:func:`start_host_copies`, :class:`HostCopy`)
and the staging-buffer pool of its ingest lane (:class:`DeviceBufferPool`).
Payloads are numpy arrays or ``torch.Tensor``s; a filter keeps its outputs
on its device (``BatchFrame.split`` keeps them there too) and only
:func:`materialize` (sinks, decoders, the window's reaper) brings them to
the host.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .types import BFLOAT16, StreamSpec

_seq = itertools.count()


def _is_torch(t: Any) -> bool:
    return type(t).__module__.split(".")[0] == "torch"


def to_numpy(t: Any) -> np.ndarray:
    """A torch tensor as a host numpy array, copied through ``Tensor.cpu()``,
    which waits for the work producing it.  bfloat16, which numpy lacks,
    becomes an ``ml_dtypes.bfloat16`` array through an int16 view, as the
    JAX package's host arrays are; without ml_dtypes that raises TypeError."""
    t = t.detach().cpu()
    if str(t.dtype) != "torch.bfloat16":
        return t.numpy()
    if BFLOAT16 is None:
        raise TypeError("a bfloat16 tensor reaches the host as a numpy array only through "
                        "ml_dtypes, which is not installed")
    import torch

    return t.view(torch.int16).numpy().view(BFLOAT16)


class HostCopy:
    """One tensor's device-to-host copy, started and not yet waited on: a
    pinned host tensor and the CUDA event recorded after the copy on the
    stream that produced the tensor.  A CPU tensor is its own copy, already
    complete (``event`` None)."""

    __slots__ = ("host", "event")

    def __init__(self, host: Any, event: Any = None):
        self.host = host
        self.event = event

    @classmethod
    def start(cls, t: Any) -> "HostCopy":
        """Issue ``t``'s copy on the stream current for its device, right
        behind the work producing it, into fresh pinned memory (PyTorch's
        caching host allocator reuses it once every view of it is gone)."""
        if t.device.type != "cuda":
            return cls(t.detach())
        import torch

        stream = torch.cuda.current_stream(t.device)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t.detach(), non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
        return cls(host, event)

    def result(self) -> np.ndarray:
        """The host array, once the copy has landed (blocks on the event,
        not on the stream or the device)."""
        if self.event is not None:
            self.event.synchronize()
        return to_numpy(self.host)


def start_host_copies(tensors: Sequence[Any]) -> List[Any]:
    """Start the device-to-host copy of every torch tensor (a
    :class:`HostCopy` takes its place in the returned list).  Any other
    payload with a ``copy_to_host_async`` method gets that called as a
    prefetch hint and stays.  The filter's dispatch window calls this at
    park time, so the copy queues right behind the batch's launches and
    its reaper thread only waits for it."""
    out = []
    for t in tensors:
        if _is_torch(t):
            out.append(HostCopy.start(t))
            continue
        start = getattr(t, "copy_to_host_async", None)
        if start is not None:
            start()
        out.append(t)
    return out


def materialize(tensors: Sequence[Any]) -> List[np.ndarray]:
    """Bring a tensor list to host numpy arrays: a started
    :class:`HostCopy` is waited on, a torch tensor goes through
    :func:`to_numpy`, anything else through ``np.asarray``."""
    return [
        t.result() if isinstance(t, HostCopy) else to_numpy(t) if _is_torch(t) else np.asarray(t)
        for t in tensors
    ]


def _torch_pieces(tensors: Sequence[Any]) -> List[Any]:
    """Every piece as a torch tensor on the device of the first torch piece
    (a host array joins the device tensors, never the other way round)."""
    import torch

    dev = next(t.device for t in tensors if _is_torch(t))
    return [t if _is_torch(t) else torch.as_tensor(np.asarray(t), device=dev) for t in tensors]


def concat_tensors(tensors: Sequence[Any], axis: int) -> Any:
    """Concatenate along `axis`: ``torch.cat`` on the device when any piece
    is a torch tensor, ``np.concatenate`` otherwise."""
    if any(_is_torch(t) for t in tensors):
        import torch

        return torch.cat(_torch_pieces(tensors), dim=axis)
    return np.concatenate([np.asarray(t) for t in tensors], axis=axis)


def stack_tensors(tensors: Sequence[Any]) -> Any:
    """Stack on a new leading axis: ``torch.stack`` on the device when any
    piece is a torch tensor, ``np.stack`` otherwise."""
    if any(_is_torch(t) for t in tensors):
        import torch

        return torch.stack(_torch_pieces(tensors))
    return np.stack([np.asarray(t) for t in tensors])


def as_array(t: Any) -> Any:
    """A torch tensor as it is, anything else as a numpy array."""
    return t if _is_torch(t) else np.asarray(t)


@dataclass
class TensorFrame:
    """One frame of a tensor stream: N tensors + timestamps + metadata."""

    tensors: List[Any]
    pts: Optional[float] = None
    duration: Optional[float] = None
    meta: Dict[str, Any] = field(default_factory=dict)
    seq: int = field(default_factory=lambda: next(_seq))

    def with_tensors(self, tensors: Sequence[Any]) -> "TensorFrame":
        """New frame with the same timestamps, COPIED meta, another payload
        (decoders stamp keys into the copy, never into a shared dict)."""
        return replace(self, tensors=list(tensors), meta=dict(self.meta))

    def pick(self, indices: Sequence[int]) -> "TensorFrame":
        """Subset/reorder the tensors (tensorpick), meta copied."""
        return self.with_tensors([self.tensors[i] for i in indices])

    def to_host(self) -> "TensorFrame":
        """All payloads as numpy arrays; host frames return self."""
        if all(type(t) is np.ndarray for t in self.tensors):
            return self
        return self.with_tensors(materialize(self.tensors))


@dataclass
class BatchFrame(TensorFrame):
    """A micro-batch travelling as ONE stream item: every tensor has a
    leading batch axis; ``frames_info`` keeps the per-logical-frame
    (pts, duration, meta) so the batch splits back losslessly.  Made by
    ``AppSrc.push_block`` and by tensor_filter in batch-through mode."""

    frames_info: List[Tuple[Optional[float], Optional[float], Dict[str, Any]]] = field(
        default_factory=list
    )

    @property
    def batch_size(self) -> int:
        return len(self.frames_info)

    @classmethod
    def from_frames(cls, tensors: Sequence[Any], frames: Sequence[TensorFrame]) -> "BatchFrame":
        """A batch of `tensors` (leading axis = frame) carrying the pts,
        duration and meta of each of `frames`."""
        first = frames[0]
        return cls(tensors=list(tensors), pts=first.pts, duration=first.duration,
                   meta=dict(first.meta), frames_info=[(f.pts, f.duration, f.meta) for f in frames])

    def split(self) -> List[TensorFrame]:
        """Fan back out into per-frame views.  A torch tensor stays where it
        lives (row views on its own device); a started :class:`HostCopy`
        and any other payload come to the host through :func:`materialize`.
        Call ``to_host()`` first for host rows from one copy per tensor."""
        mats = [t if _is_torch(t) else materialize([t])[0] for t in self.tensors]
        return [
            TensorFrame([m[b] for m in mats], pts=p, duration=d, meta=dict(fm))
            for b, (p, d, fm) in enumerate(self.frames_info)
        ]


class Event:
    """Base class for in-band stream events (≙ GstEvent)."""

    __slots__ = ()

    def __repr__(self):
        return f"<{type(self).__name__}>"


class EOS(Event):
    """End of stream: no more frames will follow (≙ GST_EVENT_EOS)."""


@dataclass(repr=True)
class CapsEvent(Event):
    """Announce the downstream schema (≙ GST_EVENT_CAPS)."""

    spec: StreamSpec = field(default_factory=StreamSpec)


class Flush(Event):
    """Drop queued data, reset element state (≙ FLUSH_START/STOP)."""


# ---------------------------------------------------------------------------
# Staging-buffer pool (the ingest lane's zero-allocation steady state)
# ---------------------------------------------------------------------------
def _is_cuda_placement(placement) -> bool:
    return isinstance(placement, tuple) and len(placement) > 1 and placement[1] == "cuda"


class DeviceBufferPool:
    """Free-list of STAGING buffers keyed by ``(shape, dtype, placement)``.

    The ingest lane stacks every micro-batch into a host staging buffer
    before the host-to-device copy; allocating it per batch is a steady
    hidden cost (a 128x224x224x3 uint8 batch is 19 MB of fresh pages per
    invoke), and a pageable buffer makes the copy synchronous.  The pool
    keeps a small ring per key, so steady-state serving reuses the same
    buffers.

    Buffers are numpy arrays.  For a CUDA placement (``("dev", "cuda",
    index)``, ``FilterBackend.staging_placement()``) each one is the numpy
    view of a PINNED torch tensor, so ``np.stack(..., out=buf)`` writes
    straight into page-locked memory and the copy to the card can run
    asynchronously; any other placement gets plain numpy.

    Ownership contract: a buffer acquired here is exclusively the caller's
    until ``release()``; release only when nothing can still read the
    memory (the lane releases after ``to_device`` returned, which copies
    off the buffer first).  The placement token joins the ring key, so a
    buffer staged for one device is never handed to a caller staging for
    another; pass the same token to ``release`` as to ``acquire``.

    The ring dict is LRU-bounded at ``MAX_KEYS`` keys (``rings_evicted``
    counts the rings dropped).  Thread-safe; ``allocated``/``reused`` are
    exact under the lock."""

    __slots__ = ("_free", "_lock", "_max_per_key",
                 "allocated", "reused", "rings_evicted")

    #: max distinct (shape, dtype, placement) rings kept live (LRU)
    MAX_KEYS = 32

    def __init__(self, max_per_key: int = 8):
        self._free: "OrderedDict[Tuple, List[np.ndarray]]" = OrderedDict()
        self._lock = threading.Lock()
        self._max_per_key = max(0, max_per_key)
        self.allocated = 0
        self.reused = 0
        self.rings_evicted = 0

    @staticmethod
    def _key(shape, dtype, placement=None) -> Tuple:
        return (tuple(int(d) for d in shape), np.dtype(dtype).str, placement)

    @staticmethod
    def _new(shape, dtype, placement) -> np.ndarray:
        if not _is_cuda_placement(placement):
            return np.empty(shape, np.dtype(dtype))
        import torch

        tdtype = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
        return torch.empty(tuple(shape), dtype=tdtype, pin_memory=True).numpy()

    def acquire(self, shape, dtype, placement=None) -> np.ndarray:
        """A writable host buffer of exactly (shape, dtype) for the given
        placement domain: recycled when one is free, freshly allocated
        otherwise (contents undefined)."""
        key = self._key(shape, dtype, placement)
        with self._lock:
            lst = self._free.get(key)
            if lst is not None:
                self._free.move_to_end(key)  # ring touched = ring live
                if lst:
                    self.reused += 1
                    return lst.pop()
            self.allocated += 1
        return self._new(shape, dtype, placement)

    def release(self, buf: np.ndarray, placement=None) -> bool:
        """Return ``buf`` to its placement domain's free list (True) or
        drop it when the ring is full (False)."""
        if not isinstance(buf, np.ndarray):
            return False
        key = self._key(buf.shape, buf.dtype, placement)
        with self._lock:
            lst = self._free.get(key)
            if lst is None:
                lst = self._free[key] = []
                while len(self._free) > self.MAX_KEYS:
                    self._free.popitem(last=False)  # the least recently touched ring
                    self.rings_evicted += 1
            else:
                self._free.move_to_end(key)
            if len(lst) >= self._max_per_key:
                return False
            lst.append(buf)
        return True

    @property
    def reuse_rate(self) -> float:
        """reused / (reused + allocated): 1.0 is a zero-allocation steady
        state."""
        total = self.reused + self.allocated
        return self.reused / total if total else 0.0


