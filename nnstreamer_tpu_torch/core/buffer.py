"""Stream payload and event objects.

Port of ``nnstreamer_tpu/core/buffer.py``: ``TensorFrame`` (N tensors +
timestamps + meta), ``BatchFrame`` (a micro-batch travelling as one stream
item) and the in-band events.  Payloads are numpy arrays or
``torch.Tensor``s; a filter keeps its outputs on its device and only
:func:`materialize` (sinks, decoders, ``BatchFrame.split``) brings them
to the host.
"""

from __future__ import annotations

import itertools
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


def materialize(tensors: Sequence[Any]) -> List[np.ndarray]:
    """Bring a tensor list to host numpy arrays (:func:`to_numpy` for torch
    tensors)."""
    return [to_numpy(t) if _is_torch(t) else np.asarray(t) for t in tensors]


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

    def split(self) -> List[TensorFrame]:
        """Materialize on host and fan back out into per-frame views."""
        mats = materialize(self.tensors)
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
