"""tensor_filter: run a model on every frame or micro-batch of a stream.

Port of ``nnstreamer_tpu/elements/filter.py`` for the serving path: the
backend is resolved from ``framework=`` and opened with the element's
properties; ``max-batch`` > 1 makes the scheduler hand micro-batches
(``handle_frame_batch``) that run as one ``invoke_batch``; a decoder's
device half can be folded into the backend (``fuse_device_postprocess``),
after which the filter emits each micro-batch as ONE device-resident
``BatchFrame`` (batch-through).  The backend call is synchronous.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..backends import find_backend, parse_accelerator
from ..backends.base import FilterBackend
from ..core.buffer import BatchFrame, TensorFrame, _is_torch, materialize
from ..core.types import ANY, StreamSpec
from ..pipeline.element import ElementError, Property, TransformElement, element


def _concat(pieces: List[Any]):
    """Concatenate batch pieces on axis 0 (torch when any piece is)."""
    if len(pieces) == 1:
        return pieces[0]
    if any(_is_torch(p) for p in pieces):
        import torch

        return torch.cat([torch.as_tensor(p) for p in pieces])
    return np.concatenate([np.asarray(p) for p in pieces])


def _batched_tensors(frames: Sequence[TensorFrame]) -> List[Any]:
    """ONE batched tensor list for a mixed plain/BatchFrame list: plain
    frames gain a length-1 batch axis, blocks pass through."""
    pieces = [
        list(f.tensors) if isinstance(f, BatchFrame) else [t[None] for t in f.tensors]
        for f in frames
    ]
    return [_concat([p[t] for p in pieces]) for t in range(len(pieces[0]))]


def _logical_infos(frames: Sequence[TensorFrame]) -> List[Tuple[Any, Any, Dict[str, Any]]]:
    """(pts, duration, meta) per LOGICAL frame, in stream order."""
    infos = []
    for f in frames:
        if isinstance(f, BatchFrame):
            infos.extend(f.frames_info)
        else:
            infos.append((f.pts, f.duration, f.meta))
    return infos


@element("tensor_filter")
class TensorFilter(TransformElement):
    BATCH_AWARE = True  # consumes the batch axis (micro-batching)

    PROPERTIES = {
        "framework": Property(str, "torch-cuda", "backend name"),
        "model": Property(str, "", "model registry key, or any name with custom=arch:<zoo-name>"),
        "custom": Property(str, "", "backend-specific options 'k1:v1,k2:v2'"),
        "accelerator": Property(
            str, "", "ordered wish list 'true:gpu.N,cpu' or 'cpu' (empty = cuda:0)"),
        "max-batch": Property(int, 1, "micro-batch up to N queued frames into one invoke"),
        "batch-timeout": Property(
            int, 0, "ms to wait filling a micro-batch (0 = only drain queued)"),
        "batch-through": Property(
            bool, False,
            "emit micro-batches as ONE BatchFrame (device-resident) instead of "
            "per-frame outputs (set automatically by the device-fusion pass)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self.backend: Optional[FilterBackend] = None
        self._model_in: Optional[StreamSpec] = None
        self._model_out: Optional[StreamSpec] = None
        # set by the pipeline's device-fusion pass for one run
        self._auto_batch_through = False
        self.invokes = 0  # backend calls (one per micro-batch or frame)

    @property
    def batch_through_active(self) -> bool:
        return bool(self.props["batch-through"]) or self._auto_batch_through

    # -- device fusion (pipeline pass) --------------------------------------
    @property
    def can_fuse_postprocess(self) -> bool:
        return self.backend is not None and hasattr(self.backend, "append_postprocess")

    def fuse_device_postprocess(self, fn) -> None:
        """Fold ``fn`` (operates on the model's output list, on device) into
        the backend call; the cached output schema no longer holds."""
        if not self.can_fuse_postprocess:
            raise ElementError(f"{self.name}: backend cannot fuse a postprocess")
        self.backend.append_postprocess(fn)
        self._model_out = None

    # -- batching hook for the scheduler ------------------------------------
    @property
    def preferred_batch(self) -> int:
        be = self.backend
        if be is not None and be.supports_batch:
            return max(1, int(self.props["max-batch"]))
        return 1

    @property
    def batch_wait_s(self) -> float:
        return max(0, int(self.props["batch-timeout"])) / 1000.0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._auto_batch_through = False  # re-set by the fusion pass, or not
        fw = self.props["framework"]
        try:
            backend_cls = find_backend(fw)
        except KeyError:
            raise ElementError(f"{self.name}: unknown framework {fw!r}") from None
        props = dict(self.props)
        enabled, wishes = parse_accelerator(self.props["accelerator"])
        props["accelerators"] = wishes if enabled else ["cpu"]
        be = backend_cls()
        be.open(self.props["model"] or None, props)
        self.backend = be
        self._model_in, self._model_out = be.get_model_info()

    def stop(self) -> None:
        if self.backend is not None:
            self.backend.close()
            self.backend = None

    # -- negotiation --------------------------------------------------------
    def accept_spec(self, pad, spec):
        if self._model_in is not None and spec.tensors and not self._model_in.is_compatible(spec):
            raise ElementError(
                f"{self.name}: stream schema {spec.to_string()} does not match "
                f"model input {self._model_in.to_string()}")
        return spec

    def derive_spec(self, pad=0):
        if self._model_out is not None:
            return self._model_out
        in_spec = self.sink_specs.get(0, ANY)
        if self.backend is not None and in_spec.tensors:
            return self.backend.set_input_info(in_spec)
        return ANY

    # -- processing ---------------------------------------------------------
    def transform(self, frame: TensorFrame) -> TensorFrame:
        # a pre-batched block on the per-frame path: its batch axis still
        # means "batch", and the block stays whole
        invoke = self.backend.invoke_batch if isinstance(frame, BatchFrame) else self.backend.invoke
        self.invokes += 1
        return frame.with_tensors(invoke(list(frame.tensors)))

    def handle_frame_batch(
        self, pad: int, frames: List[TensorFrame]
    ) -> List[Tuple[int, TensorFrame]]:
        """Micro-batched path: the scheduler hands N frames; they run as
        invoke_batch calls of at most max-batch logical frames each."""
        batched = _batched_tensors(frames)
        infos = _logical_infos(frames)
        mb = max(1, int(self.props["max-batch"]))
        if len(infos) <= mb:
            return self._run_batch(batched, frames)
        results = []
        for k in range(0, len(infos), mb):
            cinfos = infos[k:k + mb]
            chunk = BatchFrame(
                tensors=[t[k:k + mb] for t in batched], pts=cinfos[0][0],
                duration=cinfos[0][1], meta=dict(cinfos[0][2]), frames_info=list(cinfos))
            results.extend(self._run_batch(chunk.tensors, [chunk]))
        return results

    def _run_batch(
        self, batched: List[Any], frames: List[TensorFrame]
    ) -> List[Tuple[int, TensorFrame]]:
        out_b = self.backend.invoke_batch(batched)
        self.invokes += 1
        infos = _logical_infos(frames)
        if self.batch_through_active:
            # the whole micro-batch leaves as ONE frame, outputs still on
            # the device; the next host boundary splits it
            p, d, m = infos[0]
            return [(0, BatchFrame(tensors=list(out_b), pts=p, duration=d,
                                   meta=dict(m), frames_info=infos))]
        out_np = materialize(out_b)
        return [
            (0, TensorFrame([o[b] for o in out_np], pts=p, duration=d, meta=dict(m)))
            for b, (p, d, m) in enumerate(infos)
        ]
