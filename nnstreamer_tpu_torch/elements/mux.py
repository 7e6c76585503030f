"""N:1 / 1:N tensor stream composition: mux, demux, merge, split.

Port of ``nnstreamer_tpu/elements/mux.py``:

* ``tensor_mux``   — N streams -> 1, the frames' tensor lists joined, over
  the sync policies of :mod:`..core.sync`;
* ``tensor_demux`` — one stream's tensors out to several src pads
  (``tensorpick`` groups);
* ``tensor_merge`` — N single tensors -> 1 tensor concatenated along a
  reference dim, over the sync policies;
* ``tensor_split`` — one tensor sliced into N along a reference dim
  (``tensorseg`` sizes).

Torch payloads stay on their device: merge concatenates with ``torch.cat``
and split slices views, never through numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.buffer import TensorFrame, as_array, concat_tensors
from ..core.sync import Collator, SyncPolicy
from ..core.types import ANY, FORMAT_STATIC, StreamSpec, TensorSpec, ref_dim_to_axis
from ..pipeline.element import Element, ElementError, Property, element


class _SyncedNto1(Element):
    """Shared machinery of mux and merge: collator-driven N:1 elements."""

    NUM_SINK_PADS = None  # request pads

    PROPERTIES = {
        "sync-mode": Property(str, "nosync", "nosync|slowest|basepad|refresh"),
        "sync-option": Property(str, "", "basepad: '<pad>:<window-s>'"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._collator: Optional[Collator] = None

    def start(self):
        policy = SyncPolicy.from_string(self.props["sync-mode"], self.props["sync-option"])
        self._collator = Collator(max(self.num_sink_pads, 1), policy)

    def combine(self, frames: List[TensorFrame]) -> TensorFrame:
        raise NotImplementedError

    def _drain(self):
        out = []
        while (group := self._collator.collect()) is not None:
            out.append((0, self.combine(group)))
        return out

    def handle_frame(self, pad, frame):
        self._collator.push(pad, frame)
        return self._drain()

    def handle_eos(self, pad):
        self._collator.mark_eos(pad)
        return self._drain()


@element("tensor_mux")
class TensorMux(_SyncedNto1):
    """Join the tensor lists of N synchronized streams."""

    def derive_spec(self, pad=0):
        specs = [self.sink_specs.get(i) for i in range(self.num_sink_pads)]
        if any(s is None or not s.tensors for s in specs):
            return ANY
        tensors: Tuple[TensorSpec, ...] = ()
        for s in specs:
            tensors = tensors + s.tensors
        fr = next((s.framerate for s in specs if s.framerate), None)
        return StreamSpec(tensors, FORMAT_STATIC, fr)

    def combine(self, frames):
        base = frames[0]
        return TensorFrame([t for f in frames for t in f.tensors], pts=base.pts,
                           duration=base.duration, meta=dict(base.meta))


@element("tensor_merge")
class TensorMerge(_SyncedNto1):
    """Concatenate N single tensors along one reference dim (mode
    ``linear``, option = the dim index)."""

    PROPERTIES = {
        **_SyncedNto1.PROPERTIES,
        "mode": Property(str, "linear", "only 'linear' (reference parity)"),
        "option": Property(str, "0", "reference dim index to concat on"),
    }

    def _np_axis(self, rank: int) -> int:
        try:
            return ref_dim_to_axis(int(self.props["option"]), rank)
        except ValueError as e:
            raise ElementError(f"{self.name}: {e}") from None

    def derive_spec(self, pad=0):
        specs = [self.sink_specs.get(i) for i in range(self.num_sink_pads)]
        if any(s is None or not s.tensors for s in specs):
            return ANY
        first = specs[0].tensors[0]
        if not first.is_static:
            return specs[0]
        axis = self._np_axis(len(first.shape))
        dims = list(first.shape)
        dims[axis] = sum(s.tensors[0].shape[axis] for s in specs)
        fr = next((s.framerate for s in specs if s.framerate), None)
        return StreamSpec((TensorSpec(tuple(dims), first.dtype, first.name),), FORMAT_STATIC, fr)

    def combine(self, frames):
        arrays = [as_array(f.tensors[0]) for f in frames]
        out = concat_tensors(arrays, axis=self._np_axis(arrays[0].ndim))
        base = frames[0]
        return TensorFrame([out], pts=base.pts, duration=base.duration, meta=dict(base.meta))


def _parse_pick(text: str) -> Optional[List[List[int]]]:
    """'0,1,2' or '0:1,2': a comma separates output pads, ':' or '+' joins
    several input tensors onto one pad (reference tensorpick dialect)."""
    if not text:
        return None
    groups = []
    for part in text.split(","):
        part = part.strip()
        if part:
            groups.append([int(x) for x in part.replace("+", ":").split(":")])
    return groups or None


@element("tensor_demux")
class TensorDemux(Element):
    """Split a multi-tensor stream into per-tensor (or grouped) streams."""

    NUM_SRC_PADS = None  # request pads

    PROPERTIES = {
        "tensorpick": Property(str, "", "e.g. '0,1:2' — tensors per src pad"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
    }

    def _groups(self, ntensors: int) -> List[List[int]]:
        return _parse_pick(self.props["tensorpick"]) or [[i] for i in range(ntensors)]

    def derive_spec(self, pad=0):
        in_spec = self.sink_specs.get(0, ANY)
        if not in_spec.tensors:
            return ANY
        groups = self._groups(in_spec.num_tensors)
        if pad >= len(groups):
            return ANY
        return StreamSpec(tuple(in_spec.tensors[i] for i in groups[pad]), in_spec.fmt,
                          in_spec.framerate)

    def handle_frame(self, pad, frame):
        out = []
        for p, idxs in enumerate(self._groups(len(frame.tensors))):
            if p < len(self.srcpads) and self.srcpads[p].is_linked:
                out.append((p, frame.pick(idxs)))
        return out


@element("tensor_split")
class TensorSplit(Element):
    """Slice one tensor into N along a reference dim: ``tensorseg`` is a
    comma list of sizes along dim ``option``; ``tensorpick`` emits only
    the named segments, in order."""

    NUM_SRC_PADS = None

    PROPERTIES = {
        "tensorseg": Property(str, "", "comma sizes, e.g. '2,1' along the dim"),
        "tensorpick": Property(str, "", "emit only these segment indices, in order (e.g. "
                               "'0,2'); empty = all segments"),
        "option": Property(str, "0", "reference dim index to split on"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
    }

    _seg_cache: Optional[List[int]] = None
    _pick_cache: Optional[List[int]] = None

    def start(self):
        # parsed once; direct handle_frame calls without start() parse per call
        self._seg_cache = self._sizes()
        self._pick_cache = self._picks(len(self._seg_cache))

    def stop(self):
        self._seg_cache = self._pick_cache = None

    def _sizes(self) -> List[int]:
        if self._seg_cache is not None:
            return self._seg_cache
        text = self.props["tensorseg"]
        if not text:
            raise ElementError(f"{self.name}: tensor_split requires tensorseg=")
        return [int(x) for x in text.split(",") if x.strip()]

    def _picks(self, nseg: int) -> List[int]:
        """Pad index -> segment index (≙ gsttensor_split.c tensorpick)."""
        if self._pick_cache is not None:
            return self._pick_cache
        text = self.props["tensorpick"]
        if not text:
            return list(range(nseg))
        picks = [int(x) for x in text.split(",") if x.strip()]
        bad = [p for p in picks if not 0 <= p < nseg]
        if bad:
            raise ElementError(f"{self.name}: tensorpick {bad} out of range for {nseg} segments")
        return picks

    def _np_axis(self, rank: int) -> int:
        try:
            return ref_dim_to_axis(int(self.props["option"]), rank)
        except ValueError as e:
            raise ElementError(f"{self.name}: {e}") from None

    def accept_spec(self, pad, spec):
        if spec.tensors and spec.tensors[0].is_static:
            t = spec.tensors[0]
            axis = self._np_axis(len(t.shape))
            if sum(self._sizes()) != t.shape[axis]:
                raise ElementError(f"{self.name}: tensorseg {self._sizes()} does not sum to "
                                   f"dim {t.shape[axis]}")
        return spec

    def derive_spec(self, pad=0):
        in_spec = self.sink_specs.get(0, ANY)
        if not in_spec.tensors or not in_spec.tensors[0].is_static:
            return ANY
        t = in_spec.tensors[0]
        sizes = self._sizes()
        picks = self._picks(len(sizes))
        if pad >= len(picks):
            return ANY
        dims = list(t.shape)
        dims[self._np_axis(len(t.shape))] = sizes[picks[pad]]
        return StreamSpec((TensorSpec(tuple(dims), t.dtype, t.name),), in_spec.fmt,
                          in_spec.framerate)

    def handle_frame(self, pad, frame):
        arr = as_array(frame.tensors[0])
        sizes = self._sizes()
        axis = self._np_axis(arr.ndim)
        offsets, off = [], 0
        for size in sizes:
            offsets.append((off, size))
            off += size
        out = []
        for p, seg in enumerate(self._picks(len(sizes))):
            if p < len(self.srcpads) and self.srcpads[p].is_linked:
                o, size = offsets[seg]
                sl = [slice(None)] * arr.ndim
                sl[axis] = slice(o, o + size)
                out.append((p, frame.with_tensors([arr[tuple(sl)]])))
        return out
