"""tensor_aggregator: temporal batching/re-framing.

Port of ``nnstreamer_tpu/elements/aggregator.py`` (reference
``gsttensor_aggregator.c``): collect ``frames-in`` input frames per
buffer, emit ``frames-out`` frames per output, advance by
``frames-flush`` (0 = non-overlapping); the frame axis is reference dim
``frames-dim``; ``concat=true`` concatenates the collected frames along it
(``torch.cat`` on the device for torch payloads), ``false`` stacks them on
a new leading axis.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, List

from ..core.buffer import as_array, concat_tensors, stack_tensors
from ..core.types import ANY, FORMAT_STATIC, StreamSpec, TensorSpec, ref_dim_to_axis
from ..pipeline.element import Element, ElementError, Property, element


@element("tensor_aggregator")
class TensorAggregator(Element):
    PROPERTIES = {
        "frames-in": Property(int, 1, "frames carried per incoming buffer"),
        "frames-out": Property(int, 1, "frames per outgoing buffer"),
        "frames-flush": Property(int, 0, "frames to drop per emit (0 = frames-out)"),
        "frames-dim": Property(int, 0, "reference dim index that counts frames"),
        "concat": Property(bool, True, "concatenate along frames-dim"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        # per-tensor queues of single frames along the frame axis
        self._buf: List[Deque[Any]] = []

    def start(self):
        self._buf = []

    def _np_axis(self, rank: int) -> int:
        try:
            return ref_dim_to_axis(int(self.props["frames-dim"]), rank)
        except ValueError as e:
            raise ElementError(f"{self.name}: frames-dim {e}") from None

    def _extends_rank(self, rank: int) -> bool:
        """frames-dim == rank means a new outermost axis (the reference
        pads every tensor to rank 4; here the rank grows instead)."""
        return int(self.props["frames-dim"]) == rank

    def derive_spec(self, pad=0):
        in_spec = self.sink_specs.get(0, ANY)
        if not in_spec.tensors or not in_spec.tensors[0].is_static:
            return ANY
        fin, fout = self.props["frames-in"], self.props["frames-out"]
        tensors = []
        for t in in_spec.tensors:
            dims = list(t.shape)
            if self._extends_rank(len(dims)):
                dims = [1] + dims
            axis = self._np_axis(len(dims))
            per_buf = dims[axis] // fin  # frame size along the axis
            if self.props["concat"]:
                dims[axis] = per_buf * fout
            else:  # stacked output: a new leading axis of size frames-out
                dims[axis] = per_buf
                dims = [fout] + dims
            tensors.append(TensorSpec(tuple(dims), t.dtype, t.name))
        fr = in_spec.framerate
        if fr is not None and fout:
            fr = fr * fin / fout
        return StreamSpec(tuple(tensors), FORMAT_STATIC, in_spec.framerate and fr)

    def handle_frame(self, pad, frame):
        fin = max(1, self.props["frames-in"])
        fout = max(1, self.props["frames-out"])
        flush = self.props["frames-flush"] or fout
        if not self._buf:
            self._buf = [deque() for _ in frame.tensors]
        # slice each incoming buffer into unit frames along the frame axis
        for i, t in enumerate(frame.tensors):
            arr = as_array(t)
            if self._extends_rank(arr.ndim):
                arr = arr[None]
            axis = self._np_axis(arr.ndim)
            if arr.shape[axis] % fin:
                raise ElementError(f"{self.name}: dim {arr.shape[axis]} not divisible by "
                                   f"frames-in {fin}")
            unit = arr.shape[axis] // fin
            for j in range(fin):
                sl = [slice(None)] * arr.ndim
                sl[axis] = slice(j * unit, (j + 1) * unit)
                self._buf[i].append(arr[tuple(sl)])
        out = []
        while len(self._buf[0]) >= fout:
            tensors = []
            for q in self._buf:
                chunk = [q[j] for j in range(fout)]
                tensors.append(concat_tensors(chunk, axis=self._np_axis(chunk[0].ndim))
                               if self.props["concat"] else stack_tensors(chunk))
            for q in self._buf:
                for _ in range(min(flush, len(q))):
                    q.popleft()
            out.append((0, frame.with_tensors(tensors)))
        return out

    def handle_eos(self, pad):
        self._buf = []  # drop an incomplete tail (reference behaviour)
        return []
