"""Shared machinery of the importer backends (``tflite``, ``onnx``).

Port of ``nnstreamer_tpu/backends/_importer_common.py``.  Both backends
lower a foreign graph to ``lowering.run(consts, *xs)`` with fixed
per-frame input ranks.  :class:`ImportedGraph` is the module the
``torch-cuda`` plumbing runs: the constants are its buffers (placed with
the module), and a micro-batch of N frames (every input one rank higher
than declared) is folded into the file's leading dimension, so the whole
batch is one pass over the graph.  Where an op would mix frames along
that dimension (``Unfoldable``), the graph runs frame by frame from then
on, and :data:`FRAME_CALLS` counts those calls.  :func:`spec_from_shapes`
builds the schemas from the file's declared shapes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ..ops import _oplib
from ..importers.tflite_lower import Unfoldable

#: graph calls made frame by frame, because an op of the graph mixes the
#: frames of a folded micro-batch (one per frame)
FRAME_CALLS = 0


class ImportedGraph(torch.nn.Module):
    """A lowered graph as a module: ``forward(*xs)`` takes one frame per
    input (the declared shapes) or a micro-batch of them (one more leading
    dimension) and returns the outputs alike.  ``consts`` (key -> numpy)
    and ``int8_weights`` (op index -> numpy) become buffers."""

    def __init__(self, lowering, consts: Dict[Any, np.ndarray], in_ranks: Sequence[int],
                 int8_weights: Optional[Dict[int, np.ndarray]] = None):
        super().__init__()
        self.lowering = lowering
        self.in_ranks = tuple(in_ranks)
        self._consts: List[Tuple[Any, str]] = []
        for i, (k, v) in enumerate(consts.items()):
            name = f"const{i}"
            self.register_buffer(name, torch.from_numpy(np.array(v)), persistent=False)
            self._consts.append((k, name))
        self._int8: List[Tuple[int, str]] = []
        for i, w in (int8_weights or {}).items():
            name = f"int8_{i}"
            self.register_buffer(name, torch.from_numpy(np.array(w)), persistent=False)
            self._int8.append((i, name))
        #: False once an op refused to fold a micro-batch
        self.foldable = all(r > 0 for r in self.in_ranks)

    def _run(self, xs, fold: int = 1):
        consts = {k: getattr(self, name) for k, name in self._consts}
        w8 = {i: getattr(self, name) for i, name in self._int8}
        return self.lowering.run(consts, *xs, int8_weights=w8, fold=fold)

    def _folded(self, xs, n):
        outs = self._run([x.reshape((-1,) + tuple(x.shape[2:])) for x in xs], fold=n)
        batched = self.lowering.batched
        return [o.reshape((n, -1) + tuple(o.shape[1:])) if i in batched
                else o.unsqueeze(0).expand((n,) + tuple(o.shape))
                for o, i in zip(outs, self.lowering.output_keys())]

    def forward(self, *xs):
        global FRAME_CALLS
        if not all(r >= 0 and x.dim() == r + 1 for x, r in zip(xs, self.in_ranks)):
            return list(self._run(xs))
        if _oplib.tracing():
            return self._folded(xs, xs[0].shape[0])
        n = int(xs[0].shape[0])
        if self.foldable:
            try:
                return self._folded(xs, n)
            except Unfoldable:
                self.foldable = False
        FRAME_CALLS += n
        frames = [self._run([x[b] for x in xs]) for b in range(n)]
        return [torch.stack(parts) for parts in zip(*frames)]


def spec_from_shapes(
    entries: Sequence[Tuple[Optional[Sequence[Optional[int]]], Optional[str]]],
) -> Optional[StreamSpec]:
    """(shape, dtype) pairs -> StreamSpec; None when a shape or dtype is
    unknown or has dynamic dims (negotiation derives it from the stream)."""
    tensors = []
    for shape, dtype in entries:
        if shape is None or dtype is None or any(
                d is None or (isinstance(d, int) and d < 0) for d in shape):
            return None
        tensors.append(TensorSpec(tuple(int(d) for d in shape), np.dtype(dtype)))
    return StreamSpec(tuple(tensors), FORMAT_STATIC)
