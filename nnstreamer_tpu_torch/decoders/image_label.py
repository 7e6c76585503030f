"""image_labeling decoder: classification scores -> label.

Port of ``nnstreamer_tpu/decoders/image_label.py``.  Output frame: tensor =
[argmax index] (int32); ``meta`` carries ``label_index``, ``label_score``
and, with a label file (option1), ``label``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.buffer import BatchFrame, TensorFrame, materialize
from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from .util import load_labels


class ImageLabeling:
    NAME = "image_labeling"

    def __init__(self):
        self.labels: Optional[List[str]] = None

    def set_options(self, options):
        if options and options[0]:
            self.labels = load_labels(options[0])

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        return StreamSpec(
            (TensorSpec((1,), np.int32, "label_index"),),
            FORMAT_STATIC,
            in_spec.framerate if in_spec else None,
        )

    def decode(self, frame: TensorFrame, in_spec) -> TensorFrame:
        scores = materialize(frame.tensors[:1])[0].reshape(-1)
        idx = int(np.argmax(scores))
        return self._emit(frame, idx, float(scores[idx]))

    def _emit(self, frame: TensorFrame, idx: int, score: float) -> TensorFrame:
        out = frame.with_tensors([np.asarray([idx], np.int32)])
        out.meta["label_index"] = idx
        out.meta["label_score"] = score
        if self.labels and idx < len(self.labels):
            out.meta["label"] = self.labels[idx]
        return out

    # -- device-fused half (pipeline fusion pass) ---------------------------
    def device_fn(self, outs, device=None):
        """Device half, run inside the upstream filter's backend call on its
        device: fused argmax+max of float32, bfloat16 or float16 logits, so
        only (index, score) — 8 bytes/frame — crosses to the host.

        The pair is packed into ONE float32 (B, 2) tensor, a single copy per
        micro-batch; float32 holds the index exactly (class counts are
        << 2^24).  On CUDA the ``top1`` kernel writes the packed tensor
        itself: one launch per micro-batch."""
        from ..ops.labeling import top1_packed

        logits = outs[0] if device is None else outs[0].to(device)
        return [top1_packed(logits)]  # (B, 2)

    def decode_fused(self, frame: TensorFrame, in_spec) -> TensorFrame:
        """Host finishing after device_fn: tensor is [idx, score]."""
        packed = materialize(frame.tensors[:1])[0].astype(np.float64).reshape(-1)
        return self._emit(frame, int(packed[0]), float(packed[1]))

    def decode_fused_batch(self, frame: BatchFrame, in_spec) -> BatchFrame:
        """Vectorized host finish for a whole block: one (B, 2) packed
        tensor in, one BatchFrame of (1,) label indices out, labels stamped
        into frames_info meta."""
        packed = materialize(frame.tensors[:1])[0].astype(np.float64).reshape(-1, 2)
        idx = packed[:, 0].astype(np.int32)
        infos = []
        for j, (p, d, m) in enumerate(frame.frames_info):
            m2 = dict(m)
            i = int(idx[j])
            m2["label_index"] = i
            m2["label_score"] = float(packed[j, 1])
            if self.labels and i < len(self.labels):
                m2["label"] = self.labels[i]
            infos.append((p, d, m2))
        return BatchFrame(tensors=[idx[:, None]], pts=frame.pts, duration=frame.duration,
                          meta=dict(frame.meta), frames_info=infos)
