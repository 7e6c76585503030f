"""direct_video decoder: uint8 tensor -> raw video frames.

Port of ``nnstreamer_tpu/decoders/direct_video.py``: a uint8 (H, W, C)
tensor (C 1 = GRAY8, 3 = RGB, 4 = BGRx; a leading batch of 1 squeezed) is
a video frame.  A frame on the card comes to the host through
``materialize``.
"""

from __future__ import annotations

import numpy as np

from ..core.buffer import TensorFrame, materialize
from ..core.types import ANY, FORMAT_STATIC, StreamSpec, TensorSpec


class DirectVideo:
    NAME = "direct_video"

    def set_options(self, options):
        pass

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        if not in_spec.tensors:
            return ANY
        shape = in_spec.tensors[0].shape
        if len(shape) == 4 and shape[0] == 1:
            shape = shape[1:]
        if len(shape) != 3 or shape[-1] not in (1, 3, 4):
            raise ValueError(f"direct_video: expected (H,W,C) uint8 with C in 1/3/4, got {shape}")
        return StreamSpec((TensorSpec(shape, np.uint8, "video"),), FORMAT_STATIC,
                          in_spec.framerate)

    def decode(self, frame: TensorFrame, in_spec) -> TensorFrame:
        arr = materialize(frame.tensors[:1])[0]
        if arr.ndim == 4 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.dtype != np.uint8:
            raise ValueError(f"direct_video requires uint8, got {arr.dtype}")
        out = frame.with_tensors([arr])
        out.meta["media"] = "video"
        return out
