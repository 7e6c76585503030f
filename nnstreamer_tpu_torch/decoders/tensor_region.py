"""tensor_region decoder: detection tensors -> crop-region info tensor.

Port of ``nnstreamer_tpu/decoders/tensor_region.py`` (the reference's
``tensordec-tensor_region.c``), with the same options:

- option1: number of crop regions to emit (default 1)
- option2: label file (carried to meta)
- option3: priors.txt[:thr:y_scale:x_scale:h_scale:w_scale:iou], the
  bounding_boxes ``mobilenet-ssd`` scheme
- option4: video input dimension ``WIDTH:HEIGHT`` (default 300:300):
  regions are in input coordinates

Output: int32 [num_regions, 4] = (x, y, w, h), the crop-info stream
``tensor_crop`` reads on its second sink pad.  The decode is the box
decoder's host ``mobilenet-ssd`` path (``BoundingBoxes._detect`` and
``util.nms``); the raw heads on the card come to the host through
``materialize``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.buffer import TensorFrame, materialize
from ..core.types import FORMAT_FLEXIBLE, StreamSpec, TensorSpec
from . import util
from .bounding_box import BoundingBoxes


class TensorRegion:
    NAME = "tensor_region"

    def __init__(self):
        self.num_regions = 1
        self.labels: Optional[List[str]] = None
        self._bb = BoundingBoxes()  # the mobilenet-ssd decode

    def set_options(self, options: List[str]) -> None:
        o = list(options) + [""] * 9
        if o[0]:
            try:
                self.num_regions = max(1, int(o[0]))
            except ValueError:
                pass
        if o[1]:
            self.labels = util.load_labels(o[1])
        # option4 here is the INPUT size (reference :40): the box decoder's option5
        self._bb.set_options(["mobilenet-ssd", "", o[2], "", o[3]])

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        return StreamSpec((TensorSpec((self.num_regions, 4), np.int32, "crop_info"),),
                          FORMAT_FLEXIBLE, in_spec.framerate if in_spec else None)

    def decode(self, frame: TensorFrame, in_spec) -> TensorFrame:
        dets = util.nms(self._bb._detect(materialize(frame.tensors)), self._bb.ssd_iou)
        dets = dets[:self.num_regions]
        regions = np.zeros((len(dets), 4), np.int32)
        labels = []
        w_in, h_in = self._bb.in_wh
        for i, (x1, y1, x2, y2, _, cls) in enumerate(dets):
            # clamped to the image, so tensor_crop truncates instead of shifting
            x1, y1 = max(0.0, x1), max(0.0, y1)
            x2, y2 = min(float(w_in), x2), min(float(h_in), y2)
            regions[i] = (int(x1), int(y1), max(0, int(x2 - x1)), max(0, int(y2 - y1)))
            labels.append(self.labels[int(cls)] if self.labels and int(cls) < len(self.labels)
                          else str(int(cls)))
        out = frame.with_tensors([regions])
        out.meta["region_labels"] = labels
        return out
