"""detokenizer decoder: int32 token ids -> text bytes.

Port of ``nnstreamer_tpu/decoders/detokenizer.py``, the inverse of the
tokenizer converter: byte-level ids (0-255) become bytes, any other id
becomes '?'.  The text also lands in ``meta["text"]``.  Ids on the card
come to the host through ``materialize``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.buffer import TensorFrame, materialize
from ..core.types import FORMAT_FLEXIBLE, StreamSpec


class Detokenizer:
    NAME = "detokenizer"

    def set_options(self, options: List[str]) -> None:
        pass

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        return StreamSpec((), FORMAT_FLEXIBLE, in_spec.framerate if in_spec else None)

    def decode(self, frame: TensorFrame, in_spec) -> TensorFrame:
        toks = materialize(frame.tensors[:1])[0].ravel()
        data = np.where((toks >= 0) & (toks < 256), toks, ord("?")).astype(np.uint8)
        out = frame.with_tensors([data])
        out.meta["media_type"] = "text"
        out.meta["text"] = data.tobytes().decode("utf-8", errors="replace")
        return out
