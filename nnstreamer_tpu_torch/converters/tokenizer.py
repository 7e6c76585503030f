"""tokenizer converter: text bytes -> int32 token ids.

Port of ``nnstreamer_tpu/converters/tokenizer.py``: byte-level ids
(0-255), so that

    appsrc ! tensor_converter mode=custom:tokenizer
        ! tensor_filter custom=arch:transformer,generate:N
        ! tensor_decoder mode=detokenizer ! tensor_sink

takes prompt text in and gives completion text out.  Byte ids are valid
ids of any vocabulary of at least 256 (GPT-2's included).  A payload on
the card comes to the host through ``materialize``.
"""

from __future__ import annotations

import numpy as np

from ..core.buffer import TensorFrame, host_bytes
from ..core.types import ANY, StreamSpec


class TokenizerConverter:
    NAME = "tokenizer"

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        return ANY  # token count = byte count, known per frame

    def convert(self, frame: TensorFrame) -> TensorFrame:
        toks = np.frombuffer(host_bytes(frame.tensors[0]), np.uint8).astype(np.int32)
        out = frame.with_tensors([toks])
        out.meta.pop("media_type", None)
        return out
