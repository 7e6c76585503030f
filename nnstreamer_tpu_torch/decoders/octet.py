"""octet_stream decoder: tensors -> raw application/octet-stream bytes.

Port of ``nnstreamer_tpu/decoders/octet.py``: every tensor's bytes,
concatenated into one uint8 buffer.  Tensors on the card come to the host
through ``materialize``.
"""

from __future__ import annotations

import numpy as np

from ..core.buffer import TensorFrame, materialize
from ..core.types import FORMAT_FLEXIBLE, StreamSpec, TensorSpec


class OctetStream:
    NAME = "octet_stream"

    def set_options(self, options) -> None:
        pass

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        nbytes = in_spec.nbytes() if in_spec and in_spec.is_static else None
        tensors = (TensorSpec((nbytes,), np.uint8, "octets"),) if nbytes else ()
        return StreamSpec(tensors, FORMAT_FLEXIBLE, in_spec.framerate if in_spec else None)

    def decode(self, frame: TensorFrame, in_spec) -> TensorFrame:
        payload = b"".join(np.ascontiguousarray(t).tobytes() for t in materialize(frame.tensors))
        return frame.with_tensors([np.frombuffer(payload, np.uint8)])
