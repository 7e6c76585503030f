"""flexbuf / flatbuf / protobuf converters: serialized bytes -> tensors.

Port of ``nnstreamer_tpu/converters/serialize.py``, the exact inverse of
the decoders of the same names (``decoders/serialize.py``): flexbuf reads
the framework's own wire frame (``distributed/wire.py``), protobuf the
``nns_tensors.proto`` schema and flatbuf the reference's ``nnstreamer.fbs``
schema.  The payload comes to the host through ``materialize``; the
decoded tensors are host arrays.
"""

from __future__ import annotations

from ..core.buffer import TensorFrame, host_bytes
from ..core.types import ANY, StreamSpec
from ..distributed import wire


class _DeserializeBase:
    NAME = "deserialize"
    IDL = "flex"  # wire.get_codec name

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        return ANY  # per-payload shapes, known only after decode

    def convert(self, frame: TensorFrame) -> TensorFrame:
        _, decode = wire.get_codec(self.IDL)
        decoded = decode(host_bytes(frame.tensors[0]))
        out = frame.with_tensors(list(decoded.tensors))
        for k, v in decoded.meta.items():
            out.meta.setdefault(k, v)
        out.meta.pop("media_type", None)  # a plain tensor stream again
        return out


class FlexbufConverter(_DeserializeBase):
    NAME = "flexbuf"


class FlatbufConverter(_DeserializeBase):
    NAME = "flatbuf"
    IDL = "flatbuf"


class ProtobufConverter(_DeserializeBase):
    NAME = "protobuf"
    IDL = "protobuf"
