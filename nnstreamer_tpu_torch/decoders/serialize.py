"""flexbuf / flatbuf / protobuf decoders: tensors -> self-describing bytes.

Port of ``nnstreamer_tpu/decoders/serialize.py``: flexbuf writes the
framework's own wire frame (``distributed/wire.py``), protobuf the
``nns_tensors.proto`` schema and flatbuf the reference's ``nnstreamer.fbs``
schema, each byte-equal to the JAX package's.  The output is one uint8
tensor of the encoded frame; the converters of the same names
(``converters/serialize.py``) are the exact inverse.  Tensors on the card
come to the host through ``materialize``.
"""

from __future__ import annotations

import numpy as np

from ..core.buffer import TensorFrame
from ..core.types import FORMAT_FLEXIBLE, StreamSpec
from ..distributed import wire


class _SerializeBase:
    NAME = "serialize"
    MEDIA = "other/wire"
    IDL = "flex"  # wire.get_codec name

    def set_options(self, options) -> None:
        pass

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        return StreamSpec((), FORMAT_FLEXIBLE, in_spec.framerate if in_spec else None)

    def decode(self, frame: TensorFrame, in_spec) -> TensorFrame:
        encode, _ = wire.get_codec(self.IDL)
        out = frame.with_tensors([np.frombuffer(encode(frame), np.uint8)])
        out.meta["media_type"] = self.MEDIA
        return out


class FlexbufDecoder(_SerializeBase):
    NAME = "flexbuf"
    MEDIA = "other/flexbuf"


class FlatbufDecoder(_SerializeBase):
    NAME = "flatbuf"
    MEDIA = "other/flatbuf"
    IDL = "flatbuf"


class ProtobufDecoder(_SerializeBase):
    NAME = "protobuf"
    MEDIA = "other/protobuf-tensor"
    IDL = "protobuf"
