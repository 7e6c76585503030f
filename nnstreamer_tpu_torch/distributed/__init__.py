"""The distributed layer: tensor frames as bytes, and the query transports.

``wire`` is the framework's own frame (envelope v1/v2 with its CRC, and the
'NNSB'/'NNSC' multi-frame envelope); ``protobuf_codec`` and
``flatbuf_codec`` speak the ``nns_tensors.proto`` and ``nnstreamer.fbs``
schemas, written with ``struct`` so that no protobuf or flatbuffers
runtime is needed.  ``tcp_query`` is the raw-TCP query transport and
``service`` the query server core with the gRPC transport, which imports
``grpc`` only when it is used (ROADMAP A13.1).  The edge and MQTT
transports and hybrid discovery (``tcp_edge``, ``mqtt``, ``hybrid``) wait
for ROADMAP A13.2.
"""

from .wire import (  # noqa: F401
    WireCorruptionError,
    WireError,
    WireTruncationError,
    decode_frame,
    encode_frame,
)
from .service import (  # noqa: F401
    QueryConnection,
    QueryServerCore,
    get_query_server,
    release_query_server,
)
