"""The distributed layer: tensor frames as bytes, and the query transports.

``wire`` is the framework's own frame (envelope v1/v2 with its CRC, and the
'NNSB'/'NNSC' multi-frame envelope); ``protobuf_codec`` and
``flatbuf_codec`` speak the ``nns_tensors.proto`` and ``nnstreamer.fbs``
schemas, written with ``struct`` so that no protobuf or flatbuffers
runtime is needed.  ``tcp_query`` is the raw-TCP query transport and
``service`` the query server core and the edge broker with their gRPC
transport, which imports ``grpc`` only when it is used.  ``tcp_edge`` is
the raw-TCP edge pub/sub, ``mqtt`` the MQTT 3.1.1 client and broker, and
``hybrid`` the control plane that announces and discovers endpoints over
MQTT.
"""

from .wire import (  # noqa: F401
    WireCorruptionError,
    WireError,
    WireTruncationError,
    decode_frame,
    encode_frame,
)
from .service import (  # noqa: F401
    EdgeBroker,
    EdgePublisher,
    EdgeSubscriber,
    QueryConnection,
    QueryServerCore,
    get_edge_broker,
    get_query_server,
    release_edge_broker,
    release_query_server,
)
from .mqtt import MiniBroker, MqttClient, topic_matches  # noqa: F401
from .hybrid import Announcement, discover_endpoints, probe_endpoint  # noqa: F401
from .tcp_edge import TcpEdgeServer, TcpEdgeSubscriber  # noqa: F401
