"""The distributed layer's codecs: tensor frames as bytes.

``wire`` is the framework's own frame (envelope v1/v2 with its CRC);
``protobuf_codec`` and ``flatbuf_codec`` speak the ``nns_tensors.proto``
and ``nnstreamer.fbs`` schemas, written with ``struct`` so that no
protobuf or flatbuffers runtime is needed.  The transports (``tcp_query``,
``service``, ``mqtt``, ``hybrid``, ``tcp_edge``) are not ported yet
(ROADMAP A13).
"""
