"""tensor_src_grpc / tensor_sink_grpc: one-way tensor streams over gRPC.

Port of ``nnstreamer_tpu/elements/grpc_io.py`` (≙ the reference's
``tensor_src_grpc.c`` and ``tensor_sink_grpc.c``): either element runs as
the gRPC server or the client (``server``), with no request/response
pairing.  Two generic methods carry frames in the ``idl`` codec (the JAX
package's bytes):

  * ``nns.Stream/Send`` (unary):            sink as client -> src as server
  * ``nns.Stream/Pull`` (server streaming): src as client  <- sink as server

``grpc`` is imported in ``start()`` only: without the package the module
loads, the elements register, and ``start()`` raises the typed
``RuntimeError`` of ``distributed/service.require_grpc``.  The sink brings
a card frame to the host on its render thread (a micro-batch with one copy
per tensor) before gRPC's threads see its bytes.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from concurrent import futures
from typing import Iterator, Optional

from ..core.buffer import BatchFrame, TensorFrame
from ..core.lifecycle import pipeline_quiescing
from ..core.types import ANY, StreamSpec
from ..distributed import wire
from ..distributed.service import GRPC_OPTS, require_grpc
from ..pipeline.element import ElementError, Property, SinkElement, SourceElement, element


def _ident(b):
    return b


def _grpc(el):
    return require_grpc(el.FACTORY_NAME, "stream with edgesink/edgesrc connect-type=tcp")


class _StreamServer:
    """One gRPC server hosting Send (inbound) and Pull (outbound) for an
    element in server mode."""

    def __init__(self, grpc, host: str, port: int, depth: int):
        self.inbox: "_queue.Queue[bytes]" = _queue.Queue(depth)
        self.outbox: "_queue.Queue[Optional[bytes]]" = _queue.Queue(depth)
        self._grpc = grpc
        self._stop = threading.Event()
        handlers = {
            "Send": grpc.unary_unary_rpc_method_handler(
                self._send, request_deserializer=_ident, response_serializer=_ident),
            "Pull": grpc.unary_stream_rpc_method_handler(
                self._pull, request_deserializer=_ident, response_serializer=_ident),
        }
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8), options=GRPC_OPTS)
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler("nns.Stream", handlers),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise ElementError(f"cannot bind gRPC stream server on {port}")
        self._server.start()

    def _send(self, request: bytes, context) -> bytes:
        try:
            self.inbox.put(request, timeout=10.0)
        except _queue.Full:
            context.abort(self._grpc.StatusCode.RESOURCE_EXHAUSTED, "inbox full")
        return b""

    def _pull(self, request: bytes, context):
        while not self._stop.is_set():
            try:
                item = self.outbox.get(timeout=0.2)
            except _queue.Empty:
                continue
            if item is None:  # EOS
                return
            yield item

    def stop(self) -> None:
        self._stop.set()
        self._server.stop(grace=0.5).wait(5)


@element("tensor_sink_grpc")
class GrpcSink(SinkElement):
    BATCH_AWARE = True  # a micro-batch comes to the host in one copy per tensor

    PROPERTIES = {
        "host": Property(str, "127.0.0.1", "bind/connect host"),
        "port": Property(int, 55115, "bind/connect port (0 = auto in server mode)"),
        "server": Property(bool, False, "run as gRPC server (clients Pull)"),
        "idl": Property(str, "flex", "wire IDL: flex | protobuf | flatbuf (interop)"),
        "max-buffers": Property(int, 64, "stream queue depth"),
        "retry-timeout": Property(
            float, 10.0, "client mode: keep retrying a failed Send for up to this many seconds "
            "(peer restart window); 0 = fail fast"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._srv: Optional[_StreamServer] = None
        self._channel = None
        self._stub = None
        self._retryable = frozenset()
        self.bound_port: Optional[int] = None
        self._encode = wire.encode_frame

    def start(self) -> None:
        grpc = _grpc(self)
        try:
            self._encode, _ = wire.get_codec(self.props["idl"])
        except wire.WireError as e:
            raise ElementError(f"{self.name}: {e}") from None
        # transient codes worth retrying through a peer restart; any other
        # fails at once
        self._retryable = frozenset({grpc.StatusCode.UNAVAILABLE,
                                     grpc.StatusCode.DEADLINE_EXCEEDED,
                                     grpc.StatusCode.RESOURCE_EXHAUSTED})
        self._rpc_error = grpc.RpcError
        if self.props["server"]:
            self._srv = _StreamServer(grpc, self.props["host"], self.props["port"],
                                      self.props["max-buffers"])
            self.bound_port = self._srv.port
        else:
            self._channel = grpc.insecure_channel(f"{self.props['host']}:{self.props['port']}",
                                                  options=GRPC_OPTS)
            self._stub = self._channel.unary_unary(
                "/nns.Stream/Send", request_serializer=_ident, response_deserializer=_ident)

    def stop(self) -> None:
        if self._srv is not None:
            try:  # EOS to pullers
                self._srv.outbox.put_nowait(None)
            except _queue.Full:
                pass
            self._srv.stop()
            self._srv = None
        if self._channel is not None:
            self._channel.close()
            self._channel = self._stub = None

    def _stopping(self) -> bool:
        p = self._pipeline
        return p is not None and p._stop_flag.is_set()

    def render(self, frame: TensorFrame) -> None:
        frame = frame.to_host()
        for f in frame.split() if isinstance(frame, BatchFrame) else (frame,):
            self._send(self._encode(f))

    def _send(self, payload: bytes) -> None:
        if self._srv is not None:
            self._srv.outbox.put(payload, timeout=10.0)
            return
        if self._stub is None:
            return
        # a server restart mid-stream: the channel reconnects by itself, so
        # the Send is retried with backoff inside retry-timeout
        deadline = time.monotonic() + max(0.0, self.props["retry-timeout"])
        backoff = 0.1
        while True:
            try:
                self._stub(payload, timeout=10.0)
                return
            except self._rpc_error as e:
                code = e.code() if hasattr(e, "code") else None
                if code not in self._retryable:
                    raise ElementError(f"{self.name}: Send failed ({code}): {e}") from None
                if self._stopping():
                    return  # the pipeline is tearing down
                if time.monotonic() >= deadline:
                    raise ElementError(f"{self.name}: Send failed after retries: {e}") from None
                self.log.info("grpc send failed; retrying in %.1fs", backoff)
                time.sleep(backoff)
                backoff = min(backoff * 2, 1.0)

    def handle_eos(self, pad):
        if self._srv is not None:
            try:
                self._srv.outbox.put(None, timeout=1.0)
            except _queue.Full:
                pass
        return None


@element("tensor_src_grpc")
class GrpcSrc(SourceElement):
    PROPERTIES = {
        "host": Property(str, "127.0.0.1", "bind/connect host"),
        "port": Property(int, 55115, "bind/connect port (0 = auto in server mode)"),
        "server": Property(bool, True, "run as gRPC server (peers Send)"),
        "idl": Property(str, "flex", "wire IDL: flex | protobuf | flatbuf (interop)"),
        "num-buffers": Property(int, -1, "EOS after N frames (-1 = forever)"),
        "timeout": Property(int, 10000, "ms without a frame before EOS"),
        "verify-checksum": Property(
            bool, True, "verify wire integrity checksums on received frames (flex v2 "
            "envelopes); corrupt frames are dropped and counted in health()"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._srv: Optional[_StreamServer] = None
        self._channel = None
        self._reader: Optional[threading.Thread] = None
        self.bound_port: Optional[int] = None
        self._reader_stop = threading.Event()
        self._decode = wire.decode_frame
        self._corrupt_dropped = 0

    def output_spec(self) -> StreamSpec:
        return ANY

    def start(self) -> None:
        grpc = self._grpc = _grpc(self)
        self._reader_stop.clear()
        try:
            _, self._decode = wire.get_codec(self.props["idl"])
        except wire.WireError as e:
            raise ElementError(f"{self.name}: {e}") from None
        if self.props["server"]:
            self._srv = _StreamServer(grpc, self.props["host"], self.props["port"], 64)
            self.bound_port = self._srv.port
        else:
            self._channel = grpc.insecure_channel(f"{self.props['host']}:{self.props['port']}",
                                                  options=GRPC_OPTS)

    def stop(self) -> None:
        self._reader_stop.set()
        if self._srv is not None:
            self._srv.stop()
            self._srv = None
        reader, self._reader = self._reader, None
        if self._channel is not None:
            self._channel.close()  # ends a Pull the reader is blocked in
            self._channel = None
        if reader is not None:
            reader.join(timeout=5)

    def _pull_loop(self, pull, inbox: "_queue.Queue") -> None:
        """Client mode: the Pull stream into ``inbox``; a broken stream is
        re-opened with backoff until stop (the inter-frame ``timeout`` is
        the only end of stream)."""
        stop, backoff = self._reader_stop, 0.1
        while not stop.is_set():
            try:
                for payload in pull(b"", timeout=None):
                    backoff = 0.1
                    while not stop.is_set():
                        try:
                            inbox.put(payload, timeout=0.25)
                            break
                        except _queue.Full:
                            continue
                    if stop.is_set():
                        return
            except self._grpc.RpcError as e:
                self.log.info("grpc pull broke (%s); retrying in %.1fs",
                              getattr(e, "code", lambda: e)(), backoff)
            except ValueError:  # the channel was closed under the call
                return
            if stop.wait(backoff):
                return
            backoff = min(backoff * 2, 2.0)

    def frames(self) -> Iterator[TensorFrame]:
        limit = self.props["num-buffers"]
        timeout_s = self.props["timeout"] / 1000.0
        if self._srv is not None:
            inbox = self._srv.inbox
        else:
            # a reader thread feeds an inbox so `timeout` is a real
            # inter-frame deadline (a bare stream iterator would block on a
            # stalled peer)
            inbox = _queue.Queue(64)
            pull = self._channel.unary_stream(
                "/nns.Stream/Pull", request_serializer=_ident, response_deserializer=_ident)
            self._reader = threading.Thread(target=self._pull_loop, args=(pull, inbox),
                                            name=f"{self.name}-pull", daemon=True)
            self._reader.start()
        n = 0
        while limit < 0 or n < limit:
            deadline = time.monotonic() + timeout_s
            payload = None
            while payload is None:
                if pipeline_quiescing(self):
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.log.info("grpc src timeout; ending stream")
                    return
                try:
                    payload = inbox.get(timeout=min(0.25, remaining))
                except _queue.Empty:
                    continue
            try:
                frame = self._decode(payload, verify=self.props["verify-checksum"])
            except wire.WireError as e:
                self._corrupt_dropped += 1
                self.log.warning("undecodable grpc frame dropped: %s", e)
                continue
            n += 1
            yield frame

    def health_info(self) -> dict:
        return {"corrupt_dropped": self._corrupt_dropped}
