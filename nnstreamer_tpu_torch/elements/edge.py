"""edgesink / edgesrc: tensor-stream pub/sub among devices.

Port of ``nnstreamer_tpu/elements/edge.py`` (≙ the reference's
``gst/edge/``, connect types TCP / HYBRID / MQTT / AITT in
``edge_common.c:23-35``).  edgesink publishes a stream, edgesrc subscribes.

``connect-type`` of edgesink:
  * ``tcp``: host a raw-TCP data channel (``distributed/tcp_edge.py``);
    needs nothing past sockets.  It binds ``host`` when that is set
    explicitly, else every address, as the JAX package does.
  * ``server`` (default): host a gRPC edge broker on ``port``;
  * ``client``: publish into a remote gRPC broker at ``dest-host:dest-port``;
  * ``hybrid``: host a gRPC broker and announce ``{host, port}`` as a
    RETAINED MQTT message on ``nns/edge/<topic>`` at the MQTT broker
    ``dest-host:dest-port`` (control over MQTT, data direct; the
    reference's ``CHANGES:8-13``).
edgesrc dials with ``tcp``, dials a gRPC broker with ``direct`` (default;
``server`` and ``client`` are accepted as its aliases), or reads the
announce first with ``hybrid``.  Every mode but ``tcp`` needs the ``grpc``
package and raises its typed error at ``start()`` without it: nothing
carries on over TCP in its place.

Timestamps: the publisher stamps ``wall_base`` (epoch seconds at pts 0) in
the meta, and with ``rebase-pts`` the subscriber moves pts into its own
clock.  A subscriber can fail over along ``dest-hosts`` and re-dial a
stream that ended (``max-reconnects``, ``reconnect-backoff``); frames that
fail their checksum are dropped and counted (``verify-checksum``).

edgesink never hands a card tensor to a transport: a frame comes to the
host on its render thread (a micro-batch with one copy per tensor) and is
encoded there.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Iterator, List, Optional, Tuple

from ..core.buffer import BatchFrame, TensorFrame
from ..core.lifecycle import pipeline_quiescing
from ..core.log import get_logger
from ..core.resilience import RetryPolicy
from ..core.types import ANY, StreamSpec
from ..distributed import wire
from ..pipeline.element import (
    ElementError,
    Property,
    SinkElement,
    SourceElement,
    element,
    enum_prop_check,
    parse_host_list,
)


def _control_topic(topic: str) -> str:
    return f"nns/edge/{topic}"


def _require_grpc(el, mode: str):
    from ..distributed.service import require_grpc

    return require_grpc(f"{el.name}: connect-type={mode}")


@element("edgesink")
class EdgeSink(SinkElement):
    BATCH_AWARE = True  # a micro-batch comes to the host in one copy per tensor

    PROPERTIES = {
        "port": Property(int, 0, "data port hosted here (0 = ephemeral; not with client)"),
        "dest-host": Property(str, "localhost", "remote broker host (client: gRPC; hybrid: MQTT)"),
        "dest-port": Property(int, 0, "remote broker port (client: gRPC; hybrid: MQTT)"),
        "topic": Property(str, "nns", "pub/sub topic"),
        "connect-type": Property(
            str, "server", "server (host a gRPC broker) | client | hybrid (announce over "
            "MQTT, data over gRPC) | tcp (host a raw-TCP data channel, no gRPC; ≙ reference "
            "edge TCP)",
            convert=enum_prop_check("connect-type", "server", "client", "hybrid", "tcp")),
        "host": Property(
            str, "127.0.0.1", "hybrid: address announced to subscribers; tcp: bind address "
            "when set (else every address)"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._broker = None
        self._pub = None
        self._tcp = None
        self._announcement = None
        self._wall_base: Optional[float] = None

    def start(self):
        mode = self.props["connect-type"]
        self._wall_base = None
        if mode == "tcp":
            from ..distributed.tcp_edge import TcpEdgeServer

            bind = self.props["host"] if "host" in self._explicit_props else "0.0.0.0"
            self._tcp = TcpEdgeServer(host=bind, port=self.props["port"])
            self.props["port"] = self._tcp.port
            return
        _require_grpc(self, mode)
        from ..distributed.service import EdgePublisher, get_edge_broker

        if mode == "client":
            self._pub = EdgePublisher(self.props["dest-host"], self.props["dest-port"],
                                      self.props["topic"])
            return
        self._broker = get_edge_broker(self.props["port"])
        try:
            self._broker.start()
            self.props["port"] = self._broker.port
            if mode == "hybrid":
                from ..distributed.hybrid import Announcement

                self._announcement = Announcement(
                    self.props["dest-host"], self.props["dest-port"],
                    _control_topic(self.props["topic"]),
                    {"host": self.props["host"], "port": self._broker.port}, logger=self.log)
        except Exception:
            self.stop()  # a failed start() is not stopped by the pipeline
            raise

    def stop(self):
        if self._pub is not None:
            self._pub.close()
            self._pub = None
        if self._announcement is not None:
            self._announcement.clear()
            self._announcement = None
        if self._tcp is not None:
            self._tcp.close()
            self._tcp = None
        if self._broker is not None:
            from ..distributed.service import release_edge_broker

            release_edge_broker(self._broker)
            self._broker = None

    def health_info(self) -> dict:
        """``dropped_full``: frames the hosted gRPC broker (server and hybrid
        modes) dropped for a subscriber's full queue.  The raw-TCP channel
        blocks on a slow subscriber instead and drops nothing."""
        broker = self._broker
        return {"dropped_full": broker.dropped_full if broker is not None else 0}

    def render(self, frame):
        frame = frame.to_host()
        for f in frame.split() if isinstance(frame, BatchFrame) else (frame,):
            self._publish(f)

    def _publish(self, frame: TensorFrame) -> None:
        if self._wall_base is None:
            self._wall_base = time.time() - (frame.pts or 0.0)
        frame.meta["wall_base"] = self._wall_base  # the cross-device sync anchor
        if self._tcp is not None:
            self._tcp.publish(self.props["topic"], wire.encode_frame_parts(frame))
        elif self._pub is not None:
            self._pub.publish_bytes(wire.encode_frame(frame))
        elif self._broker is not None:
            self._broker.publish_local(self.props["topic"], wire.encode_frame(frame))


class _TcpFrameSubscriber:
    """A :class:`~..distributed.tcp_edge.TcpEdgeSubscriber` as the frame
    iterator edgesrc consumes; frames that fail to decode are dropped and
    counted."""

    def __init__(self, sub, verify_checksum: bool = True):
        self._sub = sub
        self._verify = verify_checksum
        self.corrupt_dropped = 0

    def frames(self):
        for payload in self._sub.payloads():
            try:
                yield wire.decode_frame(payload, verify=self._verify)
            except wire.WireError as e:
                self.corrupt_dropped += 1
                get_logger("edgesrc").warning("undecodable tcp edge frame dropped: %s", e)

    def close(self):
        self._sub.close()


@element("edgesrc")
class EdgeSrc(SourceElement):
    PROPERTIES = {
        "dest-host": Property(str, "localhost", "publisher host (hybrid: MQTT broker)"),
        "dest-port": Property(int, 0, "publisher port (hybrid: MQTT broker)"),
        # multi-remote failover: tried in order at connect and re-dial time
        "dest-hosts": Property(
            str, "", "failover publisher list 'h1:p1,h2:p2' (overrides dest-host/dest-port; "
            "direct/tcp only)"),
        "topic": Property(str, "nns", "pub/sub topic"),
        "caps": Property(str, "", "announced schema"),
        "connect-type": Property(
            str, "direct", "direct (dial the gRPC data broker; server and client are its "
            "aliases) | hybrid (discover the gRPC data endpoint over MQTT) | tcp (dial a "
            "raw-TCP edgesink, no gRPC)",
            convert=enum_prop_check("connect-type", "direct", "server", "client", "hybrid",
                                    "tcp")),
        "discovery-timeout": Property(float, 10.0, "hybrid: seconds to wait for the announce"),
        "rebase-pts": Property(bool, True, "rebase pts into the local clock"),
        "max-reconnects": Property(
            int, 0, "re-dial attempts PER stream break (the budget refills on every "
            "successful reconnect; 0 = end the stream)"),
        "reconnect-backoff": Property(
            float, 0.2, "base seconds between re-dials (doubles per attempt, capped at 2s)"),
        "verify-checksum": Property(
            bool, True, "verify wire integrity checksums on received frames (v2 envelopes); "
            "corrupt frames are dropped and counted in health()"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._sub = None
        self._targets: List[Tuple[str, int]] = []
        self._next_target = 0
        self._corrupt_base = 0  # corrupt drops of subscribers retired by re-dials

    def _discover(self) -> Tuple[str, int]:
        """The data endpoint from the retained announce (one fixed topic:
        no settle window)."""
        from ..distributed.hybrid import discover_endpoints

        found = discover_endpoints(
            self.props["dest-host"], self.props["dest-port"], _control_topic(self.props["topic"]),
            timeout_s=self.props["discovery-timeout"], settle_s=0.0, logger=self.log)
        if not found:
            raise ElementError(f"{self.name}: no edge announce for topic "
                               f"{self.props['topic']!r} within "
                               f"{self.props['discovery-timeout']}s")
        return next(iter(found.values()))

    def _dial(self, host: str, port: int, probe: bool = False):
        verify = bool(self.props["verify-checksum"])
        if self.props["connect-type"] == "tcp":
            from ..distributed.tcp_edge import TcpEdgeSubscriber

            return _TcpFrameSubscriber(TcpEdgeSubscriber(host, port, self.props["topic"]),
                                       verify_checksum=verify)
        if probe or len(self._targets) > 1:
            # a gRPC channel connects lazily and never fails at dial time:
            # failover (and the re-dial budget) probes the endpoint first.
            # A lone target at start() stays lazy (its publisher may start
            # later)
            from ..distributed.hybrid import probe_endpoint

            if not probe_endpoint(host, port):
                raise ConnectionError(f"edge endpoint {host}:{port} not accepting")
        from ..distributed.service import EdgeSubscriber

        return EdgeSubscriber(host, port, self.props["topic"], verify_checksum=verify)

    def _connect_any(self, probe: bool = False):
        """The first publisher of the target list that answers, from the
        rotation cursor on."""
        last: Optional[BaseException] = None
        n = len(self._targets)
        for k in range(n):
            host, port = self._targets[(self._next_target + k) % n]
            try:
                sub = self._dial(host, port, probe=probe)
                self._next_target = (self._next_target + k) % n
                return sub
            except Exception as e:  # noqa: BLE001 — transport boundary
                last = e
                self.log.warning("edge dial %s:%d failed: %s", host, port, e)
        raise last if last is not None else ConnectionError("no edge targets")

    def start(self):
        mode = self.props["connect-type"]
        if mode != "tcp":
            _require_grpc(self, mode)  # before discovery: no fallback of any kind
        self._corrupt_base = 0
        if mode == "hybrid":
            self._targets = [self._discover()]
        elif self.props["dest-hosts"]:
            self._targets = parse_host_list(self.props["dest-hosts"], self.name, "dest-hosts")
        else:
            self._targets = [(self.props["dest-host"], self.props["dest-port"])]
        self._sub = self._connect_any()

    def stop(self):
        sub, self._sub = self._sub, None
        if sub is not None:
            sub.close()

    def output_spec(self) -> StreamSpec:
        text = self.props["caps"]
        return StreamSpec.from_string(text) if text else ANY

    def health_info(self) -> dict:
        return {"corrupt_dropped": self._corrupt_base + getattr(self._sub, "corrupt_dropped", 0)}

    def _backoff_wait(self, delay: float) -> bool:
        """Sleep ``delay`` seconds; True if the pipeline stopped meanwhile."""
        if self._pipeline is not None:
            return self._pipeline._stop_flag.wait(delay)
        time.sleep(delay)
        return False

    @staticmethod
    def _pump(sub, out: "_queue.Queue", done: threading.Event) -> None:
        """One subscriber's frames into ``out``, then None; a put waits in
        slices so a closed stream never parks this thread."""
        def put(item) -> bool:
            while not done.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        try:
            for frame in sub.frames():
                if not put(frame):
                    return
        except Exception:  # allow-silent: stream cancelled / peer gone; the None says it
            pass
        finally:
            put(None)

    def _redial(self, state: dict) -> bool:
        """Re-dial after a stream ended, within ``max-reconnects`` attempts
        (capped exponential backoff with jitter, rotating through the
        targets; hybrid reads the announce again).  True once a new
        subscriber is attached."""
        base = max(0.0, float(self.props["reconnect-backoff"]))
        policy = RetryPolicy(base_delay_s=base, max_delay_s=2.0, jitter=0.1)
        while state["left"] > 0:
            state["left"] -= 1
            delay = policy.delay_for(state["failed"] + 1) if base else 0.0
            if delay > 0 and self._backoff_wait(delay):
                return False
            try:
                old, self._sub = self._sub, None
                if old is not None:
                    self._corrupt_base += getattr(old, "corrupt_dropped", 0)
                    old.close()
                if self.props["connect-type"] == "hybrid":
                    self._targets = [self._discover()]  # it may be back elsewhere
                self._next_target = (self._next_target + 1) % max(1, len(self._targets))
                self._sub = self._connect_any(probe=True)
            except Exception as e:  # noqa: BLE001 — transport boundary
                state["failed"] += 1
                self.log.warning("edge reconnect failed: %s", e)
                continue
            state["failed"] = 0
            state["left"] = int(self.props["max-reconnects"])  # per break
            self.log.info("edge stream re-established")
            return True
        return False

    def frames(self) -> Iterator[TensorFrame]:
        local_epoch = time.time()
        state = {"left": int(self.props["max-reconnects"]), "failed": 0}
        while True:
            out: "_queue.Queue[Optional[TensorFrame]]" = _queue.Queue(64)
            done = threading.Event()
            pump = threading.Thread(target=self._pump, args=(self._sub, out, done),
                                    name=f"{self.name}-pump", daemon=True)
            pump.start()
            ended = False
            try:
                while True:
                    try:
                        frame = out.get(timeout=0.1)
                    except _queue.Empty:
                        if pipeline_quiescing(self):
                            return
                        continue
                    if frame is None:
                        ended = True
                        break
                    wall_base = frame.meta.get("wall_base")
                    if self.props["rebase-pts"] and frame.pts is not None \
                            and wall_base is not None:
                        frame.pts = (wall_base + frame.pts) - local_epoch
                    yield frame
            finally:
                done.set()
                if not ended and self._sub is not None:
                    self._sub.close()  # ends the pump's blocking read
                pump.join(timeout=5)
            if pipeline_quiescing(self) or not self._redial(state):
                return
