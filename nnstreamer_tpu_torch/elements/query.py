"""tensor_query_* elements: inference offload to a server pipeline.

Port of ``nnstreamer_tpu/elements/query.py`` (≙ the reference's
``tensor_query_client.c``, ``tensor_query_serversrc.c`` and
``tensor_query_serversink.c``): ``tensor_query_client`` sends frames to a
remote server pipeline and emits its answers in order;
``tensor_query_serversrc`` is the server pipeline's entry and
``tensor_query_serversink`` returns each answer to its client by the
``client_id`` meta, the two paired by ``id`` (``distributed/service.py``).

The client pipelines ``max-in-flight`` requests with ordered delivery,
ships already-queued frames in one wire micro-batch (``wire-batch``),
fans out over ``hosts=h1:p1,h2:p2`` with routing policies, affinity and
per-remote circuit breakers (``core/routing.py``, ``core/resilience.py``),
retries BUSY, GOAWAY and corrupt exchanges on budgets of their own, and
streams generation answers (``stream=true``).  The server side admits per
tenant, sheds BUSY under load or card-memory pressure, refuses corrupt
requests, and drains with GOAWAY.  Both transports, ``connect-type=grpc``
(the default, as in the JAX package; needs the ``grpc`` package) and
``connect-type=tcp`` (``distributed/tcp_query.py``), speak the JAX
package's bytes.  The elements never touch the card: the serversink
brings answers to the host (one copy per tensor of a micro-batch) before
a transport thread encodes them.

The discovery plane (``distributed/hybrid.py``, ≙ the reference's HYBRID
connect type): a serversrc with ``topic`` and ``dest-port`` announces its
endpoint as a retained MQTT message on ``nns/query/<topic>/<instance>``
(failing over along ``dest-brokers``, announced again after every broker
reconnect), publishes ``draining:true`` when it drains and
``degraded:true`` on ``Pipeline.degraded_feedback``, and deletes the
announce at stop.  A client with ``topic`` and ``dest-port`` and no
``hosts`` discovers the servers instead, through its own ``dest-brokers``
standbys when its broker refuses or dies during discovery (a client that
starts or rediscovers during a broker failover; the JAX package's client
has no such list): announces of another transport are skipped, every endpoint is probed concurrently (a crashed server never
deletes its announce), and the announced states become routing hints
(``TIER_DRAINING``, ``TIER_DEGRADED``) that age out after
``_HINT_TTL_S``.  A failure wave on a discovered pool rediscovers once and
swaps the pool, keeping live connections.

The fleet's control loop (``core/fleet.py``, ``core/autoscale.py``): an
announcing serversrc publishes a telemetry digest every
``digest-interval`` seconds on the pipeline's watchdog sweeper, through
the retained announce (host counters only: admission, the slot engines'
``health()`` rows, the memory monitor), and once more on every state
change and at stop.  ``request_drain(epoch)`` is fenced: an epoch older
than one already accepted raises ``StaleEpochError`` before anything is
touched (``stale_epoch_rejects``).  A drain first tells the pipeline
(``Pipeline.stream_drain_feedback``), so a slotted generator hands its
live streams off as resumable GOAWAY chunks.

Stream continuity (``core/continuity.py``): with ``stream-resume=true``
(the default) a stream whose chunks carry resume state outlives its
server.  A break mid-stream, a draining server's hand-off chunk or a
resume refusal makes the client's ledger build a RESUME request (prompt +
delivered prefix, snapped to a chunk boundary) for the healthiest server;
the ledger drops the re-decoded overlap, so every token is delivered once
and in order, with contiguous ``chunk_index``.  ``resume-retries``
attempts without progress end it (each delivered chunk refills them).
The counters ``stream_resumes`` (breaks), ``stream_migrations``
(hand-offs), ``duplicate_tokens_dropped`` and ``resume_failures`` are
exact.  ``stream-resume=false`` keeps the no-replay semantics: a break
after the first answer surfaces as an error.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Deque, Iterator, List, Optional, Tuple

from ..core.autoscale import FencingToken
from ..core.buffer import BatchFrame, TensorFrame
from ..core.continuity import StreamContinuity, prefix_route_key
from ..core.lifecycle import ServerGoawayError
from ..core.liveness import (
    DEADLINE_META,
    PRIORITY_MAX,
    PRIORITY_META,
    TENANT_META,
    ServerBusyError,
    TenantAdmissionController,
    deadline_remaining,
    parse_tenant_quotas,
)
from ..core.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    RemoteApplicationError,
    RetryPolicy,
    is_remote_application_error,
)
from ..core.routing import (
    TIER_DEGRADED,
    TIER_DOWN,
    TIER_DRAINING,
    TIER_OK,
    ewma_scores,
    order_remotes,
    rendezvous_owner,
)
from ..core.telemetry import (
    REGISTRY,
    SPAN_META,
    SRV_SPAN_META,
    TL_ENQ_META,
    TRACE_ID_META,
    SloTracker,
    new_trace_id,
)
from ..core.types import ANY, StreamSpec
from ..distributed.service import QueryConnection, get_query_server, release_query_server
from ..distributed.wire import WireError
from ..pipeline.element import (
    Element,
    ElementError,
    Property,
    SinkElement,
    SourceElement,
    element,
    enum_prop_check,
    parse_host_list,
)

def _check_connect_type(el: Element) -> str:
    ct = el.props["connect-type"]
    if ct not in ("grpc", "tcp"):
        raise ElementError(f"{el.name}: connect-type={ct!r} (want grpc|tcp)")
    return ct


@element("tensor_query_serversrc")
class TensorQueryServerSrc(SourceElement):
    #: a thread boundary below this source: admission's in-flight window
    #: fills only when request pull and server-pipeline work overlap
    FUSE_DOWNSTREAM = False
    #: this source runs its own serving -> draining -> stopped machine in
    #: frames(): the scheduler must not cut the pull loop at the drain
    #: flag, or requests admitted before the drain never reach the pipeline
    OWNS_DRAIN = True

    PROPERTIES = {
        "port": Property(int, 0, "listen port (0 = ephemeral)"),
        "host": Property(str, "[::]", "bind address"),
        "id": Property(int, 0, "pairs this src with the serversink of same id"),
        "connect-type": Property(
            str, "grpc",
            "transport: grpc (interop default; needs the grpc package) | tcp (copy-free "
            "raw TCP, ≙ reference nns-edge TCP)"),
        "caps": Property(str, "", "announced input schema for the handshake"),
        # hybrid discovery (≙ reference connect-type=HYBRID): a RETAINED
        # announce on nns/query/<topic>/<instance> lets clients resolve
        # servers from the broker instead of a static host list
        "topic": Property(str, "", "announce endpoint under this topic"),
        "dest-host": Property(str, "localhost", "MQTT broker host (discovery)"),
        "dest-port": Property(int, 0, "MQTT broker port (0 = announcing disabled)"),
        "dest-brokers": Property(
            str, "", "failover broker list 'host:port,host:port' tried in order after "
            "dest-host:dest-port; the announce is published again on every reconnect"),
        "block-ingress": Property(
            bool, False,
            "inject each wire micro-batch as ONE BatchFrame so the server pipeline pays "
            "per-frame costs once per batch (the answers split back per client in the "
            "serversink)"),
        "max-inflight": Property(
            int, 0, "admission high watermark: concurrent requests admitted before the "
            "server sheds with BUSY (0 = unlimited)"),
        "low-watermark": Property(
            int, 0, "admission hysteresis: once shedding, keep refusing until in-flight "
            "drains to this (0 = max-inflight/2)"),
        "retry-after": Property(
            float, 0.05, "seconds suggested to BUSY-shed clients before they retry "
            "(per-tenant sheds scale this with the tenant's shed streak)"),
        "tenant-quota": Property(
            int, 0, "default per-tenant in-flight quota (0 = unlimited): a tenant over "
            "its quota is shed with BUSY while other tenants keep being served"),
        "tenant-quotas": Property(
            str, "", "per-tenant quota overrides 'tenantA:8,tenantB:4' (tenants absent "
            "here use tenant-quota)"),
        "shed-window": Property(
            float, 5.0, "seconds of uninterrupted tenant-quota shedding before a "
            "rate-limited flight-recorder incident names the tenant"),
        "mem-high-watermark": Property(
            float, 0.0, "arm the pipeline's memory-pressure monitor at this card-memory "
            "(or host-RSS) fraction: crossing it sheds every request with BUSY "
            "(reason=memory) and trims caches until pressure clears (0 = off)"),
        "mem-low-watermark": Property(
            float, 0.0, "pressure clears once the fraction falls back to this "
            "(0 = 0.8 * high)"),
        "mem-sustain": Property(
            float, 2.0, "seconds of sustained pressure before a rate-limited "
            "memory_pressure flight-recorder incident"),
        "verify-checksum": Property(
            bool, True, "verify wire checksums on received requests (v2 envelopes); "
            "corrupt requests are refused with a resend-safe reply and counted"),
        "wire-version": Property(
            int, 2, "max wire version this server speaks: 2 = checksummed envelopes + "
            "per-connection negotiation with v1 clients; 1 = legacy framing"),
        "drain-deadline": Property(
            float, 10.0, "max seconds a drain waits for in-flight requests to finish "
            "before closing the listeners anyway"),
        "digest-interval": Property(
            float, 2.0, "seconds between telemetry-digest publishes on the discovery plane "
            "(0 = digests off; state changes and stop still force a final publish)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._core = None
        self._announcement = None
        self._drain_requested = threading.Event()
        self._lc_state = "serving"  # serving | draining | stopped
        # a serving element of this pipeline lost a device and re-sharded:
        # the announce carries it (fleet routing: TIER_DEGRADED)
        self._degraded = False
        # the telemetry-digest publisher (armed in start() when announcing,
        # polled on the watchdog sweeper)
        self._digest = None
        # lease fencing: the highest controller epoch accepted; an older
        # one's drain is refused before it touches anything
        self._fence = FencingToken()

    def request_drain(self, epoch=None) -> None:
        """Begin the rolling-restart drain of this server: GOAWAY to new
        requests, hand live generation streams off, finish in-flight ones
        (bounded by ``drain-deadline``), close the listeners, end the
        stream.  ``epoch`` is the commanding controller's lease epoch: one
        older than an epoch already accepted raises
        :class:`~..core.autoscale.StaleEpochError` and the server serves on
        untouched (None: an operator's command, never fenced)."""
        self._fence.check(epoch)
        self._drain_requested.set()

    @property
    def drain_complete(self) -> bool:
        """True once a requested drain has completed: listeners closed,
        stream ended."""
        return self._lc_state == "stopped"

    def start(self):
        ct = _check_connect_type(self)
        self._drain_requested.clear()
        self._lc_state = "serving"
        self._core = core = get_query_server(self.props["id"], self.props["port"])
        try:
            self._configure(core, ct)
            self.props["port"] = core.port  # the bound port (ephemeral binds)
            if self.props["topic"] and self.props["dest-port"] > 0:
                self._announce()
                self._arm_digest()
        except Exception:
            # the pipeline's rollback stops only elements whose start()
            # succeeded: release the core here or its listener leaks
            self.stop()
            raise

    def _arm_digest(self) -> None:
        """The digest publisher, polled on the pipeline's watchdog sweeper
        (registered before the sweeper is armed): no per-frame cost."""
        interval = float(self.props["digest-interval"])
        if interval <= 0:
            return
        from ..core.fleet import DigestPublisher

        self._digest = DigestPublisher(self._digest_stats, self._publish_digest,
                                       interval_s=interval, name=self.name)
        p = self._pipeline
        if p is not None:
            p.register_sweep(self._digest.poll, min(interval, 1.0))

    def _digest_stats(self) -> dict:
        """One digest's raw numbers: this server's admission ledger and the
        pipeline-wide scan (``core/fleet.pipeline_digest_stats``).  Any
        state but serving reads as draining: a drained server's sweeper
        runs on until its pipeline stops, and no digest may flip the
        announce back to draining=false while its listeners are closed."""
        from ..core.fleet import pipeline_digest_stats

        stats: dict = {"draining": self._lc_state != "serving", "degraded": self._degraded}
        core = self._core
        if core is not None:
            snap = core.admission.snapshot()
            stats.update(inflight=snap["inflight"], admitted=snap["admitted"],
                         shed=snap["shed"], tenants=snap.get("tenants", {}))
        p = self._pipeline
        if p is not None:
            stats.update(pipeline_digest_stats(p))
        return stats

    def _publish_digest(self, digest: dict) -> None:
        """Ship one digest through the retained announce without waiting for
        the broker's ack (the sweeper must not stall).  The top-level
        draining/degraded keys ride along for clients that read no digest.
        During a broker outage the update raises (``require_connected``),
        so the publisher counts one failure per missed interval."""
        ann = self._announcement
        if ann is None:
            return
        ann.update({"digest": digest, "draining": bool(digest.get("draining", False)),
                    "degraded": bool(digest.get("degraded", False))},
                   wait_ack=False, require_connected=True)

    def publish_digest(self, force: bool = True):
        """Publish a digest now (an operator's or a test's hook; the
        periodic path is the sweeper's poll)."""
        if self._digest is None:
            return None
        return self._digest.poll(force=force)

    def _announce(self) -> None:
        """The retained per-instance endpoint announce on the MQTT control
        plane (``distributed/hybrid.py``)."""
        import os
        import uuid

        from ..distributed.hybrid import Announcement

        host = self.props["host"]
        if host in ("[::]", "0.0.0.0", ""):
            # a bind-all address is not dialable: announce loopback (a
            # multi-host deployment sets host= to a reachable address)
            host = "127.0.0.1"
        brokers = (parse_host_list(self.props["dest-brokers"], self.name, "dest-brokers")
                   if self.props["dest-brokers"].strip() else None)
        # element names repeat across pipelines: pid + uuid make the
        # instance unique across the pod
        self._announcement = Announcement(
            self.props["dest-host"], self.props["dest-port"],
            f"nns/query/{self.props['topic']}/{self.name}-{os.getpid()}-{uuid.uuid4().hex[:8]}",
            {"host": host, "port": self._core.port, "connect_type": self.props["connect-type"],
             "draining": False, "degraded": self._degraded, "inflight": 0},
            logger=self.log, brokers=brokers)

    def _announce_state(self, draining: bool) -> None:
        """Publish the announce again with this server's live state.  Runs
        on the request pump, so it never waits for the broker's ack: a
        slow broker must not stall the requests a drain protects."""
        if self._announcement is None:
            return
        if self._digest is not None:
            # one publish carries the state flags and a fresh digest, so the
            # digest's own draining/degraded never lag the announce's
            self._digest.poll(force=True)
            return
        try:
            self._announcement.update({
                "draining": bool(draining), "degraded": bool(self._degraded),
                "inflight": self._core.admission.inflight if self._core is not None else 0,
            }, wait_ack=False)
        except Exception as e:  # noqa: BLE001 — broker I/O is best-effort
            self.log.warning("announce state update failed: %s", e)

    def note_degraded(self, detail: str = "") -> None:
        """``Pipeline.degraded_feedback``: an element of this pipeline lost
        a device and re-sharded onto survivors.  The announce turns
        ``degraded:true``, so fleet routing ranks this server below whole
        ones (``TIER_DEGRADED``) while it keeps serving."""
        if self._degraded:
            return
        self._degraded = True
        self.log.warning("server degraded (%s); announcing degraded:true", detail)
        self._announce_state(draining=self._lc_state == "draining")

    def _configure(self, core, ct: str) -> None:
        core.draining = False  # a restart after a drain serves again
        if self.props["caps"]:
            core.caps = self.props["caps"]
        core.block_ingress = bool(self.props["block-ingress"])
        try:
            core.admission = TenantAdmissionController(
                int(self.props["max-inflight"]),
                int(self.props["low-watermark"]) or None,
                default_quota=int(self.props["tenant-quota"]),
                quotas=parse_tenant_quotas(self.props["tenant-quotas"],
                                           f"{self.name}: tenant-quotas"),
                shed_window_s=float(self.props["shed-window"]),
                on_sustained_shed=self._on_sustained_shed,
            )
        except ValueError as e:
            raise ElementError(f"{self.name}: {e}") from None
        # memory watermarks: admission sheds BUSY (reason=memory) while the
        # pipeline's monitor reads pressure, before the card runs out
        core.admission.pressure = self._memory_pressured
        high = float(self.props["mem-high-watermark"])
        p = self._pipeline
        if high > 0 and p is not None and p.memory_monitor is None:
            low = float(self.props["mem-low-watermark"]) or high * 0.8
            try:
                # before the pipeline arms its watchdog, so the sweeper
                # thread polls the monitor
                p.enable_memory_monitor(high=high, low=low,
                                        sustain_s=float(self.props["mem-sustain"]))
            except ValueError as e:
                raise ElementError(f"{self.name}: {e}") from None
        core.busy_retry_after = float(self.props["retry-after"])
        core.verify_checksum = bool(self.props["verify-checksum"])
        core.wire_version = 2 if int(self.props["wire-version"]) >= 2 else 1
        if ct == "tcp":
            core.start_tcp()
        else:
            core.start()

    def _memory_pressured(self) -> bool:
        p = self._pipeline
        mon = p.memory_monitor if p is not None else None
        return mon is not None and mon.pressured

    def _on_sustained_shed(self, tenant: str) -> None:
        """A tenant's quota sheds outlasted shed-window: a flight-recorder
        incident names the tenant (rate-limited)."""
        self.log.warning("tenant %r quota-shed sustained for > %.1fs; recording incident",
                         tenant, float(self.props["shed-window"]))
        p = self._pipeline
        if p is not None:
            p.incident("tenant_shed", self.name, f"tenant={tenant}")

    def stop(self):
        if self._announcement is not None:
            if self._digest is not None:
                # a last digest before the tombstone: sources stop first, so
                # the slot engines and the admission ledger are still live,
                # and the observatory retires this server's final counters
                self._digest.poll(force=True)
            self._announcement.clear()
            self._announcement = None
        self._digest = None
        if self._core is not None:
            release_query_server(self.props["id"])
            self._core = None

    def output_spec(self) -> StreamSpec:
        text = self.props["caps"]
        return StreamSpec.from_string(text) if text else ANY

    def pending_frames(self) -> int:
        """Requests admitted and queued for the server pipeline (drain and
        stop accounting)."""
        core = self._core
        return core.ingress.qsize() if core is not None else 0

    def health_info(self) -> dict:
        """Admission, integrity and drain counters, the announce's
        reconnect counters (``nns.query.reannounces``,
        ``nns.query.plane_reconnects``) while announcing, and the memory
        monitor's watermark gauges (``nns.mem.*``) when one is armed."""
        info = {"lifecycle": self._lc_state, "degraded": 1 if self._degraded else 0,
                "stale_epoch_rejects": self._fence.rejects, "fence_epoch": self._fence.epoch}
        ann = self._announcement
        if ann is not None:
            info["reannounces"] = ann.reannounces
            info["plane_reconnects"] = ann.reconnects
        if self._digest is not None:
            info["digests_published"] = self._digest.published
            info["digest_publish_failures"] = self._digest.publish_failures
        if self._core is not None:
            info.update(self._core.liveness_snapshot())
        p = self._pipeline
        mon = p.memory_monitor if p is not None else None
        if mon is not None:
            info.update(mon.snapshot())
        return info

    def frames(self) -> Iterator[TensorFrame]:
        """The request pump and its drain state machine: ``serving`` pulls
        admitted requests; ``draining`` (``request_drain`` or a pipeline
        ``drain()``) refuses new requests with GOAWAY while admitted ones
        keep flowing, and once nothing is in flight (or ``drain-deadline``
        passed) closes the listeners and ends the stream (``stopped``)."""
        core = self._core
        drain_deadline = None
        while True:
            p = self._pipeline
            if self._lc_state == "serving" and (
                    self._drain_requested.is_set() or (p is not None and p.draining)):
                self._lc_state = "draining"
                core.begin_drain()
                # live generation streams hand off as resumable GOAWAY
                # chunks and their clients migrate them; each hand-off holds
                # its admission slot until its final chunk is out
                if p is not None:
                    p.stream_drain_feedback()
                # the discovery plane first: clients that rank remotes from
                # the broker stop picking this server without a GOAWAY each
                self._announce_state(draining=True)
                drain_deadline = time.monotonic() + max(0.0, float(self.props["drain-deadline"]))
            try:
                _client_id, frame = core.ingress.get(timeout=0.05)
            except _queue.Empty:
                if p is not None and p._stop_flag.is_set():
                    return
                if self._lc_state == "draining":
                    done = core.drain_complete
                    if done or time.monotonic() >= drain_deadline:
                        if not done:
                            self.log.warning(
                                "drain-deadline expired with %d request(s) still in flight; "
                                "closing listeners", core.admission.inflight)
                        core.close_listeners()
                        self._lc_state = "stopped"
                        self.log.info("query server drained and stopped accepting "
                                      "(goaway_sent=%d)", core.goaway_sent)
                        return
                continue
            yield frame  # client_id meta was attached at ingest


@element("tensor_query_serversink")
class TensorQueryServerSink(SinkElement):
    BATCH_AWARE = True  # splits block answers per client

    PROPERTIES = {
        "id": Property(int, 0, "pairs with the serversrc of the same id"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
        # ≙ tensor_query_serversink.c `limit`
        "limit": Property(int, 0, "max queued answers per client (0 = unbounded)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._core = None

    def start(self):
        self._core = get_query_server(self.props["id"])

    def stop(self):
        if self._core is not None:
            release_query_server(self.props["id"])
            self._core = None

    def render(self, frame):
        # answers leave on transport threads, which never touch the card:
        # card payloads come to the host here, one copy per tensor of a
        # micro-batch
        frame = frame.to_host()
        if isinstance(frame, BatchFrame):
            for f in frame.split():
                self.render(f)
            return
        client_id = frame.meta.get("client_id")
        if client_id is None:
            raise ElementError(
                f"{self.name}: frame lacks client_id meta (did it pass through an element "
                "that drops meta?)")
        delivered = self._core.resolve(int(client_id), frame, limit=self.props["limit"])
        if (not delivered and frame.meta.get("final") is False
                and not self._core.client_live(int(client_id))):
            # a mid-stream chunk for a vanished client: upstream slot
            # engines free the dead stream's slot now
            p = self._pipeline
            if p is not None:
                p.stream_cancel_feedback(self, frame.meta)


class _PoolState:
    """One generation of the client's connection pool: index-aligned
    ``conns``/``targets``/``addrs`` and this generation's ``down_until``
    health map (cooldowns), captured once per request by each worker.
    ``gen`` counts rediscovery swaps; ``epoch`` names the ``start()`` run,
    so a worker left over from an earlier run never swaps the new pool."""

    __slots__ = ("conns", "targets", "addrs", "gen", "epoch", "down_until")

    def __init__(self, conns, targets, gen: int = 0, epoch: int = -1):
        self.conns = tuple(conns)
        self.targets = tuple(targets)
        self.addrs = tuple(f"{h}:{p}" for h, p in targets)
        self.gen, self.epoch = gen, epoch
        self.down_until: dict = {}


class _StreamInterrupt(Exception):
    """One transport attempt of a resumable stream ended before the stream
    did: ``kind`` is ``"break"`` (a crash, breaker and cooldown recorded),
    ``"handoff"`` (a draining server's planned hand-off) or ``"reject"``
    (the server refused the resume); ``cause`` surfaces when the budget
    runs out."""

    def __init__(self, cause: BaseException, kind: str):
        super().__init__(str(cause))
        self.cause = cause
        self.kind = kind


@element("tensor_query_client")
class TensorQueryClient(Element):
    """Looks like a local filter; round-trips frames through remote server
    pipelines with pipelined, order-preserving dispatch."""

    BATCH_AWARE = True  # blocks map onto the wire micro-batch envelope
    #: answers are pipelined: an error on frame B may belong to in-flight
    #: frame A, so the scheduler's skip/restart policies cannot attribute
    #: it; the element degrades by its own `degrade=` instead
    SUPERVISES_OWN_ERRORS = True
    #: never fused: its idle hook releases answers that landed while no
    #: frame arrived (a sparse live stream)
    THREAD_BOUNDARY = True

    PROPERTIES = {
        "host": Property(str, "localhost", "server host"),
        "port": Property(int, 0, "server port"),
        "hosts": Property(str, "", "multi-server fan-out 'h1:p1,h2:p2'"),
        # hybrid discovery (≙ reference connect-type=HYBRID): the server set
        # from the retained announces on nns/query/<topic>/#
        "topic": Property(str, "", "discover servers under this topic"),
        "dest-host": Property(str, "localhost", "MQTT broker host (discovery)"),
        "dest-port": Property(int, 0, "MQTT broker port (0 = discovery disabled)"),
        "dest-brokers": Property(
            str, "", "standby brokers 'host:port,host:port' that discovery fails over to, in "
            "order, when dest-host:dest-port refuses or dies before an announce came"),
        "discovery-timeout": Property(float, 5.0, "s to wait for at least one announced server"),
        "timeout": Property(float, 10.0, "per-request timeout, seconds"),
        "max-in-flight": Property(int, 8, "pipelined outstanding requests"),
        "routing": Property(
            str, "rotate",
            "remote selection policy: rotate (round-robin) | least-inflight (fewest live "
            "in-flight requests to the remote) | ewma (lowest end-to-end latency EWMA from "
            "the trace spans, in-flight tie-break).  All policies rank breaker-open and "
            "cooled-down remotes below every healthy alternative",
            convert=enum_prop_check("routing", "rotate", "least-inflight", "ewma")),
        "affinity-key": Property(
            str, "",
            "consistent-hash session affinity: frames whose meta carries this key stick "
            "to the key's rendezvous-hash owner among the servers (failover still "
            "applies when the owner is unhealthy).  'prefix' routes by the prompt's "
            "grain-aligned prefix digest when the meta has no 'prefix' key.  Empty = "
            "no affinity"),
        "tenant": Property(
            str, "", "tenant identity stamped into request meta (frames already carrying "
            "a tenant keep theirs)"),
        "priority": Property(
            int, 3, "priority class 0..3 stamped into request meta (3 = highest; lower "
            "classes shed first under server overload)"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
        "retries": Property(
            int, 0, "re-send attempts per request (0 = none; >0 = at-least-once delivery)"),
        "busy-retries": Property(
            int, 3, "extra paced re-sends when the server sheds with BUSY (own budget; "
            "0 = treat BUSY like any other failure)"),
        "corrupt-retries": Property(
            int, 2, "extra paced re-sends when an exchange fails integrity verification "
            "(own budget; corruption counts against the remote's breaker)"),
        "verify-checksum": Property(
            bool, True, "verify wire checksums on replies (v2 envelopes)"),
        "wire-version": Property(
            int, 2, "max wire version to negotiate (tcp): 2 = checksummed envelopes with "
            "per-connection fallback to v1 peers; 1 = force legacy framing"),
        "retry-backoff": Property(
            float, 0.05, "base seconds between failover attempts (doubles per attempt, "
            "capped at 1s; 0 = immediate)"),
        "breaker-threshold": Property(
            int, 5, "per-remote circuit breaker: window failures that trip it open "
            "(0 = breaker disabled)"),
        "breaker-reset": Property(
            float, 5.0, "seconds a tripped breaker stays open before half-open probing"),
        "degrade": Property(
            str, "error", "on total remote failure: error | passthrough | skip",
            convert=enum_prop_check("degrade", "error", "passthrough", "skip")),
        "wire-batch": Property(int, 1, "max frames per request (1 = no batching)"),
        "stream": Property(
            bool, False,
            "server-streaming invoke (gRPC InvokeStream / raw-TCP 'S' message): answer "
            "frames are emitted as the remote pipeline produces them until a "
            "final-flagged one arrives; wire-batch must be 1"),
        "stream-resume": Property(
            bool, True,
            "resume a broken generation stream on another server from its delivered-token "
            "checkpoint, and migrate streams a draining server hands off with resumable "
            "GOAWAY chunks; false = no replay (a mid-stream break surfaces as an error).  "
            "Only streams whose chunks carry resume state take part"),
        "resume-retries": Property(
            int, 3,
            "consecutive resume attempts without progress before a stream gives up (each "
            "delivered chunk refills the budget); exhaustion records an incident and "
            "surfaces the break"),
        "slo-ttft-p95": Property(
            float, 0.0, "client-observed TTFT objective: 95% of streams must see their "
            "first chunk within this many seconds (0 = off)"),
        "slo-token-p99": Property(
            float, 0.0, "client-observed per-token objective: 99% of token inter-arrivals "
            "under this many seconds (0 = off)"),
        "slo-availability": Property(
            float, 0.0, "goodput objective, e.g. 0.999: streams completed / streams "
            "classified (0 = off)"),
        "connect-type": Property(
            str, "grpc",
            "transport: grpc (interop default; needs the grpc package) | tcp (copy-free "
            "raw TCP with sendmsg gather-writes and a per-client socket pool)"),
    }

    _SPAN_EWMA = 0.2  # smoothing of the per-remote load signal
    _AFFINITY_MAP_MAX = 4096  # LRU bound on tracked affinity keys
    #: seconds a generation of discovery hints stays authoritative: past a
    #: drain (drain-deadline 10 s by default), short enough that a server
    #: that restarted and announced itself healthy regains traffic
    _HINT_TTL_S = 30.0

    def __init__(self, name=None):
        super().__init__(name)
        self._pstate = _PoolState((), ())
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight: Deque[Future] = deque()
        self._rr = 0
        # rediscovery: the pointer swap shares a lock with stop(); one
        # leader per failure wave does the broker I/O
        self._rediscover_lock = threading.Lock()
        self._discover_leader = threading.Lock()
        self._last_discovery_ts = float("-inf")
        self._run_epoch = 0
        self._stopped = True
        # per-remote breakers keyed by "host:port", shared by every worker
        # (CircuitBreaker is thread-safe); the counters below are raced by
        # the pool workers and kept under the same lock
        self._breakers: dict = {}
        self._breakers_lock = threading.Lock()
        self._degraded = 0
        self._evicted_breaker_trips = 0  # trips of breakers evicted on pool swaps
        self._busy_replies = 0
        self._goaway_replies = 0
        self._deadline_expired = 0
        self._corruption_detected = 0
        self._delivered = 0
        self._retried = 0
        # stream continuity, exact: crash resumes and planned migrations
        # apart, the dropped overlap visible, failures loud
        self._stream_resumes = 0
        self._stream_migrations = 0
        self._duplicate_tokens_dropped = 0
        self._resume_failures = 0
        self._retry_policy = RetryPolicy()  # rebuilt from props in start()
        self._remote_spans: dict = {}
        self._rtt_hist = None
        self._remote_inflight: dict = {}
        self._affinity_map: "OrderedDict[str, str]" = OrderedDict()
        self._affinity_remaps = 0
        # the draining/degraded hints of the last discovery, by "host:port"
        # (only such rows; absent = healthy), aging out as one generation
        self._endpoint_hints: dict = {}
        self._hints_ts = float("-inf")
        # ewma-score cache: (spans revision, addrs) -> {idx: score}
        self._spans_rev = 0
        self._scores_cache = None
        self._slo = None

    @property
    def _conns(self) -> tuple:
        return self._pstate.conns

    def start(self):
        if self.props.get("error-policy", "fail-stop") != "fail-stop":
            self.log.warning(
                "error-policy=%s is ignored on the query client (pipelined in-flight "
                "answers make frame attribution ambiguous); use degrade=passthrough|skip",
                self.props["error-policy"])
        _check_connect_type(self)  # before discovery: a typo is not a timeout
        if not 0 <= int(self.props["priority"]) <= PRIORITY_MAX:
            raise ElementError(
                f"{self.name}: priority={self.props['priority']} (want 0..{PRIORITY_MAX})")
        if self._discovering():
            targets = self._discover_targets()
        elif self.props["hosts"]:
            targets = parse_host_list(self.props["hosts"], self.name, "hosts")
        else:
            targets = [(self.props["host"], self.props["port"])]
        if any(p == 0 for _, p in targets):
            raise ElementError(f"{self.name}: query client needs host/port")
        if self.props["stream"] and int(self.props["wire-batch"]) > 1:
            raise ElementError(f"{self.name}: stream=true is per-request; wire-batch must be 1")
        try:
            slo = SloTracker(ttft_p95_s=float(self.props["slo-ttft-p95"]),
                             token_p99_s=float(self.props["slo-token-p99"]),
                             availability=float(self.props["slo-availability"]))
        except ValueError as e:
            raise ElementError(f"{self.name}: {e}") from None
        self._slo = slo if slo.armed else None
        self._run_epoch += 1
        self._pstate = _PoolState(self._make_conns(targets), targets, 0, self._run_epoch)
        self._stopped = False
        # failover pacing: capped exponential backoff with unseeded jitter
        # (a fixed seed would re-synchronize a fleet of clients)
        self._retry_policy = RetryPolicy(
            max_attempts=1 + max(0, int(self.props["retries"])),
            base_delay_s=max(0.0, float(self.props["retry-backoff"])),
            max_delay_s=1.0, jitter=0.1, seed=None)
        self._pool = ThreadPoolExecutor(max_workers=max(1, self.props["max-in-flight"]),
                                        thread_name_prefix=f"{self.name}-rpc")
        pname = self._pipeline.telemetry_label if self._pipeline is not None else ""
        self._rtt_hist = REGISTRY.histogram(
            "nns.query.rtt_seconds", labels={"pipeline": pname, "element": self.name})

    # -- discovery ----------------------------------------------------------
    def _discovering(self) -> bool:
        return bool(self.props["topic"]) and self.props["dest-port"] > 0

    def _discover_targets(self) -> List[Tuple[str, int]]:
        """The server set from the retained announces under
        ``nns/query/<topic>/#``: announces of another transport skipped,
        endpoints deduplicated and probed concurrently (N stale announces
        cost one probe timeout), the draining/degraded hints of the live
        ones kept (``core/fleet.hint_from_announce``), replacing the last
        generation's wholesale."""
        from ..core.fleet import hint_from_announce
        from ..distributed.hybrid import discover_endpoints, probe_endpoint

        want_ct = self.props["connect-type"]
        hints: dict = {}

        def validate(topic: str, info: dict) -> bool:
            got_ct = info.get("connect_type", want_ct)
            if got_ct != want_ct:
                self.log.warning("announce %s speaks %s, client wants %s (skipped)",
                                 topic, got_ct, want_ct)
                return False
            # per endpoint, always overwritten: a restarted server's fresh
            # announce (new instance topic, same host:port) must override
            # its dead instance's retained draining=true
            try:
                hints[(str(info["host"]), int(info["port"]))] = hint_from_announce(info)
            except (KeyError, TypeError, ValueError):
                pass
            return True

        brokers = (parse_host_list(self.props["dest-brokers"], self.name, "dest-brokers")
                   if self.props["dest-brokers"].strip() else [])
        try:
            found = discover_endpoints(self.props["dest-host"], self.props["dest-port"],
                                       f"nns/query/{self.props['topic']}/#",
                                       timeout_s=self.props["discovery-timeout"],
                                       validate=validate, logger=self.log, brokers=brokers)
        except OSError as e:
            raise ElementError(f"{self.name}: no discovery broker answered: {e}") from None
        candidates = sorted(set(found.values()))
        with ThreadPoolExecutor(max_workers=max(1, len(candidates)),
                                thread_name_prefix=f"{self.name}-probe") as ex:
            alive = list(ex.map(lambda hp: probe_endpoint(*hp), candidates))
        targets = []
        for (host, port), ok in zip(candidates, alive):
            if ok:
                targets.append((host, port))
            else:
                self.log.warning("announced endpoint %s:%d not accepting (stale announce from "
                                 "a crashed server?); skipped", host, port)
        if not targets:
            raise ElementError(f"{self.name}: no live server announced on topic "
                               f"{self.props['topic']!r} within "
                               f"{self.props['discovery-timeout']}s")
        with self._breakers_lock:
            self._endpoint_hints = {
                f"{h}:{p}": hints[(h, p)] for h, p in targets
                if hints.get((h, p), {}).get("draining") or hints.get((h, p), {}).get("degraded")}
            self._hints_ts = time.monotonic()
        return targets

    def _rediscover(self, failed_ps: _PoolState) -> bool:
        """Discovery mode's recovery: the server set read again from the
        broker and the pool swapped, once per failure wave.  Workers whose
        failure predates a swap ride on it; a worker of an earlier run never
        swaps.  The broker I/O, connections and handshakes run outside the
        swap lock, so stop() never waits out a discovery; endpoints in both
        sets keep their live connection.  True when the caller may resend
        on the (new) pool."""
        if not self._discovering() or self._stopped:
            return False
        cur = self._pstate
        if cur.epoch != failed_ps.epoch:
            return False
        if cur.gen != failed_ps.gen:
            return True  # another worker swapped already
        with self._discover_leader:
            cur = self._pstate
            if self._stopped or cur.epoch != failed_ps.epoch:
                return False
            if cur.gen != failed_ps.gen:
                return True  # the leader swapped while this worker waited
            now = time.monotonic()
            if now - self._last_discovery_ts < max(1.0, float(self.props["discovery-timeout"])):
                return False  # a persistently bad pool: no discovery per frame
            self._last_discovery_ts = now
            try:
                targets = self._discover_targets()
            except (ElementError, OSError) as e:
                self.log.warning("re-discovery failed: %s", e)
                return False
            by_ep = dict(zip(cur.targets, cur.conns))
            spec = self.sink_specs.get(0)
            conns, kept, created = [], [], []
            for ep in targets:
                conn = by_ep.get(ep)
                if conn is None:
                    try:
                        conn = self._make_conns([ep])[0]
                        if spec is not None and spec.tensors:
                            conn.handshake(spec.to_string())
                    except Exception as e:  # noqa: BLE001 — transport boundary
                        self.log.warning("replacement endpoint %s:%d unusable: %s (skipped)",
                                         ep[0], ep[1], e)
                        continue
                    created.append(conn)
                conns.append(conn)
                kept.append(ep)
            if not conns:
                self.log.warning("re-discovery found no usable server")
                return False
            with self._rediscover_lock:
                swapped = not self._stopped
                if swapped:
                    retired = [c for c in cur.conns if c not in conns]
                    self._pstate = _PoolState(conns, kept, cur.gen + 1, cur.epoch)
                else:
                    retired = created
        if swapped:
            self.log.info("re-discovered %d server(s): %s", len(kept),
                          ",".join(f"{h}:{p}" for h, p in kept))
            keep = {f"{h}:{p}" for h, p in kept}
            with self._breakers_lock:
                # breakers and span EWMAs of vanished endpoints go with them
                for key in [k for k in self._breakers if k not in keep]:
                    self._evicted_breaker_trips += self._breakers.pop(key).trip_count
                for key in [k for k in self._remote_spans if k not in keep]:
                    del self._remote_spans[key]
                self._spans_rev += 1
        for c in retired:
            try:
                c.close()
            except Exception:  # allow-silent: teardown of a dead connection
                pass
        return swapped

    @staticmethod
    def _provably_unsent(err: BaseException) -> bool:
        """True when the failure proves the request never reached a server
        (a refused dial; gRPC's UNAVAILABLE for a failed connect), so a
        resend is safe even at most once."""
        if isinstance(err, ConnectionRefusedError):
            return True
        code = getattr(err, "code", None)
        if callable(code) and type(err).__module__.startswith("grpc"):
            detail = str(getattr(err, "details", lambda: "")()).lower()
            return getattr(code(), "name", "") == "UNAVAILABLE" and (
                "connection refused" in detail or "failed to connect" in detail)
        return False

    def _resend_safe(self, err: BaseException) -> bool:
        """A request may go again after a rediscovery: retries are on, the
        request provably never left, or it was refused before execution
        (breaker-open, BUSY, GOAWAY, detected corruption)."""
        return (self.props["retries"] > 0 or self._provably_unsent(err)
                or isinstance(err, (CircuitOpenError, ServerBusyError, ServerGoawayError,
                                    WireError)))

    def _make_conns(self, targets: List[Tuple[str, int]]) -> list:
        verify = bool(self.props["verify-checksum"])
        if self.props["connect-type"] == "tcp":
            from ..distributed.tcp_query import TcpQueryConnection

            return [TcpQueryConnection(h, p, self.props["timeout"],
                                       nconns=max(1, int(self.props["max-in-flight"])),
                                       wire_version=int(self.props["wire-version"]),
                                       verify_checksum=verify)
                    for h, p in targets]
        return [QueryConnection(h, p, self.props["timeout"], verify_checksum=verify)
                for h, p in targets]

    def stop(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        # the flag first, without the lock: a rediscovery re-checks it
        # before its swap, so stop() never waits out a discovery
        self._stopped = True
        with self._rediscover_lock:
            ps, self._pstate = self._pstate, _PoolState((), ())
        for c in ps.conns:
            c.close()
        self._inflight.clear()

    # caps handshake at negotiation time (≙ edge CAPS event exchange)
    def accept_spec(self, pad, spec):
        if spec.tensors and self._conns:
            failures = []
            for conn in self._conns:
                try:
                    conn.handshake(spec.to_string())
                except Exception as e:  # noqa: BLE001 — transport boundary
                    failures.append((conn.addr, e))
            can_failover = self.props["retries"] > 0 and len(self._conns) > 1
            if failures and (len(failures) == len(self._conns) or not can_failover):
                addr, e = failures[0]
                raise ElementError(f"{self.name}: caps handshake with {addr} failed: {e}") from None
            for addr, e in failures:
                self.log.warning("caps handshake with %s failed: %s", addr, e)
        return spec

    def derive_spec(self, pad=0):
        return ANY  # the server decides the answer schema

    # -- in-flight window ---------------------------------------------------
    def _result_budget(self) -> float:
        """Worst-case seconds one in-flight request may take (attempts x
        (timeout + backoff) + busy pacing), doubled, plus slack: waits on
        the window are bounded so a wedged worker surfaces."""
        t = float(self.props["timeout"])
        attempts = 1 + max(0, int(self.props["retries"]))
        busy = max(0, int(self.props["busy-retries"]))
        return 2.0 * (attempts + busy) * (t + 1.0) + 30.0

    def _await(self, fut: Future):
        try:
            return fut.result(timeout=self._result_budget())
        except FuturesTimeout:
            raise TimeoutError(
                f"{self.name}: in-flight request exceeded the {self._result_budget():.0f}s "
                "worst-case budget (wedged worker?)") from None

    def _drain_ready(self, block_all: bool):
        out = []
        while self._inflight:
            fut = self._inflight[0]
            if not block_all and not fut.done():
                break
            self._inflight.popleft()
            got = self._await(fut)  # raises a request's error
            if got is None:
                continue  # degrade=skip swallowed the frame (warned)
            if isinstance(got, list):
                out.extend((0, f) for f in got)
            else:
                out.append((0, got))
        return out

    def pending_frames(self) -> int:
        """Logical frames whose answers have not been emitted yet (drain and
        stop accounting; the scheduler polls the idle hook while > 0)."""
        return sum(getattr(f, "_nns_logical", 1) for f in list(self._inflight))

    def handle_idle(self):
        """Answers that landed while no frame arrived leave now."""
        return self._drain_ready(block_all=False)

    # -- health and metrics ------------------------------------------------
    def _breaker_for(self, target: Tuple[str, int]) -> Optional[CircuitBreaker]:
        """The lazily made breaker of one remote; None with
        breaker-threshold=0."""
        threshold = int(self.props["breaker-threshold"])
        if threshold <= 0:
            return None
        key = f"{target[0]}:{target[1]}"
        with self._breakers_lock:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(
                    failure_threshold=threshold,
                    window_s=max(1.0, float(self.props["timeout"]) * 4),
                    reset_timeout_s=float(self.props["breaker-reset"]),
                    name=f"{self.name}->{key}",
                    on_trip=self._on_breaker_trip)
                self._breakers[key] = b
            return b

    def _on_breaker_trip(self, breaker: CircuitBreaker) -> None:
        p = self._pipeline
        if p is not None:
            p.incident("breaker_trip", self.name, breaker.name)

    def health_info(self) -> dict:
        """Per-remote breakers, span EWMAs (``remotes``) and in-flight
        counts, and the client's exact counters."""
        with self._breakers_lock:
            breakers = {k: b.snapshot() for k, b in self._breakers.items()}
            remotes = {k: {kk: (round(vv, 3) if isinstance(vv, float) else vv)
                           for kk, vv in agg.items()}
                       for k, agg in self._remote_spans.items()}
            remote_inflight = dict(self._remote_inflight)
            hints = {k: dict(v) for k, v in self._endpoint_hints.items() if v}
        return {
            "breakers": breakers,
            "remotes": remotes,
            "remote_inflight": remote_inflight,
            "endpoint_hints": hints,
            "routing": self.props["routing"],
            "affinity_remaps": self._affinity_remaps,
            "breaker_trips_evicted": self._evicted_breaker_trips,
            "degraded_frames": self._degraded,
            "busy_replies": self._busy_replies,
            "goaway_replies": self._goaway_replies,
            "deadline_expired": self._deadline_expired,
            "corruption_detected": self._corruption_detected,
            "delivered": self._delivered,
            "retried": self._retried,
            "stream_resumes": self._stream_resumes,
            "stream_migrations": self._stream_migrations,
            "duplicate_tokens_dropped": self._duplicate_tokens_dropped,
            "resume_failures": self._resume_failures,
            "servers": list(self._pstate.addrs),
            **({"slo": self._slo.snapshot()} if self._slo is not None else {}),
        }

    def histograms_info(self):
        return self._slo.hist_rows() if self._slo is not None else []

    def metrics_info(self):
        return [("nns.query.client_inflight", len(self._inflight))]

    def _count(self, attr: str, n: int = 1) -> None:
        with self._breakers_lock:  # pool workers race these counters
            setattr(self, attr, getattr(self, attr) + n)

    def _note_expired(self) -> TimeoutError:
        self._count("_deadline_expired")
        return TimeoutError(f"{self.name}: deadline expired mid-request")

    # -- spans and routing -------------------------------------------------
    def _note_span(self, target: Tuple[str, int], req, ans, t_send: float,
                   t_recv: float) -> None:
        """Attach the end-to-end decomposition to each answer (``SPAN_META``)
        and fold it into the per-remote EWMAs.  The segments add up by
        construction: the server's queue + dispatch + compute equal its
        total and wire is the round trip less that total, so client_queue +
        wire + server_queue + device_dispatch + device_compute == total.
        ``total`` is the segments' sum (client_queue + rtt up to float
        rounding).  A peer that stamps no server span gives wire == rtt."""
        rtt = max(0.0, t_recv - t_send)
        reqs = req if isinstance(req, list) else [req]
        answers = ans if isinstance(ans, list) else [ans]
        last = None
        for i, a in enumerate(answers):
            if a is None:
                continue
            src = reqs[i] if i < len(reqs) else reqs[-1]
            srv = a.meta.get(SRV_SPAN_META) or {}
            srv_total = min(float(srv.get("total", 0.0)), rtt)
            dispatch = float(srv.get("dispatch", 0.0))
            compute = float(srv.get("compute", 0.0))
            enq = src.meta.get(TL_ENQ_META)
            cq = max(0.0, t_send - enq) if enq is not None else 0.0
            wire = rtt - srv_total
            queue = max(0.0, srv_total - dispatch - compute)
            span = {
                "trace_id": src.meta.get(TRACE_ID_META),
                "remote": f"{target[0]}:{target[1]}",
                "client_queue": cq,
                "wire": wire,
                "server_queue": queue,
                "device_dispatch": dispatch,
                "device_compute": compute,
                # the segments' sum, in this order: client_queue + rtt up to
                # the rounding of the float additions
                "total": cq + wire + queue + dispatch + compute,
            }
            a.meta[SPAN_META] = span
            last = span
        if last is None:
            return
        if self._rtt_hist is not None:
            self._rtt_hist.observe(rtt)
        alpha = self._SPAN_EWMA

        def roll(old, new):
            return new if old is None else old + alpha * (new - old)

        with self._breakers_lock:
            agg = self._remote_spans.setdefault(last["remote"], {
                "requests": 0, "e2e_ms": None, "rtt_ms": None, "wire_ms": None,
                "server_ms": None, "client_queue_ms": None})
            agg["requests"] += 1
            agg["e2e_ms"] = roll(agg["e2e_ms"], last["total"] * 1e3)
            agg["rtt_ms"] = roll(agg["rtt_ms"], rtt * 1e3)
            agg["wire_ms"] = roll(agg["wire_ms"], last["wire"] * 1e3)
            agg["server_ms"] = roll(agg["server_ms"], (
                last["server_queue"] + last["device_dispatch"] + last["device_compute"]) * 1e3)
            agg["client_queue_ms"] = roll(agg["client_queue_ms"], last["client_queue"] * 1e3)
            self._spans_rev += 1  # invalidates the routing score cache

    def _tiers_and_signals(self, ps: _PoolState, n: int, policy: str, now: float):
        """The availability tier of every remote (cooled-down or
        breaker-open = TIER_DOWN; announced draining = TIER_DRAINING,
        announced degraded = TIER_DEGRADED, while the discovery hints are
        fresh; else TIER_OK) and the load signals the policy needs.
        Lock-free reads: a stale value costs one suboptimal ranking, never a
        crash.  Breakers are peeked, never ``allow()``ed."""
        down = ps.down_until
        addrs = ps.addrs
        peek_breakers = int(self.props["breaker-threshold"]) > 0
        breakers = self._breakers
        hints = self._endpoint_hints if now - self._hints_ts < self._HINT_TTL_S else {}
        tiers = {}
        for i in range(n):
            b = breakers.get(addrs[i]) if peek_breakers else None
            h = hints.get(addrs[i])
            if down.get(i, 0) > now or (b is not None and b.state == CircuitBreaker.OPEN):
                tiers[i] = TIER_DOWN
            elif h and h.get("draining"):
                tiers[i] = TIER_DRAINING
            elif h and h.get("degraded"):
                tiers[i] = TIER_DEGRADED
            else:
                tiers[i] = TIER_OK
        inflight = scores = None
        if policy != "rotate":
            ri = self._remote_inflight
            inflight = {i: ri.get(addrs[i], 0) for i in range(n)}
            if policy == "ewma":
                rev = (self._spans_rev, addrs)
                cached = self._scores_cache
                if cached is not None and cached[0] == rev:
                    scores = cached[1]
                else:
                    scores = ewma_scores(range(n), addrs, self._remote_spans)
                    self._scores_cache = (rev, scores)
        return tiers, inflight, scores

    def _note_affinity(self, key: str, target: Tuple[str, int]) -> None:
        """Track each affinity key's owner; an owner change counts as one
        remap (a failover of a sticky request is not one)."""
        addr = f"{target[0]}:{target[1]}"
        with self._breakers_lock:
            prev = self._affinity_map.pop(key, None)
            if prev is not None and prev != addr:
                self._affinity_remaps += 1
            self._affinity_map[key] = addr
            while len(self._affinity_map) > self._AFFINITY_MAP_MAX:
                self._affinity_map.popitem(last=False)

    def _route_order(self, ps: _PoolState, frame_or_batch, first: int) -> List[int]:
        """Every conn index of ``ps``, best first: the routing policy within
        availability tiers, the affinity owner first within its tier."""
        n = len(ps.conns)
        akey = self.props["affinity-key"]
        if n == 1 and not akey:
            return [0]
        policy = self.props["routing"]
        tiers, inflight, scores = self._tiers_and_signals(ps, n, policy, time.monotonic())
        owner = None
        if akey:
            f0 = frame_or_batch[0] if isinstance(frame_or_batch, list) else frame_or_batch
            meta = getattr(f0, "meta", None)
            val = meta.get(akey) if meta is not None else None
            if val is None and akey == "prefix":
                val = self._prefix_affinity_key(f0, meta)
            if val is not None:
                owner = rendezvous_owner(str(val), ps.targets)
                self._note_affinity(str(val), ps.targets[owner])
        return order_remotes(policy, tiers, first, n, inflight, scores, owner)

    @staticmethod
    def _prefix_affinity_key(frame, meta) -> Optional[str]:
        """The route key of ``affinity-key=prefix``: the chain digest of
        the prompt's declared (meta ``prefix_tokens``) or first-grain
        prefix; None (plain policy order) without a usable prompt."""
        tensors = getattr(frame, "tensors", None)
        if not tensors:
            return None
        try:
            declared = int((meta or {}).get("prefix_tokens", 0) or 0)
            return prefix_route_key(tensors[0], declared=declared)
        except Exception:  # an unroutable frame never fails the send path
            return None

    def _inflight_delta(self, addr: str, d: int) -> None:
        with self._breakers_lock:
            v = self._remote_inflight.get(addr, 0) + d
            if v <= 0:
                self._remote_inflight.pop(addr, None)  # self-cleaning
            else:
                self._remote_inflight[addr] = v

    def _request_timeout(self, frame, base: float):
        """``(timeout, expired)``: the configured timeout cut to the
        tightest remaining deadline budget of the frames (the budget rides
        the wire, so the server can expire the work before invoke)."""
        frames = frame if isinstance(frame, list) else [frame]
        rem: Optional[float] = None
        for f in frames:
            r = deadline_remaining(f)
            if r is not None:
                rem = r if rem is None else min(rem, r)
        if rem is None:
            return base, False
        return min(base, rem), rem <= 0

    def _record_remote_failure(self, breaker, ps: _PoolState, i: int,
                               err: BaseException, cooldown_s: float) -> None:
        """An application reply from a live server is health; anything
        else counts against the remote (breaker + cooldown)."""
        if is_remote_application_error(err):
            if breaker is not None:
                breaker.record_success()
            return
        if breaker is not None:
            breaker.record_failure()
        ps.down_until[i] = time.monotonic() + cooldown_s

    def _pace(self, delay: float) -> None:
        if delay > 0:
            time.sleep(delay)

    # -- unary path ---------------------------------------------------------
    def _invoke_failover(self, frame, first: int, rediscovered: bool = False):
        """One request (a list = a wire micro-batch): the best remote first,
        then the others, ``retries`` extra attempts.  BUSY (admission shed),
        GOAWAY (draining) and detected corruption are resend-safe and get
        budgets of their own: BUSY and GOAWAY never touch the breaker,
        corruption counts against it.  A refused dial (nothing sent) moves
        on to each other remote once without spending an attempt, but counts
        against the refusing remote (the JAX client spends an attempt on
        it).  A request whose deadline budget ran out stops retrying."""
        ps = self._pstate  # ONE snapshot per request
        if not ps.conns:
            raise RuntimeError(f"{self.name}: no connections (stopped?)")
        attempts = 1 + max(0, self.props["retries"])
        busy_budget = max(0, int(self.props["busy-retries"]))
        corrupt_budget = max(0, int(self.props["corrupt-retries"]))
        timeout = self.props["timeout"]
        policy = self._retry_policy
        order = self._route_order(ps, frame, first)
        err: Optional[BaseException] = None
        open_err: Optional[BaseException] = None
        cursor = k = busy_used = corrupt_used = goaway_used = unsent_used = 0
        while k < attempts and not self._stopped:
            req_timeout, expired = self._request_timeout(frame, timeout)
            if expired:
                raise self._note_expired()  # no answer can matter any more
            # the next remote whose breaker admits a call; an open breaker
            # is skipped without consuming an attempt
            i = breaker = None
            for _ in range(len(order)):
                cand = order[cursor % len(order)]
                cursor += 1
                b = self._breaker_for(ps.targets[cand])
                if b is None or b.allow():
                    i, breaker = cand, b
                    break
                open_err = CircuitOpenError(f"{ps.conns[cand].addr} circuit {b.state}")
            if i is None:
                # every breaker open: burn this attempt on the backoff, the
                # reset window may grant a half-open probe
                k += 1
                if k < attempts and not self._stopped:
                    self._pace(policy.delay_for(k))
                    continue
                break
            conn = ps.conns[i]
            try:
                t_send = time.perf_counter()
                self._inflight_delta(ps.addrs[i], 1)
                try:
                    result = (conn.invoke_batch(frame, req_timeout) if isinstance(frame, list)
                              else conn.invoke(frame, req_timeout))
                finally:
                    self._inflight_delta(ps.addrs[i], -1)
                t_recv = time.perf_counter()
                ps.down_until.pop(i, None)
                if breaker is not None:
                    breaker.record_success()
                self._count("_delivered", len(frame) if isinstance(frame, list) else 1)
                self._note_span(ps.targets[i], frame, result, t_send, t_recv)
                return result
            except ServerGoawayError as e:
                # draining: never executed, health (no breaker event), and
                # an immediate unpaced failover, once per remote
                err = e
                self._count("_goaway_replies")
                if breaker is not None:
                    breaker.record_success()
                ps.down_until[i] = time.monotonic() + min(float(timeout), 5.0)
                if goaway_used < len(order) and not self._stopped:
                    goaway_used += 1
                    self._count("_retried")
                    continue
                k += 1
                if k < attempts and not self._stopped:
                    self._count("_retried")
                    self._pace(policy.delay_for(k))
            except ServerBusyError as e:
                err = e
                self._count("_busy_replies")
                if breaker is not None:
                    breaker.record_success()  # the server answered at admission
                if busy_used < busy_budget and not self._stopped:
                    busy_used += 1
                    self._count("_retried")
                    self._pace(max(e.retry_after, policy.delay_for(busy_used)))
                    continue
                k += 1  # budget spent: attempts now, still paced
                if k < attempts and not self._stopped:
                    self._count("_retried")
                    self._pace(max(e.retry_after, policy.delay_for(k)))
            except WireError as e:
                err = e
                self._count("_corruption_detected")
                if breaker is not None:
                    breaker.record_failure()
                self.log.warning("corrupt exchange with %s (attempt %d/%d): %s",
                                 conn.addr, k + 1, attempts, e)
                if corrupt_used < corrupt_budget and not self._stopped:
                    corrupt_used += 1
                    self._count("_retried")
                    self._pace(policy.delay_for(corrupt_used))
                    continue
                k += 1
                if k < attempts and not self._stopped:
                    self._count("_retried")
                    self._pace(policy.delay_for(k))
            except Exception as e:  # noqa: BLE001 — transport boundary
                err = e
                self._record_remote_failure(breaker, ps, i, e, timeout)
                self.log.warning("query to %s failed (attempt %d/%d): %s",
                                 conn.addr, k + 1, attempts, e)
                if (self._provably_unsent(e) and unsent_used < len(order) - 1
                        and not self._stopped):
                    # a refused dial (a server stopped after its drain):
                    # nothing was sent, so the next remote takes it at
                    # once, as after a GOAWAY
                    unsent_used += 1
                    self._count("_retried")
                    continue
                k += 1
                if k < attempts:
                    self._count("_retried")
                    self._pace(policy.delay_for(k))
        if err is None:
            if open_err is None:
                raise RuntimeError(f"{self.name}: stopped mid-request")
            err = open_err  # every remote breaker-open, nothing tried
        if not rediscovered and self._rediscover(ps) and self._resend_safe(err):
            return self._invoke_failover(frame, first, rediscovered=True)
        raise err  # degrade= decides from here

    def _invoke_or_degrade(self, frame_or_batch, first: int):
        """``_invoke_failover`` under the degrade= contract: surface the
        error, pass the unanswered frame(s) through, or drop them."""
        try:
            return self._carry_deadline(frame_or_batch,
                                        self._invoke_failover(frame_or_batch, first))
        except Exception as e:  # noqa: BLE001 — transport boundary
            mode = self.props["degrade"]
            if mode not in ("passthrough", "skip"):
                raise
            self._note_degraded(len(frame_or_batch) if isinstance(frame_or_batch, list) else 1,
                                mode, e)
            if mode == "passthrough":
                return frame_or_batch
            return [] if isinstance(frame_or_batch, list) else None

    @staticmethod
    def _carry_deadline(req, ans):
        """Answers inherit their request's deadline stamp (instants never
        cross the wire), so a late answer is expired downstream."""
        reqs = req if isinstance(req, list) else [req]
        answers = ans if isinstance(ans, list) else [ans]
        for i, a in enumerate(answers):
            if a is None:
                continue
            ts = (reqs[i] if i < len(reqs) else reqs[-1]).meta.get(DEADLINE_META)
            if ts is not None:
                a.meta[DEADLINE_META] = ts
        return ans

    def _note_degraded(self, n: int, mode: str, err: BaseException) -> None:
        self._count("_degraded", n)
        self.log.warning("all remotes failed for %d frame(s); degrade=%s: %s", n, mode, err)
        if self._pipeline is not None:
            from ..pipeline.pipeline import BusMessage

            self._pipeline.post(BusMessage("warning", self.name, {
                "degrade": mode, "frames": n, "error": err}))

    def _dispatch(self, frame_or_batch):
        first = self._rr % max(1, len(self._pstate.conns))
        self._rr += 1
        fut = self._pool.submit(self._invoke_or_degrade, frame_or_batch, first)
        fut._nns_logical = len(frame_or_batch) if isinstance(frame_or_batch, list) else 1
        self._inflight.append(fut)
        # backpressure: a full window waits on its oldest request (bounded)
        if len(self._inflight) >= max(1, self.props["max-in-flight"]):
            self._await(self._inflight[0])
        return self._drain_ready(block_all=False)

    # -- scheduler hooks ----------------------------------------------------
    def handle_frame(self, pad, frame):
        return self.handle_frame_batch(pad, [frame])

    @property
    def preferred_batch(self) -> int:
        return max(1, int(self.props["wire-batch"]))

    batch_wait_s = 0.0  # batching never adds latency: a lone frame ships now

    def handle_frame_batch(self, pad, frames):
        if any(isinstance(f, BatchFrame) for f in frames):
            logical: List[TensorFrame] = []
            for f in frames:
                logical.extend(f.split() if isinstance(f, BatchFrame) else [f])
            frames = logical
        # trace context: the trace id crosses the wire (minted here when no
        # upstream stamped one); the enqueue instant stays host-local and
        # anchors the client-queue segment.  Tenant and priority ride meta.
        now = time.perf_counter()
        tenant = self.props["tenant"]
        prio = int(self.props["priority"])
        for f in frames:
            m = f.meta
            if TRACE_ID_META not in m:
                m[TRACE_ID_META] = new_trace_id()
            m[TL_ENQ_META] = now
            if tenant and TENANT_META not in m:
                m[TENANT_META] = tenant
            if prio != PRIORITY_MAX and PRIORITY_META not in m:
                m[PRIORITY_META] = prio
        if self.props["stream"]:
            return self._streams(frames)
        if len(frames) == 1:
            return self._dispatch(frames[0])
        return self._dispatch(list(frames))

    def handle_eos(self, pad):
        return self._drain_ready(block_all=True)

    # -- streaming path -----------------------------------------------------
    def _streams(self, frames):
        """Sequential per-request streams: request j's chunks leave before
        request j+1 is sent.  degrade= applies only to a request that
        produced no answer yet (emitted chunks cannot be retracted)."""
        for f in frames:
            emitted = 0
            try:
                for out in self._stream_invoke(f):
                    emitted += 1
                    yield out
            except Exception as e:  # noqa: BLE001 — transport boundary
                if self._stopping():
                    return  # the pipeline is stopping: the stream was abandoned
                mode = self.props["degrade"]
                if emitted or mode not in ("passthrough", "skip"):
                    raise
                self._note_degraded(1, mode, e)
                if mode == "passthrough":
                    yield (0, f)

    def _stream_invoke(self, frame):
        gen = self._stream_resume_loop(frame)
        return gen if self._slo is None else self._slo_wrap_stream(frame, gen)

    def _resume_armed(self, cont) -> bool:
        """The continuity layer owns this stream's failures: resume is on and
        its chunks so far carried resume state."""
        return bool(self.props["stream-resume"]) and cont.capable

    def _stream_resume_loop(self, frame):
        """One logical server-streaming request across any number of servers.

        Transport attempts run in :meth:`_stream_attempt`.  When an attempt
        of a resumable stream ends early (a crash mid-stream, a draining
        server's hand-off, a resume refusal), the ledger builds a RESUME
        request from the prompt and the delivered prefix and routes it like
        any request, healthiest server first; the overlap is dropped, so
        every token is delivered once and equals an uninterrupted run's.
        Progress refills the budget; exhaustion records an incident and
        surfaces the break."""
        cont = StreamContinuity(frame)
        budget = max(0, int(self.props["resume-retries"]))
        left = budget
        resuming = False
        last_delivered = 0
        req = frame
        while True:
            try:
                yield from self._stream_attempt(req, cont)
                return
            except _StreamInterrupt as si:
                if not self._resume_armed(cont) or self._stopping():
                    # stream-resume=false: no replay; a stopping client
                    # abandoned the stream: nothing to resume for
                    raise si.cause
                progressed = cont.delivered > last_delivered
                last_delivered = cont.delivered
                counted = False
                if si.kind == "reject" or (resuming and not progressed and si.kind == "break"):
                    # a refusal, or a resume that restored nothing before it
                    # broke again: that attempt failed (a hand-off without
                    # progress is a migration, not a failure)
                    self._count("_resume_failures")
                    counted = True
                if progressed:
                    left = budget
                if left <= 0:
                    if not counted:
                        self._count("_resume_failures")
                    self.log.warning("stream resume budget exhausted after %d delivered "
                                     "token(s); surfacing: %s", cont.delivered, si.cause)
                    p = self._pipeline
                    if p is not None:
                        p.incident("resume_exhausted", self.name,
                                   f"{cont.delivered} token(s) delivered; cause: {si.cause}")
                    raise si.cause
                left -= 1
                if si.kind == "break":
                    # crash resumes are paced like failover attempts; a
                    # planned hand-off migrates at once
                    self._pace(self._retry_policy.delay_for(budget - left))
                fresh_break = not resuming or progressed
                resuming = True
                try:
                    req = cont.build_resume_frame()
                except RuntimeError as e:
                    self._count("_resume_failures")
                    self.log.warning("cannot build resume request: %s", e)
                    raise si.cause from e
                # one count per logical recovery, so that with no failures
                # client resumes + migrations == the servers' gen_resumes: a
                # retry after a refusal, or after a resume that broke without
                # progress, continues the recovery already counted
                if si.kind == "handoff":
                    self._count("_stream_migrations")
                elif si.kind == "break" and fresh_break:
                    self._count("_stream_resumes")

    def _slo_wrap_stream(self, frame, gen):
        """Client-observed SLO accounting of one stream: TTFT on the first
        chunk, per-token inter-arrival on later ones, and one terminal
        outcome per stream (good / shed / expired / error), per tenant."""
        slo = self._slo
        tenant = str(frame.meta.get(TENANT_META, "") or "")
        t_prev = time.perf_counter()
        first = True
        expired = False
        try:
            for item in gen:
                out = item[1]
                n = 0
                if out.tensors:
                    t0 = out.tensors[0]
                    n = int(t0.shape[1]) if getattr(t0, "ndim", 0) == 2 else 1
                if n > 0:
                    now = time.perf_counter()
                    if first:
                        slo.note_ttft(tenant, now - t_prev)
                        first = False
                    else:
                        slo.note_tokens(tenant, now - t_prev, n)
                    t_prev = now
                if out.meta.get("deadline_expired"):
                    expired = True  # answered with partial tokens, budget blown
                yield item
        except GeneratorExit:
            raise  # the consumer abandoned the stream: not an outcome
        except ServerBusyError:
            slo.note_stream(tenant, "shed")
            raise
        except TimeoutError:
            slo.note_stream(tenant, "expired")
            raise
        except BaseException:
            slo.note_stream(tenant, "error")
            raise
        slo.note_stream(tenant, "expired" if expired else "good")

    def _stream_attempt(self, frame, cont, rediscovered: bool = False):
        """One transport attempt of a server-streaming request: the best
        remote first; whole streams fail over only BEFORE the first answer
        (``retries`` extra attempts, BUSY and GOAWAY on their own budgets).
        Every chunk goes through the continuity ledger ``cont``.  A break
        after the first answer records ill-health (breaker + cooldown); a
        resumable stream then hands it to :meth:`_stream_resume_loop` as a
        :class:`_StreamInterrupt`, any other surfaces (replaying half a
        generation blind could duplicate tokens).  A hand-off chunk is a
        planned migration: no breaker failure, a short deprioritization."""
        ps = self._pstate
        if not ps.conns:
            raise RuntimeError(f"{self.name}: no connections (stopped?)")
        order = self._route_order(ps, frame, self._rr % len(ps.conns))
        self._rr += 1
        attempts = min(len(order), 1 + max(0, self.props["retries"]))
        timeout = self.props["timeout"]
        err: Optional[BaseException] = None
        open_err: Optional[BaseException] = None
        tried = refused = cursor = busy_used = goaway_used = 0
        busy_budget = max(0, int(self.props["busy-retries"]))
        deadline_ts = frame.meta.get(DEADLINE_META)
        while tried < attempts and refused < len(order):
            i = order[cursor % len(order)]
            cursor += 1
            conn = ps.conns[i]
            breaker = self._breaker_for(ps.targets[i])
            if breaker is not None and not breaker.allow():
                open_err = CircuitOpenError(f"{conn.addr} circuit {breaker.state}")
                refused += 1
                continue
            refused = 0
            tried += 1
            started = False
            req_timeout, expired = self._request_timeout(frame, timeout)
            if expired:
                raise self._note_expired()  # no answer can matter any more
            reject = None
            try:
                self._inflight_delta(ps.addrs[i], 1)
                try:
                    for ans in conn.invoke_stream(frame, req_timeout,
                                                  interrupted=self._stopping):
                        started = True
                        ps.down_until.pop(i, None)
                        if deadline_ts is not None:
                            ans.meta[DEADLINE_META] = deadline_ts
                        if ans.meta.get("deadline_expired"):
                            # the server's typed expiry: answered with the
                            # partial tokens, budget blown
                            self._note_expired()
                        v = cont.accept(ans)
                        if v.dup:
                            self._count("_duplicate_tokens_dropped", v.dup)
                        if v.reject is not None:
                            reject = v.reject
                            break
                        if v.emit is not None:
                            yield (0, v.emit)
                finally:
                    self._inflight_delta(ps.addrs[i], -1)
                if reject is not None:
                    # the server refused the resume with a typed chunk: it is
                    # healthy and another server may match.  Always through
                    # the resume loop, which surfaces it when resume is off
                    if breaker is not None:
                        breaker.record_success()
                    raise _StreamInterrupt(RemoteApplicationError(
                        f"resume refused by {conn.addr}: {reject}"), "reject")
                if cont.take_handoff():
                    # a draining server handed the stream off: a planned
                    # restart, so the breaker records health and the host is
                    # only briefly deprioritized
                    if breaker is not None:
                        breaker.record_success()
                    ps.down_until[i] = time.monotonic() + min(float(timeout), 5.0)
                    raise _StreamInterrupt(ServerGoawayError(
                        f"{conn.addr} handed the stream off mid-generation (draining)"),
                        "handoff")
                if breaker is not None:
                    breaker.record_success()  # on clean completion only
                self._count("_delivered")
                return
            except _StreamInterrupt:
                raise  # continuity control flow, classified above
            except ServerGoawayError as e:
                err = e
                self._count("_goaway_replies")
                if breaker is not None:
                    breaker.record_success()
                ps.down_until[i] = time.monotonic() + min(float(timeout), 5.0)
                if goaway_used < len(order) and not self._stopped:
                    goaway_used += 1
                    tried -= 1
                elif tried < attempts and not self._stopped:
                    self._pace(self._retry_policy.delay_for(tried))
            except ServerBusyError as e:
                err = e
                self._count("_busy_replies")
                if breaker is not None:
                    breaker.record_success()
                if busy_used < busy_budget and not self._stopped:
                    busy_used += 1
                    tried -= 1
                    self._pace(max(e.retry_after, self._retry_policy.delay_for(busy_used)))
                elif tried < attempts and not self._stopped:
                    self._pace(max(e.retry_after, self._retry_policy.delay_for(tried)))
            except Exception as e:  # noqa: BLE001 — transport boundary
                err = self._stream_failure(e, started, breaker, ps, i, conn, timeout, cont)
        err = err if err is not None else open_err
        if err is not None and not rediscovered and self._rediscover(ps) \
                and self._resend_safe(err):
            yield from self._stream_attempt(frame, cont, rediscovered=True)
            return
        if err is None:
            raise RuntimeError("no servers")
        if self._resume_armed(cont) and cont.delivered > 0:
            # a RESUME attempt died before its first answer: the stream holds
            # delivered tokens, so the paced resume loop goes on with it
            raise _StreamInterrupt(err, "break")
        raise err

    def _stopping(self) -> bool:
        """True once the element or its pipeline is stopping: a stream
        awaiting its next chunk then ends and closes its socket."""
        return self._stopped or self.interrupted

    def _stream_failure(self, e, started, breaker, ps, i, conn, timeout, cont):
        """A failed stream attempt: after the first answer a resumable
        stream's break goes to the resume loop and any other is re-raised;
        before it, the failure is recorded (short cooldown) and returned for
        the next attempt."""
        if isinstance(e, WireError):
            self._count("_corruption_detected")
        if started:
            if not is_remote_application_error(e):
                if breaker is not None:
                    breaker.record_failure()
                ps.down_until[i] = time.monotonic() + min(float(timeout), 10.0)
            if self._resume_armed(cont):
                raise _StreamInterrupt(e, "break") from e
            raise e
        self._record_remote_failure(breaker, ps, i, e, min(float(timeout), 10.0))
        self.log.warning("stream to %s failed before first answer: %s", conn.addr, e)
        return e
