"""The query server core and the gRPC query transport.

Port of the query half of ``nnstreamer_tpu/distributed/service.py``
(≙ the reference's ``tensor_query_server.c`` pairing table and the caps
handshake of ``tensor_query_client.c``): :class:`QueryServerCore` pairs a
``tensor_query_serversrc`` (ingress) with its ``tensor_query_serversink``
(egress) by id, admits requests per tenant, stamps their deadline and
server spans, and serves them over gRPC (:meth:`QueryServerCore.start`)
or raw TCP (:meth:`QueryServerCore.start_tcp`, ``tcp_query.py``).
:class:`QueryConnection` is the gRPC client.

gRPC speaks three generic methods over the :mod:`.wire` framing (no
codegen): ``/nns.Query/Handshake`` (caps string in, caps string out),
``/nns.Query/Invoke`` (frame or batch envelope in, answers out) and
``/nns.Query/InvokeStream`` (one frame in, a stream of answer frames out).

``grpc`` is imported only by the gRPC half, when it is used: without the
package everything here loads, the raw-TCP transport works, and
``start()`` or ``QueryConnection`` raise a ``RuntimeError`` that names the
missing package.

The edge half (:class:`EdgeBroker`, :class:`EdgePublisher`,
:class:`EdgeSubscriber`; ≙ nnstreamer-edge pub/sub) is a topic broker
served over gRPC: ``/nns.Edge/Publish`` (u8 topic length, topic, frame)
and ``/nns.Edge/Subscribe`` (topic in, a stream of frames out).  It too
needs ``grpc`` only when it is used, behind the same typed error.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from collections import deque
from concurrent import futures
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import BatchFrame, TensorFrame
from ..core.lifecycle import ServerGoawayError
from ..core.liveness import (
    PRIORITY_MAX,
    PRIORITY_META,
    TENANT_META,
    ServerBusyError,
    TenantAdmissionController,
    clamp_priority,
    stamp_deadline,
)
from ..core.log import get_logger
from ..core.telemetry import SRV_SPAN_META, TL_INVOKE_META, TL_RX_META
from ..core.types import StreamSpec
from .wire import (
    WireCorruptionError,
    WireError,
    decode_frame,
    decode_frames,
    encode_frame,
    encode_frames,
    is_batch_payload,
)

log = get_logger("distributed")


def require_grpc(what: str = "connect-type=grpc", instead: str = "use connect-type=tcp"):
    """The ``grpc`` module, or a ``RuntimeError`` naming the package, what
    needed it and what to use instead."""
    try:
        import grpc
    except ImportError as e:
        raise RuntimeError(
            f"{what} requires the grpc package (grpcio) — not installed; {instead}") from e
    return grpc


class CapsMismatch(ValueError):
    """Client/server schemas parse but do not intersect."""

_ident = lambda b: b  # bytes-in/bytes-out (de)serializers  # noqa: E731
GRPC_OPTS = [
    ("grpc.max_receive_message_length", 512 * 1024 * 1024),
    ("grpc.max_send_message_length", 512 * 1024 * 1024),
]


# ---------------------------------------------------------------------------
# Server-side pairing registry (≙ tensor_query_server.c global table)
# ---------------------------------------------------------------------------
class QueryServerCore:
    """The in-process core pairing a serversrc (ingress) with a serversink
    (egress) and owning the gRPC server."""

    def __init__(self, port: int, host: str = "[::]"):
        self.block_ingress = False
        self.port = port
        self.host = host
        self.ingress: "queue.Queue[Tuple[int, TensorFrame]]" = queue.Queue(64)
        self._pending: Dict[int, "queue.Queue[TensorFrame]"] = {}
        self._pending_lock = threading.Lock()
        # client ids whose stream closed via the absent-'final'-key
        # heuristic (bounded; diagnosis only — see resolve())
        self._heuristic_closed: "deque[int]" = deque(maxlen=64)
        self._client_seq = itertools.count(1)
        self.caps: Optional[str] = None  # serversrc announces
        self._server = None  # grpc.Server
        self._tcp = None  # raw-TCP transport (tcp_query.TcpQueryServer)
        self.refs = 0
        # overload admission (core/liveness.py): default unlimited; the
        # serversrc's max-inflight/low-watermark/tenant-quota props
        # rebuild it.  Shed requests are refused with BUSY before
        # touching the ingress queue — overload answers in O(1) instead
        # of timing out deep in the pipeline.  Tenant identity and
        # priority ride the request meta (TENANT_META / PRIORITY_META),
        # so per-tenant quotas and weighted shedding work identically
        # over both transports with no wire-format change.
        self.admission = TenantAdmissionController(0)
        self.busy_retry_after = 0.05
        self.expired_drops = 0  # requests expired before ingest
        # data-plane integrity (Documentation/wire-protocol.md): both
        # transports verify request checksums at decode and refuse
        # corrupt requests ('C' on raw TCP / DATA_LOSS on gRPC) without
        # dying; the serversrc's verify-checksum / wire-version props
        # rebuild these before start()/start_tcp()
        self.verify_checksum = True
        self.wire_version = 2
        self.corrupt_requests = 0  # corrupt requests refused, all transports
        # rolling restart (core/lifecycle.py): a draining server refuses
        # NEW requests with GOAWAY ('G' on raw TCP / UNAVAILABLE+goaway
        # detail on gRPC) — an immediate, resend-safe failover signal
        # that never trips client breakers — while in-flight requests
        # finish normally; then the serversrc closes the listeners
        self.draining = False
        self.goaway_sent = 0  # requests refused with GOAWAY
        # hard stop: answer waits poll this so a handler thread blocked
        # on a stream the engine abandoned unwinds in ~0.25s instead of
        # wedging until its whole budget (a killed server must release
        # its reader threads promptly — the fleet kill-latency contract)
        self.closed = False

    # -- transport-agnostic handlers ----------------------------------------
    def check_caps(self, client_caps: str) -> str:
        """Caps handshake: intersect client/server schemas.  Raises
        :class:`CapsMismatch` on a genuine schema conflict and plain
        ``ValueError`` on unparseable caps.  Shared by every transport."""
        server_caps = self.caps or ""
        if server_caps and client_caps:
            a = StreamSpec.from_string(client_caps)
            b = StreamSpec.from_string(server_caps)
            if a.intersect(b) is None:
                raise CapsMismatch(
                    f"caps mismatch: client {client_caps} "
                    f"vs server {server_caps}"
                )
        return server_caps

    # -- rpc handlers -------------------------------------------------------
    def _handshake(self, request: bytes, context) -> bytes:
        grpc = require_grpc()
        try:
            return self.check_caps(request.decode()).encode()
        except CapsMismatch as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    @contextlib.contextmanager
    def _pending_client(self, frames: List[TensorFrame], qsize: int = 0):
        """Register a fresh client slot, stamp+inject the frames, and
        guarantee cleanup — the shared bookkeeping of the unary
        (:meth:`process`) and streaming (:meth:`_invoke_stream`) paths."""
        client_id = next(self._client_seq)
        answer_q: "queue.Queue[TensorFrame]" = queue.Queue(qsize)
        with self._pending_lock:
            self._pending[client_id] = answer_q
        try:
            for frame in frames:
                frame.meta["client_id"] = client_id
            for item in self._ingress_items(frames):
                self.ingress.put((client_id, item), timeout=10)
            yield answer_q
        finally:
            with self._pending_lock:
                self._pending.pop(client_id, None)

    def process(self, frames: List[TensorFrame], timeout: float
                ) -> List[TensorFrame]:
        """Route frames through the paired server pipeline and collect the
        answers in stream order.  Shared by every transport (gRPC unary
        handler, raw-TCP connection threads).  Raises TimeoutError when
        the pipeline produces no answer in time, :class:`ServerBusyError`
        when admission control sheds the request (before any ingest).

        Deadline QoS: each frame is stamped with the request's remaining
        budget (re-anchored on THIS host's clock — budgets cross the
        wire, instants don't), so server pipeline elements can expire
        late work BEFORE the invoke instead of burning chip time on an
        answer the client has already abandoned."""
        if self.draining:
            # checked BEFORE admission: the refusal must be O(1) and the
            # request provably never executed (resend-safe failover)
            self.goaway_sent += 1
            raise ServerGoawayError()
        tenant = self._admit(frames)
        try:
            budget = min(timeout, 300.0)
            # trace spans (core/telemetry.py): stamp the receive instant
            # (host-local, stripped at encode) so the answer can carry a
            # server-side DURATION decomposition back to the client
            rx = time.perf_counter()
            for frame in frames:
                stamp_deadline(frame, budget)
                frame.meta[TL_RX_META] = rx
            with self._pending_client(frames, qsize=len(frames)) as answer_q:
                answers = []
                deadline = time.monotonic() + budget
                for _ in frames:
                    answers.append(
                        self._await_answer(answer_q, deadline))
                self._stamp_server_spans(answers)
                return answers
        finally:
            self._release(tenant)

    def _await_answer(self, answer_q: "queue.Queue[TensorFrame]",
                      deadline: float) -> TensorFrame:
        """One answer off the client's queue, bounded by ``deadline``
        AND responsive to :attr:`closed`: short poll slices so a
        handler thread waiting on an answer that will never come (the
        server was hard-stopped mid-request) unwinds promptly instead
        of wedging ``stop()`` behind its whole budget."""
        while True:
            try:
                return answer_q.get(
                    timeout=min(0.25, max(0.0,
                                          deadline - time.monotonic())))
            except queue.Empty:
                if self.closed:
                    raise TimeoutError("server stopping") from None
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        "server pipeline produced no answer in time"
                    ) from None

    @staticmethod
    def request_identity(frames: List[TensorFrame]) -> Tuple[str, int]:
        """(tenant, priority) of one request, read from the first
        frame's meta — the identity rides the ordinary JSON meta blob,
        so it crosses both transports unchanged.  Absent keys degrade
        to the pre-tenancy semantics (unnamed tenant, priority 3)."""
        meta = frames[0].meta if frames else {}
        tenant = str(meta.get(TENANT_META, "") or "")
        priority = clamp_priority(meta.get(PRIORITY_META, PRIORITY_MAX))
        return tenant, priority

    def _admit(self, frames: List[TensorFrame]) -> str:
        """Tenant-aware admission for one request (both transports,
        unary + stream).  Raises :class:`ServerBusyError` carrying the
        per-tenant retry-after on any shed; returns the tenant to hand
        back to :meth:`_release`."""
        tenant, priority = self.request_identity(frames)
        adm = self.admission
        if isinstance(adm, TenantAdmissionController):
            adm.admit(tenant=tenant, priority=priority,
                      retry_after=self.busy_retry_after)
        elif not adm.try_admit():
            # a plain AdmissionController swapped in by tests/tools
            raise ServerBusyError(retry_after=self.busy_retry_after)
        return tenant

    def _release(self, tenant: str) -> None:
        adm = self.admission
        if isinstance(adm, TenantAdmissionController):
            adm.release(tenant=tenant)
        else:
            adm.release()

    @staticmethod
    def _stamp_server_spans(answers: List[TensorFrame]) -> None:
        """Fold the host-local stamps riding each answer's meta into the
        wire-safe duration dict ``SRV_SPAN_META`` ({"queue", "dispatch",
        "compute", "total"}, seconds — summing exactly to "total" so the
        client's end-to-end decomposition is additive).  Answers that
        never saw the stamps (meta-dropping elements, legacy peers) are
        left alone — the client then reports the whole round trip as
        wire time."""
        now = time.perf_counter()
        for a in answers:
            rx = a.meta.pop(TL_RX_META, None)
            inv = a.meta.pop(TL_INVOKE_META, None)
            if rx is None:
                continue
            total = max(0.0, now - rx)
            dispatch, compute = (inv if inv else (0.0, 0.0))
            # clamp into the measured window so queue (the remainder)
            # can never go negative and the sum stays exact
            compute = min(max(0.0, float(compute)), total)
            dispatch = min(max(0.0, float(dispatch)), total - compute)
            a.meta[SRV_SPAN_META] = {
                "queue": total - dispatch - compute,
                "dispatch": dispatch,
                "compute": compute,
                "total": total,
            }

    def client_live(self, client_id: int) -> bool:
        """True while the client's RPC/connection still waits for
        answers (the serversink's client-gone feedback probes this
        before cancelling a generation stream upstream)."""
        with self._pending_lock:
            return client_id in self._pending

    def process_stream(self, frame: TensorFrame, timeout: float):
        """One STREAMING request (transport-shared: gRPC ``InvokeStream``
        and the raw-TCP 'S' message): admit, inject the prompt, then
        yield answer frames as the server pipeline produces them until
        one carries ``meta["final"] is True`` (the tensor_generator
        chunk contract; an answer with NO ``final`` key — a plain 1:1
        graph — closes the stream after one message).

        Raises :class:`ServerGoawayError` / :class:`ServerBusyError`
        BEFORE any ingest (resend-safe refusals) and ``TimeoutError``
        when the pipeline goes silent mid-stream.  The request frame is
        deadline-stamped from the client's remaining budget (PR-2
        plumbing), so a continuous-batching generator can EVICT the
        stream with a typed expiry instead of decoding past the budget.
        Cleanup (pending slot, admission release) runs on ANY exit,
        including the transport abandoning the generator mid-yield."""
        if self.draining:
            self.goaway_sent += 1
            raise ServerGoawayError()
        tenant = self._admit([frame])
        try:
            # the CLIENT's deadline governs the whole stream (a long
            # generation is the point); hard backstop only against
            # deadline-less channels
            budget = min(timeout, 3600.0)
            rx = time.perf_counter()
            stamp_deadline(frame, budget)
            frame.meta[TL_RX_META] = rx
            with self._pending_client([frame]) as answer_q:
                deadline = time.monotonic() + budget
                while True:
                    ans = self._await_answer(answer_q, deadline)
                    # per-chunk span decomposition (each chunk's meta is
                    # a fresh copy of the request's, so "total" reads as
                    # time-since-request at that chunk)
                    self._stamp_server_spans([ans])
                    yield ans
                    if ans.meta.get("final", True):
                        if "final" not in ans.meta:
                            cid = ans.meta.get("client_id")
                            if cid is not None:
                                with self._pending_lock:
                                    self._heuristic_closed.append(cid)
                        return
        finally:
            self._release(tenant)

    def _ingress_items(self, frames: List[TensorFrame]) -> List[TensorFrame]:
        """block_ingress: a wire micro-batch becomes ONE BatchFrame so the
        server pipeline pays per-frame Python costs once per batch; falls
        back to per-frame injection when the batch is not uniform (mixed
        shapes/dtypes cannot share a batch axis)."""
        if not self.block_ingress or len(frames) <= 1:
            return frames
        # EXPLICIT uniformity check — np.stack would silently promote
        # mixed dtypes (and a count mismatch only raises one way), turning
        # the promised per-frame fallback into wrong batched inputs
        arrs = [[np.asarray(t) for t in f.tensors] for f in frames]
        sig0 = [(a.shape, a.dtype) for a in arrs[0]]
        for row in arrs[1:]:
            if [(a.shape, a.dtype) for a in row] != sig0:
                return frames
        stacked = [
            np.stack([row[i] for row in arrs]) for i in range(len(sig0))
        ]
        return [BatchFrame.from_frames(stacked, frames)]

    def _invoke(self, request: bytes, context) -> bytes:
        grpc = require_grpc()
        # wire micro-batch envelope: N frames ride one RPC (amortizes the
        # per-RPC transport cost); the server pipeline still sees N
        # ordinary frames, answers are collected back in stream order
        batched = is_batch_payload(request)
        try:
            frames = (decode_frames(request, verify=self.verify_checksum)
                      if batched
                      else [decode_frame(request,
                                         verify=self.verify_checksum)])
        except WireError as e:
            # corrupt/malformed request: refused before any execution —
            # DATA_LOSS ≙ the raw-TCP 'C' reply (the client transport
            # maps it back to WireCorruptionError, resend-safe)
            self.corrupt_requests += 1
            log.warning("corrupt request refused (DATA_LOSS): %s", e)
            context.abort(grpc.StatusCode.DATA_LOSS, f"corrupt request: {e}")
        try:
            answers = self.process(
                frames, float(context.time_remaining() or 30.0))
        except ServerGoawayError as e:
            # UNAVAILABLE + goaway detail ≙ the raw-TCP 'G' reply; the
            # client transport maps it back to ServerGoawayError —
            # immediate resend-safe failover, never a breaker event
            context.abort(grpc.StatusCode.UNAVAILABLE, f"goaway: {e}")
        except ServerBusyError as e:
            # RESOURCE_EXHAUSTED ≙ the raw-TCP BUSY reply; the client
            # transport maps it back to ServerBusyError (backpressure,
            # not ill-health — see resilience.is_remote_application_error)
            context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"server busy; retry_after={e.retry_after:.6f}",
            )
        except TimeoutError as e:
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        if batched:
            return encode_frames(answers, version=self.wire_version)
        return encode_frame(answers[0], version=self.wire_version)

    def _invoke_stream(self, request: bytes, context):
        """Server-streaming invoke: ONE request frame in, answer frames
        streamed out as the server pipeline produces them, until an
        answer carries ``meta["final"] is True`` (the tensor_generator
        chunk contract) — remote interactive serving: tokens reach the
        client while later chunks are still decoding.

        Non-streaming server graphs work too: a plain 1:1 pipeline's
        single answer has no ``final`` meta, so exactly one message is
        streamed and the stream closes via the sentinel check below."""
        grpc = require_grpc()
        try:
            frame = decode_frame(request, verify=self.verify_checksum)
        except WireError as e:
            self.corrupt_requests += 1
            log.warning("corrupt stream request refused (DATA_LOSS): %s", e)
            context.abort(grpc.StatusCode.DATA_LOSS, f"corrupt request: {e}")
        gen = self.process_stream(
            frame, float(context.time_remaining() or 30.0))
        try:
            for ans in gen:
                yield encode_frame(ans, version=self.wire_version)
        except ServerGoawayError:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          "goaway: server draining")
        except ServerBusyError as e:
            context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"server busy; retry_after={e.retry_after:.6f}",
            )
        except TimeoutError as e:
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        finally:
            # a cancelled RPC abandons this handler mid-yield: closing
            # the shared generator runs its cleanup (pending slot freed
            # -> the serversink's next chunk delivery sees client-gone
            # and cancels the stream upstream; admission released)
            gen.close()

    def resolve(self, client_id: int, frame: TensorFrame,
                limit: int = 0) -> bool:
        """serversink delivers an answer to the waiting client RPC.
        ``limit`` > 0 bounds queued answers per client (≙ serversink
        `limit` prop); excess answers are dropped with a warning."""
        with self._pending_lock:
            # membership check, limit check, AND the put share the lock:
            # a client timing out concurrently pops its queue in
            # _pending_client's finally (also under this lock), so an
            # answer can never land in an abandoned queue and report
            # success, and concurrent resolvers cannot overshoot `limit`
            q = self._pending.get(client_id)
            heuristic = q is None and client_id in self._heuristic_closed
            if q is not None:
                if limit > 0 and q.qsize() >= limit:
                    log.warning(
                        "client %s answer queue at limit %d (answer "
                        "dropped)", client_id, limit,
                    )
                    return False
                # never a blocking put: a timed-out client abandons its
                # queue with no consumer — a blocked put would wedge the
                # serversink thread forever (drop + warn instead)
                try:
                    q.put_nowait(frame)
                    return True
                except queue.Full:
                    log.warning(
                        "client %s answer queue full (answer dropped)",
                        client_id,
                    )
                    return False
        if q is None:
            if heuristic:
                log.warning(
                    "no pending client %s (answer dropped): its stream was "
                    "closed because an earlier answer carried no 'final' "
                    "meta key — multi-answer server graphs must stamp "
                    "meta['final']=False on intermediate answers",
                    client_id,
                )
            else:
                log.warning(
                    "no pending client %s (answer dropped)", client_id
                )
        return False

    def liveness_snapshot(self) -> Dict[str, Any]:
        """Load-shed / admission counters for ``Pipeline.health()`` (the
        serversrc merges this via ``health_info``)."""
        snap = self.admission.snapshot()
        return {
            "inflight": snap["inflight"],
            "admitted": snap["admitted"],
            "load_shed": snap["shed"],
            "shedding": snap["shedding"],
            "admission_high": snap["high"],
            "admission_low": snap["low"],
            # exact per-tenant {inflight, admitted, shed, quota} rows —
            # the fleet-chaos accounting contract (empty for a plain
            # AdmissionController swapped in by tests); tenants_evicted
            # counts idle ledgers dropped by the cardinality bound, so
            # a truncated tenant table is never silent
            "tenants": snap.get("tenants", {}),
            "tenants_evicted": snap.get("tenants_evicted", 0),
            # memory-watermark sheds (reason="memory"): requests refused
            # because the chip was near HBM exhaustion — the "shed BUSY
            # before the OOM" contract, counted exactly
            "memory_shed": snap.get("memory_shed", 0),
            "ingress_depth": self.ingress.qsize(),
            "corrupt_requests": self.corrupt_requests,
            "draining": self.draining,
            "goaway_sent": self.goaway_sent,
        }

    # -- rolling restart (core/lifecycle.py) --------------------------------
    def begin_drain(self) -> None:
        """Enter the draining state: every transport starts refusing NEW
        requests with GOAWAY; requests already admitted finish
        normally."""
        if not self.draining:
            self.draining = True
            log.info("query server :%d draining (GOAWAY to new requests)",
                     self.port)

    @property
    def drain_complete(self) -> bool:
        """True once no admitted request is still in flight and nothing
        remains queued for the server pipeline."""
        return self.admission.inflight == 0 and self.ingress.empty()

    def close_listeners(self) -> None:
        """Stop accepting entirely (listeners closed) without cutting
        in-flight replies: the raw-TCP path keeps connection readers
        serving until the last reply is out, and the gRPC stop() grace
        gives an RPC that outlived ``drain-deadline`` the same courtesy
        (new RPCs are refused immediately either way; stop() returns
        without blocking)."""
        if self._server is not None:
            self._server.stop(grace=30.0)
            self._server = None
        if self._tcp is not None:
            self._tcp.close_listener()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Serve over gRPC (connect-type=grpc)."""
        grpc = require_grpc()
        self.closed = False
        if self._server is not None:
            return
        handlers = {
            "Handshake": grpc.unary_unary_rpc_method_handler(
                self._handshake, request_deserializer=_ident, response_serializer=_ident
            ),
            "Invoke": grpc.unary_unary_rpc_method_handler(
                self._invoke, request_deserializer=_ident, response_serializer=_ident
            ),
            "InvokeStream": grpc.unary_stream_rpc_method_handler(
                self._invoke_stream,
                request_deserializer=_ident, response_serializer=_ident,
            ),
        }
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=32),
            options=GRPC_OPTS,
        )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler("nns.Query", handlers),)
        )
        bound = self._server.add_insecure_port(f"{self.host}:{self.port}")
        if bound == 0:
            raise RuntimeError(f"cannot bind query server on port {self.port}")
        self.port = bound
        self._server.start()
        log.info("query server on :%d", self.port)

    def start_tcp(self) -> None:
        """Serve over the raw-TCP zero-copy transport instead of gRPC
        (connect-type=tcp; ≙ the reference's nns-edge TCP default).
        Re-entrant: a listener closed by a drain re-opens on the same
        port (rolling restart of the serversrc element)."""
        self.closed = False
        if self._tcp is not None:
            self._tcp.start()  # no-op when the listener is already live
            return
        from .tcp_query import TcpQueryServer

        self._tcp = TcpQueryServer(
            self, port=self.port,
            wire_version=self.wire_version,
            verify_checksum=self.verify_checksum,
        )
        self._tcp.start()
        self.port = self._tcp.port

    def stop(self) -> None:
        self.closed = True  # unwedge handler threads parked on answers
        if self._server is not None:
            self._server.stop(grace=0.5)
            self._server = None
        if self._tcp is not None:
            self._tcp.stop()
            self._tcp = None


_servers_lock = threading.Lock()
_servers: Dict[int, QueryServerCore] = {}


def get_query_server(server_id: int, port: int = 0) -> QueryServerCore:
    """Process-global serversrc/serversink pairing by id."""
    with _servers_lock:
        core = _servers.get(server_id)
        if core is None:
            core = QueryServerCore(port)
            _servers[server_id] = core
        elif port and core._server is None and core.port == 0:
            # the paired serversink may have created the core first (element
            # start order is textual); honor the serversrc's configured port
            core.port = port
        core.refs += 1
        return core


def release_query_server(server_id: int) -> None:
    with _servers_lock:
        core = _servers.get(server_id)
        if core is None:
            return
        core.refs -= 1
        if core.refs <= 0:
            core.stop()
            del _servers[server_id]


# ---------------------------------------------------------------------------
# Query client
# ---------------------------------------------------------------------------
class QueryConnection:
    """Client side of /nns.Query (≙ nns_edge client handle)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 verify_checksum: bool = True):
        grpc = self._grpc = require_grpc()
        self.addr = f"{host}:{port}"
        self.timeout = timeout
        self._verify = bool(verify_checksum)
        self._channel = grpc.insecure_channel(self.addr, options=GRPC_OPTS)
        self._invoke = self._channel.unary_unary(
            "/nns.Query/Invoke", request_serializer=_ident, response_deserializer=_ident
        )
        self._handshake = self._channel.unary_unary(
            "/nns.Query/Handshake", request_serializer=_ident, response_deserializer=_ident
        )
        self._invoke_stream_rpc = self._channel.unary_stream(
            "/nns.Query/InvokeStream",
            request_serializer=_ident, response_deserializer=_ident,
        )

    def _map_busy(self, err) -> None:
        """Translate server status codes both transports share onto one
        client-side vocabulary: RESOURCE_EXHAUSTED (admission refusal)
        -> :class:`ServerBusyError` (≙ the raw-TCP BUSY reply),
        DATA_LOSS (corrupt request refused before execution) ->
        :class:`WireCorruptionError` (≙ the raw-TCP 'C' reply,
        resend-safe), and UNAVAILABLE carrying the goaway detail (the
        server DECIDED to refuse — it is draining) ->
        :class:`ServerGoawayError` (≙ the raw-TCP 'G' reply; a bare
        UNAVAILABLE stays a transport fault and keeps counting against
        the remote's health)."""
        grpc = self._grpc
        code = getattr(err, "code", lambda: None)()
        if code == grpc.StatusCode.DATA_LOSS:
            raise WireCorruptionError(
                str(getattr(err, "details", lambda: "")() or "corrupt request")
            ) from err
        if code == grpc.StatusCode.UNAVAILABLE:
            detail = str(getattr(err, "details", lambda: "")() or "")
            # exact-prefix match on OUR server's reply format: gRPC's own
            # transport errors can mention "GOAWAY" mid-detail (HTTP/2
            # GOAWAY frame on abrupt termination) and those are real
            # faults — they must keep counting against the remote
            if detail.startswith("goaway"):
                raise ServerGoawayError(detail) from err
            return
        if code != grpc.StatusCode.RESOURCE_EXHAUSTED:
            return
        retry_after = 0.05
        detail = str(getattr(err, "details", lambda: "")() or "")
        marker = "retry_after="
        if marker in detail:
            try:
                retry_after = float(detail.split(marker, 1)[1].split()[0])
            except ValueError:
                pass
        raise ServerBusyError(retry_after=retry_after) from err

    def handshake(self, caps: str) -> str:
        return self._handshake(caps.encode(), timeout=self.timeout).decode()

    def invoke(self, frame: TensorFrame, timeout: Optional[float] = None) -> TensorFrame:
        try:
            data = self._invoke(
                encode_frame(frame), timeout=timeout or self.timeout
            )
        except self._grpc.RpcError as e:
            self._map_busy(e)
            raise
        return decode_frame(data, verify=self._verify)

    def invoke_stream(self, frame: TensorFrame,
                      timeout: Optional[float] = None, interrupted=None):
        """Server-streaming invoke: yields answer frames as they arrive
        (the last one is final-flagged or has no ``final`` meta).
        ``timeout`` bounds the WHOLE stream; ``interrupted`` (a callable)
        is checked as each chunk arrives and cancels the call once true."""
        call = self._invoke_stream_rpc(encode_frame(frame), timeout=timeout or self.timeout)
        try:
            for data in call:
                if interrupted is not None and interrupted():
                    call.cancel()
                    raise ConnectionError(
                        f"stream to {self.addr} interrupted: the client is stopping")
                yield decode_frame(data, verify=self._verify)
        except self._grpc.RpcError as e:
            self._map_busy(e)
            raise

    def invoke_batch(self, frames: List[TensorFrame],
                     timeout: Optional[float] = None) -> List[TensorFrame]:
        """N frames in one RPC (wire micro-batch); answers in order."""
        try:
            data = self._invoke(
                encode_frames(frames), timeout=timeout or self.timeout
            )
        except self._grpc.RpcError as e:
            self._map_busy(e)
            raise
        return decode_frames(data, verify=self._verify)

    def close(self) -> None:
        self._channel.close()




# ---------------------------------------------------------------------------
# Edge pub/sub broker (≙ nnstreamer-edge pub/sub), gRPC transport
# ---------------------------------------------------------------------------
class EdgeBroker:
    """In-process topic broker served over gRPC: publishers push frames,
    each subscriber holds one server-streaming call per topic.  A
    subscriber whose queue is full misses the frame (pub/sub semantics of
    the JAX package's broker), counted in ``dropped_full``."""

    QUEUE_DEPTH = 64

    def __init__(self, port: int, host: str = "[::]"):
        self.port, self.host = port, host
        self._subs: Dict[str, List[queue.Queue]] = {}
        self._lock = threading.Lock()
        self._server = None  # grpc.Server
        self.refs = 0
        self.dropped_full = 0

    def publish_local(self, topic: str, data: bytes) -> int:
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for q in subs:
            try:
                q.put_nowait(data)
            except queue.Full:
                with self._lock:
                    self.dropped_full += 1
        return len(subs)

    def subscriber_count(self, topic: str) -> int:
        with self._lock:
            return len(self._subs.get(topic, ()))

    def _publish(self, request: bytes, context) -> bytes:
        n = request[0]
        self.publish_local(request[1:1 + n].decode(), request[1 + n:])
        return b""

    def _subscribe(self, request: bytes, context):
        topic = request.decode()
        q: "queue.Queue[bytes]" = queue.Queue(self.QUEUE_DEPTH)
        with self._lock:
            self._subs.setdefault(topic, []).append(q)
        try:
            while context.is_active():
                try:
                    yield q.get(timeout=0.2)
                except queue.Empty:
                    continue
        finally:
            with self._lock:
                if q in self._subs.get(topic, ()):
                    self._subs[topic].remove(q)

    def start(self) -> None:
        grpc = require_grpc("the gRPC edge transport")
        if self._server is not None:
            return
        handlers = {
            "Publish": grpc.unary_unary_rpc_method_handler(
                self._publish, request_deserializer=_ident, response_serializer=_ident),
            "Subscribe": grpc.unary_stream_rpc_method_handler(
                self._subscribe, request_deserializer=_ident, response_serializer=_ident),
        }
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=16),
                                   options=GRPC_OPTS)
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler("nns.Edge", handlers),))
        bound = self._server.add_insecure_port(f"{self.host}:{self.port}")
        if bound == 0:
            self._server = None
            raise RuntimeError(f"cannot bind edge broker on port {self.port}")
        self.port = bound
        # an ephemeral bind enters the registry only now, under its port
        with _brokers_lock:
            _brokers.setdefault(self.port, self)
        self._server.start()
        log.info("edge broker on :%d", self.port)

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5).wait(5)
            self._server = None


_brokers_lock = threading.Lock()
_brokers: Dict[int, EdgeBroker] = {}


def get_edge_broker(port: int) -> EdgeBroker:
    """The process's edge broker on ``port`` (a new one for port 0)."""
    with _brokers_lock:
        broker = _brokers.get(port) if port else None
        if broker is None:
            broker = EdgeBroker(port)
            if port:
                _brokers[port] = broker
        broker.refs += 1
        return broker


def release_edge_broker(broker: EdgeBroker) -> None:
    """Drop one reference; the last one stops the broker."""
    with _brokers_lock:
        broker.refs -= 1
        if broker.refs > 0:
            return
        if _brokers.get(broker.port) is broker:
            del _brokers[broker.port]
    broker.stop()


class EdgePublisher:
    """Publishes frames to a (possibly remote) edge broker."""

    def __init__(self, host: str, port: int, topic: str):
        grpc = require_grpc("the gRPC edge transport")
        self.topic = topic.encode()
        if len(self.topic) > 255:
            raise ValueError(f"edge topic exceeds 255 bytes ({len(self.topic)}): {topic[:40]!r}")
        self._channel = grpc.insecure_channel(f"{host}:{port}", options=GRPC_OPTS)
        self._publish = self._channel.unary_unary(
            "/nns.Edge/Publish", request_serializer=_ident, response_deserializer=_ident)

    def publish_bytes(self, payload: bytes) -> None:
        self._publish(bytes([len(self.topic)]) + self.topic + payload, timeout=10.0)

    def close(self) -> None:
        self._channel.close()


class EdgeSubscriber:
    """Holds one Subscribe stream; yields TensorFrames.  A frame that fails
    its decode or checksum is dropped and counted in ``corrupt_dropped``:
    one bad transmission is a gap, not the end of the stream."""

    def __init__(self, host: str, port: int, topic: str, verify_checksum: bool = True):
        grpc = require_grpc("the gRPC edge transport")
        self.topic = topic
        self._verify = bool(verify_checksum)
        self.corrupt_dropped = 0
        self._channel = grpc.insecure_channel(f"{host}:{port}", options=GRPC_OPTS)
        self._subscribe = self._channel.unary_stream(
            "/nns.Edge/Subscribe", request_serializer=_ident, response_deserializer=_ident)
        self._stream = None

    def frames(self):
        self._stream = self._subscribe(self.topic.encode())
        for data in self._stream:
            try:
                yield decode_frame(data, verify=self._verify)
            except WireError as e:
                self.corrupt_dropped += 1
                log.warning("undecodable edge frame dropped: %s", e)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.cancel()
        self._channel.close()
