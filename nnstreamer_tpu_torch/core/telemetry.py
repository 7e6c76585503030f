"""Telemetry: the metrics registry, Prometheus exposition, trace meta keys,
per-stream SLO accounting and the flight recorder.

Port of ``nnstreamer_tpu/core/telemetry.py``.  Every signal of a running
pipeline (element ``health_info()`` counters, the tracer's per-element
statistics, the filter's dispatch window and ingest lane, the generator's
slot engine and SLO rows, the staging-buffer pools) gets a STABLE dotted
name in :data:`METRICS`, is collected at scrape time into one process-wide
:data:`REGISTRY` and served as Prometheus text
(``Pipeline.serve_metrics(port)`` / ``NNS_METRICS_PORT``).  The flight
recorder keeps a bounded ring of recent per-frame spans and dumps it
(rate-limited, to the log and a JSON file) on an incident: a watchdog
stall, a dead letter, a swap rollback, memory pressure.

Cost contract: the disabled path stays one branch per frame (the
scheduler's ``tracer is not None`` test; the recorder rides the tracer),
and collection runs only at scrape or snapshot time.  Nothing here
synchronizes the card or copies a card tensor to the host: a dump
``repr``s its detail.

The catalog holds the JAX package's names for the series the port emits,
the query elements' ``nns.query.*`` (server admission and integrity, the
per-tenant rows, the client's counters, breakers, per-remote span EWMAs
and ``nns.query.rtt_seconds``) and the memory monitor's ``nns.mem.*``
(exported through the query server's health row) among them, and
the discovery plane's announce reconnects (``nns.query.reannounces``,
``nns.query.plane_reconnects``, on the serversrc's health row while it
announces), the query client's stream-resume counters, the slot engine's
resume, hand-off and resize counters, the digest and fencing series, the
fleet observatory's ``nns.fleet.*`` and the autoscaler's
``nns.autoscale.*``, the trainer's ``nns.train.*`` and the datarepo's
``nns.datarepo.truncated_samples``.  Not ported: the serving mesh's
``nns.mesh.*`` (ROADMAP A11), the validator's ``nns.train.*`` series
(A9.2), and the frame pool's ``nns.pool.frame_*`` (the port has no
``FramePool``).
"""

from __future__ import annotations

import itertools
import json
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .log import get_logger

log = get_logger("telemetry")

# ---------------------------------------------------------------------------
# Trace-context meta keys
# ---------------------------------------------------------------------------
#: meta keys with this prefix are HOST-LOCAL (monotonic-clock stamps,
#: in-process handles): instants never cross a wire, only durations do
TL_PREFIX = "_nns_tl_"
#: per-request trace id (string), minted at the source while a flight
#: recorder is armed; the recorder's spans are keyed by it
TRACE_ID_META = "_nns_trace_id"
#: server receive stamp (perf_counter, host-local; stamped at admission)
TL_RX_META = "_nns_tl_rx"
#: filter invoke stamps: (dispatch_s, compute_s) durations, host-local
TL_INVOKE_META = "_nns_tl_invoke"
#: client enqueue stamp (perf_counter at a query client's doorstep)
TL_ENQ_META = "_nns_tl_enq"
#: mailbox enqueue stamp (perf_counter at ``_push``; popped at dequeue
#: into the consuming element's queue-wait histogram), written only while
#: a tracer is armed
TL_QPUT_META = "_nns_tl_qput"
#: the client-local end-to-end decomposition attached to answer frames
SPAN_META = "_nns_tl_span"
#: server-side duration dict {"queue","dispatch","compute","total"}
SRV_SPAN_META = "_nns_srv_span"

_trace_seq = itertools.count(1)
_TRACE_PREFIX = f"{os.getpid():x}"


def new_trace_id() -> str:
    """Cheap per-request trace id, unique within a fleet window."""
    return f"{_TRACE_PREFIX}-{next(_trace_seq)}"


# ---------------------------------------------------------------------------
# Stable metric-name catalog
# ---------------------------------------------------------------------------
#: every registry name the port emits, with kind and one-line help (the
#: JAX package's entries, word for word)
METRICS: Dict[str, Tuple[str, str]] = {
    # per-element dataplane (PipelineTracer-fed)
    "nns.element.frames": ("counter", "logical frames out of the element"),
    "nns.element.calls": ("counter", "handler calls (micro-batches count once)"),
    "nns.element.proctime_us": ("gauge", "mean handler wall time, us"),
    "nns.element.proctime_p99_us": ("gauge", "p99 handler wall time, us"),
    "nns.element.fps": ("gauge", "logical frames/sec out of the element"),
    "nns.element.interlatency_ms": ("gauge", "mean source-to-here latency, ms"),
    "nns.element.queue_depth": ("gauge", "mean mailbox depth at dequeue"),
    "nns.element.queue_capacity": ("gauge", "mailbox capacity"),
    "nns.element.bitrate_mbps": ("gauge", "payload megabits/sec through the element"),
    # supervision counters (Pipeline.health)
    "nns.element.restarts": ("counter", "lifetime supervisor restarts"),
    "nns.element.restarts_window": ("gauge", "restarts within the current restart-window"),
    "nns.element.dead_letters": ("counter", "frames dropped under error-policy=skip"),
    "nns.element.dead_letter_depth": ("gauge", "retained dead-letter frames"),
    "nns.element.deadline_drops": ("counter", "frames expired before processing"),
    "nns.element.stalls": ("counter", "watchdog stall episodes"),
    "nns.element.overruns": ("counter", "watchdog frame-deadline overruns"),
    # lifecycle states (numeric codes)
    "nns.lifecycle.state": ("gauge", "element supervision state code"),
    "nns.lifecycle.swap_state": ("gauge", "hot-swap coordinator state code"),
    "nns.pipeline.delivered": ("counter", "logical frames consumed by terminal elements"),
    "nns.pipeline.errors": ("gauge", "recorded fatal element errors"),
    # tensor_filter + async device feed (core/feed.py)
    "nns.filter.invokes": ("counter", "backend invoke calls"),
    "nns.filter.invoked_frames": ("counter", "logical frames through the backend"),
    "nns.filter.invoke_latency": ("gauge", "mean per-frame invoke latency, seconds (latency=1)"),
    "nns.filter.model_version": ("gauge", "hot-swap model version"),
    "nns.filter.swaps": ("counter", "committed hot model swaps"),
    "nns.filter.swap_failures": ("counter", "staging/inline reload failures"),
    "nns.filter.rollbacks": ("counter", "observation-window rollbacks"),
    "nns.feed.window_occupancy": ("gauge", "micro-batches parked in the dispatch window"),
    "nns.feed.window_reaped": ("counter", "batches materialized by the window reaper"),
    "nns.feed.dispatch_waits": ("counter", "full-window backpressure waits"),
    "nns.feed.lane_pending": ("gauge", "staging jobs queued on the ingest lane"),
    "nns.feed.lane_staged": ("counter", "micro-batches staged by the ingest lane"),
    # always-on latency histograms (log2 buckets; armed with the tracer)
    "nns.element.handle_seconds": ("histogram", "per-element handler wall time, log2 buckets"),
    "nns.element.handle_p50_us": ("gauge", "p50 handler wall time, us (log2 estimate)"),
    "nns.element.handle_p95_us": ("gauge", "p95 handler wall time, us (log2 estimate)"),
    "nns.element.handle_p99_us": ("gauge", "p99 handler wall time, us (log2 estimate)"),
    "nns.element.queue_wait_seconds": ("histogram", "mailbox wait, producer handoff to dequeue, log2 buckets"),
    "nns.element.queue_wait_p50_us": ("gauge", "p50 mailbox queue wait, us (log2 estimate)"),
    "nns.element.queue_wait_p99_us": ("gauge", "p99 mailbox queue wait, us (log2 estimate)"),
    "nns.feed.window_dwell_seconds": ("histogram", "micro-batch dwell in the completion window, log2 buckets"),
    "nns.feed.window_dwell_p50_us": ("gauge", "p50 completion-window dwell, us (log2 estimate)"),
    "nns.feed.window_dwell_p99_us": ("gauge", "p99 completion-window dwell, us (log2 estimate)"),
    # profilers (jax trace session + incident-time thread sampler)
    "nns.profiler.active": ("gauge", "1 while the element holds a jax-profiler trace ref"),
    "nns.profiler.captures": ("counter", "thread-profile captures attached to incident dumps"),
    # tensor_query server (admission / wire integrity / rolling restart)
    "nns.lifecycle.server_state": ("gauge", "query-server serving/draining/stopped code"),
    "nns.query.inflight": ("gauge", "requests admitted and not yet answered"),
    "nns.query.admitted": ("counter", "requests admitted"),
    "nns.query.load_shed": ("counter", "requests refused with BUSY"),
    "nns.query.shedding": ("gauge", "1 while admission hysteresis refuses work"),
    "nns.query.admission_high": ("gauge", "admission high watermark"),
    "nns.query.admission_low": ("gauge", "admission low watermark"),
    "nns.query.ingress_depth": ("gauge", "frames queued for the server pipeline"),
    "nns.query.corrupt_requests": ("counter", "corrupt requests refused"),
    "nns.query.goaway_sent": ("counter", "requests refused with GOAWAY"),
    # per-tenant admission (TenantAdmissionController; tenant= label)
    "nns.query.tenant_inflight": ("gauge", "requests in flight for the tenant"),
    "nns.query.tenant_admitted": ("counter", "requests admitted for the tenant"),
    "nns.query.tenant_shed": ("counter", "requests shed for the tenant (quota/priority/load)"),
    "nns.query.tenant_quota": ("gauge", "in-flight quota governing the tenant (0 = unlimited)"),
    # tensor_query client (failover / integrity / degrade / spans)
    "nns.query.client_inflight": ("gauge", "client requests dispatched and unanswered"),
    "nns.query.affinity_remaps": ("counter", "consistent-hash affinity owner changes (fleet resizes)"),
    "nns.query.remote_inflight": ("gauge", "live client requests in flight to the remote"),
    "nns.query.delivered": ("counter", "logical frames answered by a server"),
    "nns.query.retried": ("counter", "extra attempts dispatched, all causes"),
    "nns.query.busy_replies": ("counter", "BUSY sheds seen"),
    "nns.query.goaway_replies": ("counter", "GOAWAY refusals seen"),
    "nns.query.deadline_expired": ("counter", "requests abandoned: budget ran out"),
    "nns.query.corruption_detected": ("counter", "corrupt exchanges detected"),
    "nns.query.degraded_frames": ("counter", "frames answered by degrade= instead of a server"),
    "nns.query.stream_resumes": ("counter", "generation streams resumed after a mid-stream break"),
    "nns.query.stream_migrations": ("counter", "generation streams migrated off a draining server"),
    "nns.query.duplicate_tokens_dropped": ("counter", "post-resume overlap tokens deduped (exactly-once)"),
    "nns.query.resume_failures": ("counter", "stream resume attempts that failed (reject/no-progress/exhaustion)"),
    "nns.query.breaker_trips_evicted": ("counter", "trips of breakers evicted on pool swaps"),
    "nns.query.breaker_open": ("gauge", "1 while the remote's breaker is open"),
    "nns.query.breaker_trips": ("counter", "lifetime breaker trips for the remote"),
    "nns.query.breaker_failures": ("gauge", "failures in the breaker's rolling window"),
    "nns.query.rtt_seconds": ("histogram", "client-observed round-trip time"),
    # per-remote span aggregation (the ewma routing policy's load signal)
    "nns.query.remote_requests": ("counter", "requests answered by the remote"),
    "nns.query.remote_e2e_ms": ("gauge", "EWMA end-to-end latency via the remote"),
    "nns.query.remote_rtt_ms": ("gauge", "EWMA wire round-trip via the remote"),
    "nns.query.remote_wire_ms": ("gauge", "EWMA wire-only segment via the remote"),
    "nns.query.remote_server_ms": ("gauge", "EWMA server-side time via the remote"),
    "nns.query.remote_client_queue_ms": ("gauge", "EWMA client-queue segment"),
    # -- memory-pressure watermarks (core/liveness.py monitor) -------------
    "nns.mem.bytes_in_use": ("gauge", "device HBM bytes in use (most-loaded chip)"),
    "nns.mem.bytes_limit": ("gauge", "device HBM capacity (most-loaded chip; 0 = unreported)"),
    "nns.mem.host_rss": ("gauge", "process resident set size, bytes"),
    "nns.mem.fraction": ("gauge", "watermark fraction driving the pressure state"),
    "nns.mem.pressure": ("gauge", "1 while above the high memory watermark (hysteresis)"),
    "nns.mem.polls": ("counter", "watermark evaluations (sweeper cadence)"),
    "nns.mem.trims": ("counter", "pool/cache trim sweeps fired at the high watermark"),
    "nns.mem.trimmed_entries": ("counter", "entries freed by memory-pressure trims"),
    "nns.mem.incidents": ("counter", "sustained-pressure flight-recorder incidents"),
    "nns.query.memory_shed": ("counter", "requests shed with BUSY at the memory watermark"),
    # -- the discovery plane (announce client of the query serversrc) -----
    "nns.query.reannounces": ("counter", "retained announces re-published after a broker reconnect"),
    "nns.query.plane_reconnects": ("counter", "announce-client broker reconnects (restart or failover)"),
    # -- fenced actuation and telemetry digests (the serversrc, the generator)
    "nns.query.digests": ("counter", "telemetry digests published on the discovery plane"),
    "nns.query.digest_publish_failures": ("counter", "digest publishes refused while the broker was unreachable"),
    "nns.query.stale_epoch_rejects": ("counter", "fenced drain commands refused for a stale lease epoch"),
    "nns.query.fence_epoch": ("gauge", "highest lease epoch this server has accepted"),
    "nns.gen.stale_epoch_rejects": ("counter", "fenced resize commands refused for a stale lease epoch"),
    "nns.gen.fence_epoch": ("gauge", "highest lease epoch this generator has accepted"),
    # -- the fleet observatory (core/fleet.py; fleet= label) ---------------
    "nns.fleet.prefix_hits": ("counter", "prefix-cache hits fleet-wide (retired servers included)"),
    "nns.fleet.prefix_misses": ("counter", "prefix-cache misses fleet-wide (retired servers included)"),
    "nns.fleet.prefix_hit_ratio": ("gauge", "fleet prefix-cache hit ratio (hits / eligible lookups)"),
    "nns.fleet.prefix_entries": ("gauge", "cached prefix entries fleet-wide (live servers)"),
    "nns.fleet.servers": ("gauge", "live servers with a fresh digest"),
    "nns.fleet.draining": ("gauge", "live servers announcing draining"),
    "nns.fleet.degraded": ("gauge", "live servers announcing degraded"),
    "nns.fleet.swapping": ("gauge", "live servers mid hot-swap"),
    "nns.fleet.mem_pressured": ("gauge", "live servers above their memory watermark"),
    "nns.fleet.inflight": ("gauge", "requests in flight fleet-wide"),
    "nns.fleet.slots": ("gauge", "generation slots fleet-wide"),
    "nns.fleet.occupied": ("gauge", "occupied generation slots fleet-wide"),
    "nns.fleet.waiting": ("gauge", "prompts queued for a slot fleet-wide"),
    "nns.fleet.occupancy": ("gauge", "fleet slot occupancy (occupied / slots)"),
    "nns.fleet.tokens_per_s": ("gauge", "aggregate decode throughput, tokens/s (sum of live EWMAs)"),
    "nns.fleet.slot_headroom": ("gauge", "admittable free slots on unpressured servers"),
    "nns.fleet.mem_headroom_bytes": ("gauge", "bytes until the memory high watermark, fleet-wide"),
    "nns.fleet.tokens": ("counter", "tokens decoded fleet-wide (retired servers included)"),
    "nns.fleet.admitted": ("counter", "requests admitted fleet-wide (retired servers included)"),
    "nns.fleet.shed": ("counter", "requests shed fleet-wide (retired servers included)"),
    "nns.fleet.tenant_admitted": ("counter", "requests admitted for the tenant, fleet-wide"),
    "nns.fleet.tenant_shed": ("counter", "requests shed for the tenant, fleet-wide"),
    "nns.fleet.slo_burn": ("gauge", "worst per-tenant SLO burn rate across live servers"),
    "nns.fleet.digests": ("counter", "digests ingested by the observatory"),
    "nns.fleet.retired": ("counter", "server rows retired on announce tombstone"),
    "nns.fleet.stale_evicted": ("counter", "server rows retired on digest TTL expiry"),
    "nns.fleet.stale": ("gauge", "live-but-stale servers (digest older than the stale threshold; excluded from headroom)"),
    "nns.fleet.retired_evicted": ("counter", "retired-server snapshots evicted by the ledger cap (aggregates preserved)"),
    "nns.fleet.ttft_p95_ms": ("gauge", "worst per-server p95 time to first token across fresh digests, ms"),
    "nns.fleet.plane_connected": ("gauge", "1 while the observatory's broker connection is up"),
    "nns.fleet.plane_ingest_age_s": ("gauge", "seconds since the observatory last ingested any digest"),
    "nns.fleet.plane_reconnects": ("counter", "observatory broker reconnects (restart/failover dials that succeeded)"),
    # -- fleet autoscaling (core/autoscale.py FleetController) -------------
    "nns.autoscale.ticks": ("counter", "controller decision-loop evaluations"),
    "nns.autoscale.decisions": ("counter", "actions emitted by the planner"),
    "nns.autoscale.scale_ups": ("counter", "spawn actions dispatched to the actuator"),
    "nns.autoscale.scale_downs": ("counter", "zero-loss drain actions dispatched to the actuator"),
    "nns.autoscale.resizes": ("counter", "slot-width resize actions dispatched to the actuator"),
    "nns.autoscale.actions_failed": ("counter", "actuator tickets that completed unsuccessfully"),
    "nns.autoscale.actions_inflight": ("gauge", "actuator tickets dispatched but not yet complete"),
    "nns.autoscale.cooldown_skips": ("counter", "wanted actions suppressed by a per-kind cooldown"),
    "nns.autoscale.hysteresis_holds": ("counter", "pressure ticks held below the hysteresis streak"),
    "nns.autoscale.envelope_clamps": ("counter", "wanted actions clamped by the min/max fleet envelope"),
    "nns.autoscale.inflight_skips": ("counter", "targets skipped because an action is already in flight"),
    "nns.autoscale.predictive_decisions": ("counter", "decisions driven by the fitted performance model"),
    "nns.autoscale.reactive_decisions": ("counter", "decisions driven by the reactive (observed) path"),
    "nns.autoscale.model_samples": ("gauge", "observations banked by the performance model"),
    "nns.autoscale.model_ready": ("gauge", "1 when the predictive model has enough samples to act"),
    "nns.autoscale.target_servers": ("gauge", "fleet size the controller is steering toward"),
    "nns.autoscale.frozen": ("counter", "actions the fail-static ladder froze instead of dispatching (reason= label breaks down the cause)"),
    "nns.autoscale.plane_level": ("gauge", "assessed control-plane view: 0 ok / 1 degraded / 2 blind"),
    "nns.autoscale.standby_ticks": ("counter", "ticks spent standby (leader lease not held)"),
    "nns.autoscale.lease_held": ("gauge", "1 while this controller holds the leader lease"),
    "nns.autoscale.lease_epoch": ("gauge", "this controller's lease epoch (monotonic across takeovers)"),
    "nns.autoscale.lease_acquires": ("counter", "leader-lease acquisitions (vacant grant or expiry takeover)"),
    "nns.autoscale.lease_steals": ("counter", "expired foreign leases taken over"),
    "nns.autoscale.lease_losses": ("counter", "leaderships lost (superseding epoch, split-lease resolution, or self-fence)"),
    "nns.autoscale.lease_refusals": ("counter", "acquire attempts refused because a fresh foreign lease exists"),
    # -- pub/sub sources (mqttsrc, edgesrc, tensor_src_grpc) -----------------
    "nns.wire.corrupt_dropped": ("counter", "undecodable pub/sub frames dropped"),
    # -- continuous batching (core/slots.py + tensor_generator) ------------
    "nns.gen.slots": ("gauge", "configured slot-batch width"),
    "nns.gen.occupied": ("gauge", "slots held by live generation streams"),
    "nns.gen.waiting": ("gauge", "prompts queued for a free slot"),
    "nns.gen.joins": ("counter", "streams that claimed a slot"),
    "nns.gen.completed": ("counter", "streams that finished their tokens"),
    "nns.gen.evicted": ("counter", "streams evicted on deadline/pace (typed expiry)"),
    "nns.gen.cancelled": ("counter", "streams cancelled (consumer gone)"),
    "nns.gen.tokens": ("counter", "tokens decoded across all slots"),
    "nns.gen.decode_steps": ("counter", "slot-batch decode steps"),
    "nns.gen.prefill_chunks": ("counter", "chunked-prefill pieces interleaved"),
    "nns.gen.tokens_per_step": ("gauge", "EWMA active slots per decode step"),
    "nns.gen.jit_buckets": ("gauge", "live decode/prefill compile buckets (LRU-bounded)"),
    "nns.gen.resumes": ("counter", "streams joined from a RESUME checkpoint"),
    "nns.gen.goaway_evicted": ("counter", "live streams handed off as resumable GOAWAY chunks on drain"),
    "nns.gen.resume_rejects": ("counter", "RESUME requests refused (signature/digest/shape mismatch)"),
    "nns.gen.resizes": ("counter", "zero-loss slot-width rebuilds (autoscale resize actuation)"),
    # -- shared-prefix KV cache (core/slots.py PrefixCache) ----------------
    "nns.prefix.hits": ("counter", "eligible prompts that attached cached prefix pages"),
    "nns.prefix.misses": ("counter", "eligible prompts that found no cached prefix chunk"),
    "nns.prefix.publishes": ("counter", "prefix grain chunks published for reuse"),
    "nns.prefix.evictions": ("counter", "cached prefix entries reclaimed (LRU cap, trim, or remesh)"),
    "nns.prefix.entries": ("gauge", "live cached prefix entries"),
    "nns.prefix.refs": ("gauge", "pins held by live reader streams (refcounted entries)"),
    "nns.prefix.bytes": ("gauge", "bytes held by the shared-prefix page pool"),
    "nns.prefix.hit_tokens": ("counter", "prefill tokens skipped via prefix attach"),
    # -- device-resource resilience (OOM / device loss; core/resilience.py)
    "nns.device.oom_retries": ("counter", "invokes retried after a device OOM"),
    "nns.device.oom_shrinks": ("counter", "micro-batches split to a smaller bucket on OOM"),
    "nns.device.oom_evictions": ("counter", "cache/pool entries trimmed by OOM recovery"),
    "nns.device.lost": ("counter", "device-loss events seen by the element"),
    "nns.device.remeshes": ("counter", "backends/models rebuilt on surviving devices"),
    "nns.device.degraded": ("gauge", "1 while serving in a reduced (post-loss) configuration"),
    "nns.gen.oom_retries": ("counter", "slot-engine device steps retried after an OOM"),
    "nns.gen.oom_sheds": ("counter", "slots shed resumably to relieve HBM pressure"),
    "nns.gen.device_lost": ("counter", "lost-device events survived by the slot engine"),
    "nns.gen.device_lost_evicted": ("counter", "live streams handed off on device loss"),
    "nns.gen.remeshes": ("counter", "slot models rebuilt on surviving devices"),
    # -- per-stream SLO accounting (SloTracker; tenant= label) -------------
    "nns.slo.ttft_seconds": ("histogram", "time to first token, log2 buckets"),
    "nns.slo.ttft_p95_ms": ("gauge", "p95 time to first token, ms (log2 estimate)"),
    "nns.slo.ttft_burn": ("gauge", "TTFT error-budget burn rate (1.0 = consuming exactly the budget)"),
    "nns.slo.token_seconds": ("histogram", "per-token inter-arrival time, log2 buckets"),
    "nns.slo.token_p99_ms": ("gauge", "p99 per-token inter-arrival, ms (log2 estimate)"),
    "nns.slo.token_burn": ("gauge", "per-token-latency error-budget burn rate"),
    "nns.slo.availability": ("gauge", "observed goodput fraction (good / classified streams)"),
    "nns.slo.availability_burn": ("gauge", "availability error-budget burn rate"),
    "nns.slo.status": ("gauge", "worst armed objective: 0 met / 1 warn / 2 burned"),
    "nns.slo.good": ("counter", "streams that completed to their final token (goodput)"),
    "nns.slo.shed": ("counter", "streams refused by admission (BUSY exhausted)"),
    "nns.slo.evicted": ("counter", "streams cancelled/evicted before completion"),
    "nns.slo.expired": ("counter", "streams evicted on deadline/pace (typed expiry)"),
    "nns.slo.errors": ("counter", "streams lost to transport/server errors"),
    # sources/sinks
    "nns.source.pending": ("gauge", "frames pushed but not yet pulled (appsrc)"),
    "nns.sink.rendered": ("counter", "logical frames rendered by the sink"),
    "nns.datarepo.truncated_samples": ("counter", "samples lost to a truncated repo"),
    # pools (process-wide; core/buffer.py)
    "nns.pool.device_allocated": ("counter", "staging buffers freshly allocated"),
    "nns.pool.device_reused": ("counter", "staging buffers reused"),
    "nns.pool.device_reuse_rate": ("gauge", "staging-buffer reuse fraction"),
    "nns.pool.rings_evicted": ("counter", "staging-buffer rings evicted by the key-space LRU"),
    "nns.pool.trims": ("counter", "staging-pool memory-pressure trims"),
    # -- in-pipeline training (elements/trainer.py) --
    "nns.train.steps": ("counter", "optimizer steps taken (monotone across resumes)"),
    "nns.train.samples": ("counter", "samples consumed by train steps"),
    "nns.train.epochs": ("counter", "training epochs completed"),
    "nns.train.loss": ("gauge", "most recent training loss"),
    "nns.train.checkpoints": ("counter", "durable (marker-committed) checkpoints written"),
    "nns.train.resumes": ("counter", "trainer starts that resumed from a durable checkpoint"),
    "nns.train.replay_skipped": ("counter", "already-trained samples skipped on resume (exactly-once accounting)"),
    "nns.train.gap_samples": ("counter", "partial-epoch samples dropped realigning after a mid-stream restart"),
    "nns.train.pauses": ("counter", "memory-watermark pauses of the train loop"),
    "nns.train.paused": ("gauge", "1 while train steps are paused (pressure or operator)"),
    "nns.train.restarts": ("counter", "trainer-backend revivals through the supervisor"),
    "nns.train.alive": ("gauge", "1 while the training thread is running"),
    # flight recorder
    "nns.flight.dumps": ("counter", "flight-recorder incident dumps written"),
}

#: numeric state -> code maps
STATE_CODES = {
    "idle": 0, "running": 1, "restarting": 2, "degraded": 3,
    "failed": 4, "finished": 5, "stalled": 6,
}
SERVER_STATE_CODES = {"stopped": 0, "serving": 1, "draining": 2}
SWAP_STATE_CODES = {"idle": 0, "staging": 1, "staged": 2, "observing": 3}

#: ``health_info()`` keys with an explicit stable metric name; numeric
#: keys absent here export as ``nns.health.<key>`` (gauge)
HEALTH_KEY_METRICS: Dict[str, str] = {
    "restarts": "nns.element.restarts",
    "restarts_window": "nns.element.restarts_window",
    "dead_letters": "nns.element.dead_letters",
    "dead_letter_depth": "nns.element.dead_letter_depth",
    "deadline_drops": "nns.element.deadline_drops",
    "stalls": "nns.element.stalls",
    "overruns": "nns.element.overruns",
    "model_version": "nns.filter.model_version",
    "swaps": "nns.filter.swaps",
    "swap_failures": "nns.filter.swap_failures",
    "rollbacks": "nns.filter.rollbacks",
    "pending_frames": "nns.source.pending",
    "rendered_frames": "nns.sink.rendered",
    "gen_slots": "nns.gen.slots",
    "gen_occupied": "nns.gen.occupied",
    "gen_waiting": "nns.gen.waiting",
    "gen_joins": "nns.gen.joins",
    "gen_completed": "nns.gen.completed",
    "gen_evicted": "nns.gen.evicted",
    "gen_cancelled": "nns.gen.cancelled",
    "gen_tokens": "nns.gen.tokens",
    "gen_decode_steps": "nns.gen.decode_steps",
    "gen_prefill_chunks": "nns.gen.prefill_chunks",
    "gen_tokens_per_step": "nns.gen.tokens_per_step",
    "gen_jit_buckets": "nns.gen.jit_buckets",
    "gen_resume_rejects": "nns.gen.resume_rejects",
    "gen_resumes": "nns.gen.resumes",
    "gen_goaway_evicted": "nns.gen.goaway_evicted",
    "gen_resizes": "nns.gen.resizes",
    "gen_stale_epoch_rejects": "nns.gen.stale_epoch_rejects",
    "gen_fence_epoch": "nns.gen.fence_epoch",
    # shared-prefix KV cache (engine.snapshot carries these only when armed)
    "prefix_hits": "nns.prefix.hits",
    "prefix_misses": "nns.prefix.misses",
    "prefix_publishes": "nns.prefix.publishes",
    "prefix_evictions": "nns.prefix.evictions",
    "prefix_entries": "nns.prefix.entries",
    "prefix_refs": "nns.prefix.refs",
    "prefix_bytes": "nns.prefix.bytes",
    "prefix_hit_tokens": "nns.prefix.hit_tokens",
    "profiler_active": "nns.profiler.active",
    # device-resource resilience (filter + slot engine)
    "oom_retries": "nns.device.oom_retries",
    "oom_shrinks": "nns.device.oom_shrinks",
    "oom_evictions": "nns.device.oom_evictions",
    "device_lost": "nns.device.lost",
    "remeshes": "nns.device.remeshes",
    "degraded": "nns.device.degraded",
    "gen_oom_retries": "nns.gen.oom_retries",
    "gen_oom_sheds": "nns.gen.oom_sheds",
    "gen_device_lost": "nns.gen.device_lost",
    "gen_device_lost_evicted": "nns.gen.device_lost_evicted",
    "gen_remeshes": "nns.gen.remeshes",
    # query server (admission, integrity, rolling restart)
    "inflight": "nns.query.inflight",
    "admitted": "nns.query.admitted",
    "load_shed": "nns.query.load_shed",
    "shedding": "nns.query.shedding",
    "admission_high": "nns.query.admission_high",
    "admission_low": "nns.query.admission_low",
    "ingress_depth": "nns.query.ingress_depth",
    "corrupt_requests": "nns.query.corrupt_requests",
    "goaway_sent": "nns.query.goaway_sent",
    # query client
    "delivered": "nns.query.delivered",
    "retried": "nns.query.retried",
    "busy_replies": "nns.query.busy_replies",
    "goaway_replies": "nns.query.goaway_replies",
    "deadline_expired": "nns.query.deadline_expired",
    "corruption_detected": "nns.query.corruption_detected",
    "degraded_frames": "nns.query.degraded_frames",
    "breaker_trips_evicted": "nns.query.breaker_trips_evicted",
    "affinity_remaps": "nns.query.affinity_remaps",
    "stream_resumes": "nns.query.stream_resumes",
    "stream_migrations": "nns.query.stream_migrations",
    "duplicate_tokens_dropped": "nns.query.duplicate_tokens_dropped",
    "resume_failures": "nns.query.resume_failures",
    # memory watermarks (the serversrc's health row)
    "mem_bytes_in_use": "nns.mem.bytes_in_use",
    "mem_bytes_limit": "nns.mem.bytes_limit",
    "mem_host_rss": "nns.mem.host_rss",
    "mem_fraction": "nns.mem.fraction",
    "mem_pressure": "nns.mem.pressure",
    "mem_polls": "nns.mem.polls",
    "mem_trims": "nns.mem.trims",
    "mem_trimmed_entries": "nns.mem.trimmed_entries",
    "mem_incidents": "nns.mem.incidents",
    "memory_shed": "nns.query.memory_shed",
    # the discovery plane (the serversrc's health row while announcing)
    "reannounces": "nns.query.reannounces",
    "plane_reconnects": "nns.query.plane_reconnects",
    # telemetry digests and fencing (the serversrc's health row)
    "digests_published": "nns.query.digests",
    "digest_publish_failures": "nns.query.digest_publish_failures",
    "stale_epoch_rejects": "nns.query.stale_epoch_rejects",
    "fence_epoch": "nns.query.fence_epoch",
    # pub/sub sources' integrity (mqttsrc, edgesrc, tensor_src_grpc)
    "corrupt_dropped": "nns.wire.corrupt_dropped",
    "truncated_samples": "nns.datarepo.truncated_samples",
    # in-pipeline training (tensor_trainer's health row)
    "train_steps": "nns.train.steps",
    "train_samples": "nns.train.samples",
    "train_epochs": "nns.train.epochs",
    "train_loss": "nns.train.loss",
    "train_checkpoints": "nns.train.checkpoints",
    "train_resumes": "nns.train.resumes",
    "train_replay_skipped": "nns.train.replay_skipped",
    "train_gap_samples": "nns.train.gap_samples",
    "train_pauses": "nns.train.pauses",
    "train_paused": "nns.train.paused",
    "train_restarts": "nns.train.restarts",
    "train_alive": "nns.train.alive",
}

#: non-numeric / structured health keys handled specially (or skipped) by
#: the collector, never auto-exported.  ``oom_trimmed_bytes`` (the card
#: bytes the filter's OOM trims released) is a health key the JAX package
#: has no series for, so it stays in ``health()`` only.
HEALTH_KEYS_SPECIAL = (
    "state", "policy", "last_error", "model", "servers", "breakers",
    "remotes", "lifecycle", "swap_state", "swap_last_error",
    # fleet routing / tenancy (dedicated collector branches)
    "tenants", "remote_inflight", "endpoint_hints", "routing",
    # per-tenant SLO rows ({tenant: SloTracker row}: dedicated branch)
    "slo",
    # background-thread census ({thread name: ThreadBeat.snapshot()})
    "threads",
    "oom_trimmed_bytes",
)


def metric_kind(name: str) -> str:
    if name in METRICS:
        return METRICS[name][0]
    return "gauge"  # nns.health.<key> fallbacks


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------
def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def samples(self) -> List["Sample"]:
        return [Sample(self.name, self.labels, self._value, "counter")]


class Gauge:
    """Point-in-time value; ``set_fn`` makes it poll-at-scrape (no hot-path
    cost: the callback runs only when someone reads)."""

    __slots__ = ("name", "labels", "_value", "_fn")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        self._value = float(v)

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # a scrape must never die on a gauge callback
                log.exception("gauge callback failed for %s", self.name)
                return 0.0
        return self._value

    def samples(self) -> List["Sample"]:
        return [Sample(self.name, self.labels, self.value, "gauge")]


#: default histogram buckets: request-latency shaped, seconds
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0,
)


class Histogram:
    """Fixed-bucket histogram (Prometheus classic histogram semantics)."""

    __slots__ = ("name", "labels", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = dict(labels or {})
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def samples(self) -> List["Sample"]:
        out: List[Sample] = []
        with self._lock:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[i]
                out.append(Sample(f"{self.name}_bucket", {**self.labels, "le": repr(b)},
                                  cum, "counter"))
            cum += self._counts[-1]
            out.append(Sample(f"{self.name}_bucket", {**self.labels, "le": "+Inf"},
                              cum, "counter"))
            out.append(Sample(f"{self.name}_sum", self.labels, self._sum, "counter"))
            out.append(Sample(f"{self.name}_count", self.labels, self._count, "counter"))
        return out


#: log2 bucket layout shared by every Log2Histogram: boundary i is
#: 2**(LOG2_E_MIN + i) seconds — 2^-20 s (~1 µs) up to 2^4 s (16 s),
#: plus one overflow bucket
LOG2_E_MIN = -20
LOG2_NBUCKETS = 25  # boundaries 2^-20 .. 2^4
_LOG2_SCALE = float(2 ** -LOG2_E_MIN)
LOG2_BOUNDS = tuple(2.0 ** (LOG2_E_MIN + i) for i in range(LOG2_NBUCKETS))


class Log2Histogram:
    """Fixed-bucket log2-scale latency histogram, hot-path-safe.

    The record path is one float multiply, one ``int.bit_length`` and one
    list increment: no lock and no allocation.  The contract is
    SINGLE-WRITER per instrument (each element's handler, each mailbox's
    consumer and each dispatch window's ``pop_ready`` runs on one thread);
    scrape-time readers may see a snapshot off by the observation in
    flight.  Quantiles are log-linear interpolations within a bucket, so
    they carry about 2x resolution."""

    __slots__ = ("_counts", "_sum")

    def __init__(self):
        self._counts = [0] * (LOG2_NBUCKETS + 1)  # +1: overflow tail
        self._sum = 0.0

    def record(self, seconds: float) -> None:
        # bucket i collects v in [2^(i-1), 2^i) * 2^LOG2_E_MIN seconds
        idx = int(seconds * _LOG2_SCALE).bit_length()
        if idx > LOG2_NBUCKETS:
            idx = LOG2_NBUCKETS
        self._counts[idx] += 1
        self._sum += seconds

    def record_n(self, seconds: float, n: int) -> None:
        """``n`` observations of the same value in ONE bucket increment
        (per-token inter-arrival of an n-token decode call)."""
        idx = int(seconds * _LOG2_SCALE).bit_length()
        if idx > LOG2_NBUCKETS:
            idx = LOG2_NBUCKETS
        self._counts[idx] += n
        self._sum += seconds * n

    def count_over(self, seconds: float) -> int:
        """Observations in buckets strictly ABOVE the bucket holding
        ``seconds``: the bucket-grain, deterministic violation count the
        SLO burn rates are computed from."""
        idx = int(seconds * _LOG2_SCALE).bit_length()
        if idx >= LOG2_NBUCKETS:
            return 0
        return sum(self._counts[idx + 1:])

    @property
    def count(self) -> int:
        return sum(self._counts)

    @property
    def sum(self) -> float:
        return self._sum

    def state(self) -> Tuple[int, ...]:
        """Immutable bucket-count snapshot."""
        return tuple(self._counts)

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile in seconds (None when empty)."""
        counts = list(self._counts)
        total = sum(counts)
        if total == 0:
            return None
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c and cum + c >= target:
                lo = 0.0 if i == 0 else 2.0 ** (LOG2_E_MIN + i - 1)
                hi = 2.0 ** (LOG2_E_MIN + min(i, LOG2_NBUCKETS))
                return lo + (hi - lo) * (target - cum) / c
            cum += c
        return 2.0 ** (LOG2_E_MIN + LOG2_NBUCKETS)

    def percentiles_us(self) -> Dict[str, float]:
        """{p50, p95, p99} in microseconds (empty dict when empty)."""
        out: Dict[str, float] = {}
        for tag, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            v = self.quantile(q)
            if v is None:
                return {}
            out[tag] = v * 1e6
        return out

    def samples(self, name: str, labels: Optional[Dict[str, str]] = None) -> List["Sample"]:
        """Prometheus classic-histogram samples (cumulative le buckets)."""
        labels = dict(labels or {})
        counts = list(self._counts)
        out: List[Sample] = []
        cum = 0
        for i, b in enumerate(LOG2_BOUNDS):
            cum += counts[i]
            out.append(Sample(f"{name}_bucket", {**labels, "le": repr(b)}, cum, "counter"))
        cum += counts[-1]
        out.append(Sample(f"{name}_bucket", {**labels, "le": "+Inf"}, cum, "counter"))
        out.append(Sample(f"{name}_sum", labels, self._sum, "counter"))
        out.append(Sample(f"{name}_count", dict(labels), cum, "counter"))
        return out


#: quantile gauges derived from each log2 histogram at scrape time
HIST_QUANTILE_GAUGES: Dict[str, Tuple[Tuple[str, float], ...]] = {
    "nns.element.handle_seconds": (
        ("nns.element.handle_p50_us", 0.5),
        ("nns.element.handle_p95_us", 0.95),
        ("nns.element.handle_p99_us", 0.99),
    ),
    "nns.element.queue_wait_seconds": (
        ("nns.element.queue_wait_p50_us", 0.5),
        ("nns.element.queue_wait_p99_us", 0.99),
    ),
    "nns.feed.window_dwell_seconds": (
        ("nns.feed.window_dwell_p50_us", 0.5),
        ("nns.feed.window_dwell_p99_us", 0.99),
    ),
}


def hist_samples(name: str, hist: Log2Histogram,
                 labels: Optional[Dict[str, str]] = None) -> List["Sample"]:
    """A log2 histogram as exported samples: the classic bucket series plus
    the derived p50/p95/p99 gauges (µs) catalogued for it.  An empty
    histogram exports nothing."""
    if hist.count == 0:
        return []
    out = hist.samples(name, labels)
    for gname, q in HIST_QUANTILE_GAUGES.get(name, ()):
        v = hist.quantile(q)
        if v is not None:
            out.append(Sample(gname, dict(labels or {}), v * 1e6, "gauge"))
    return out


@dataclass
class Sample:
    """One exported measurement."""

    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    value: float = 0.0
    kind: str = "gauge"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
class MetricsRegistry:
    """Process-wide instrument table plus scrape-time collectors.

    Instruments are keyed by (name, labelset) and must use catalogued
    names (:data:`METRICS`).  Collectors are callables returning an
    iterable of :class:`Sample`; pipelines register one on ``start()`` and
    unregister on ``stop()``, so the per-frame cost lives at scrape time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, Tuple], Any] = {}
        self._collectors: List[Callable[[], Iterable[Sample]]] = []

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]], **kw) -> Any:
        if name not in METRICS and not name.startswith("nns.health."):
            raise ValueError(
                f"metric name {name!r} is not in the telemetry.METRICS catalog "
                "(stable-naming contract; add it there)")
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels, **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise ValueError(f"metric {name!r} already registered as {type(inst).__name__}")
            return inst

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def remove_labeled(self, **labels) -> int:
        """Drop every instrument whose labels include all of ``labels`` (a
        stopping pipeline evicts its instruments).  Returns the count."""
        want = set(_label_key(labels))
        with self._lock:
            doomed = [k for k in self._instruments if want <= set(k[1])]
            for k in doomed:
                del self._instruments[k]
        return len(doomed)

    def collect_labeled(self, **labels) -> List[Sample]:
        """Samples of every INSTRUMENT whose labels include ``labels``."""
        want = set(_label_key(labels))
        with self._lock:
            instruments = [inst for (name, lk), inst in self._instruments.items()
                           if want <= set(lk)]
        out: List[Sample] = []
        for inst in instruments:
            out.extend(inst.samples())
        return out

    def register_collector(self, fn: Callable[[], Iterable[Sample]]) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], Iterable[Sample]]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self) -> List[Sample]:
        with self._lock:
            instruments = list(self._instruments.values())
            collectors = list(self._collectors)
        out: List[Sample] = []
        for inst in instruments:
            out.extend(inst.samples())
        for fn in collectors:
            try:
                out.extend(fn())
            except Exception:  # a scrape must survive any collector bug
                log.exception("telemetry collector failed: %r", fn)
        return out

    # -- rendering ----------------------------------------------------------
    @staticmethod
    def _prom_name(name: str) -> str:
        return re.sub(r"[^a-zA-Z0-9_:]", "_", name)

    @staticmethod
    def _prom_labels(labels: Dict[str, str]) -> str:
        if not labels:
            return ""
        parts = []
        for k, v in sorted(labels.items()):
            v = str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
            parts.append(f'{MetricsRegistry._prom_name(str(k))}="{v}"')
        return "{" + ",".join(parts) + "}"

    def render_prometheus(self) -> str:
        """The registry as Prometheus text exposition format 0.0.4."""
        by_name: Dict[str, List[Sample]] = {}
        for s in self.collect():
            by_name.setdefault(s.name, []).append(s)
        lines: List[str] = []
        typed: set = set()
        for name in sorted(by_name):
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[: -len(suffix)] in METRICS:
                    base = name[: -len(suffix)]
            pname = self._prom_name(name)
            pbase = self._prom_name(base)
            if pbase not in typed:
                typed.add(pbase)
                kind, help_ = METRICS.get(base, ("gauge", "ad-hoc health gauge"))
                lines.append(f"# HELP {pbase} {help_}")
                lines.append(f"# TYPE {pbase} {kind}")
            for s in by_name[name]:
                v = float(s.value)
                value = repr(int(v)) if v == int(v) else repr(v)
                lines.append(f"{pname}{self._prom_labels(s.labels)} {value}")
        return "\n".join(lines) + "\n"


#: the process-wide default registry every pipeline registers into
REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# Pipeline-label claims
# ---------------------------------------------------------------------------
# Pipeline names default to "pipeline", so the ``pipeline=`` label cannot be
# the bare name: two concurrent defaults would alias each other's series.
# The first live claim of a name gets it verbatim, later concurrent claims
# "name#2", "name#3"...
_label_lock = threading.Lock()
_active_labels: set = set()


def claim_pipeline_label(name: str) -> str:
    """A pipeline= label value unique among LIVE pipelines."""
    with _label_lock:
        label, i = name, 1
        while label in _active_labels:
            i += 1
            label = f"{name}#{i}"
        _active_labels.add(label)
        return label


def release_pipeline_label(label: str) -> None:
    with _label_lock:
        _active_labels.discard(label)


# ---------------------------------------------------------------------------
# Prometheus exposition server
# ---------------------------------------------------------------------------
_live_servers_lock = threading.Lock()
_live_servers: List["MetricsServer"] = []


def live_server_count() -> int:
    """Open exposition servers."""
    with _live_servers_lock:
        return len(_live_servers)


class MetricsServer:
    """Tiny HTTP endpoint serving ``/metrics`` as Prometheus text: one
    listener socket (127.0.0.1 unless told otherwise) and one serve thread
    named ``<owner>-metrics``; :meth:`close` releases the listener
    synchronously and joins the thread."""

    def __init__(self, registry: MetricsRegistry = None, port: int = 0,
                 host: str = "127.0.0.1", name: str = "nns"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry if registry is not None else REGISTRY

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = reg.render_prometheus().encode()
                except Exception as e:  # noqa: BLE001 — scrape boundary
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # quiet scrapes
                log.debug("metrics http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"{name}-metrics", daemon=True)
        self._thread.start()
        with _live_servers_lock:
            _live_servers.append(self)
        log.info("metrics exposition on http://%s:%d/metrics", host, self.port)

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()  # the listener fd is released here, synchronously
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        with _live_servers_lock:
            if self in _live_servers:
                _live_servers.remove(self)


# ---------------------------------------------------------------------------
# Snapshot view
# ---------------------------------------------------------------------------
class TelemetrySnapshot:
    """Immutable sample list with lookup helpers."""

    def __init__(self, samples: List[Sample]):
        self.samples = list(samples)

    def get(self, name: str, default: float = None, **labels):
        want = set(labels.items())
        for s in self.samples:
            if s.name == name and want <= set(s.labels.items()):
                return s.value
        return default

    def sum(self, name: str, **labels) -> float:
        want = set(labels.items())
        return sum(s.value for s in self.samples
                   if s.name == name and want <= set(s.labels.items()))

    def names(self) -> set:
        return {s.name for s in self.samples}

    def counters(self) -> Dict[Tuple[str, Tuple], float]:
        """{(name, labelset): value} for counter-kind samples only."""
        return {(s.name, _label_key(s.labels)): s.value
                for s in self.samples if s.kind == "counter"}

    def flat(self) -> Dict[str, float]:
        """{name: value}: counters summed across labelsets, gauges maxed;
        histogram ``_bucket`` series elided."""
        out: Dict[str, float] = {}
        for s in self.samples:
            if s.name.endswith("_bucket"):
                continue
            if s.kind == "counter":
                out[s.name] = out.get(s.name, 0.0) + float(s.value)
            else:
                out[s.name] = max(out.get(s.name, float("-inf")), float(s.value))
        return {k: (round(v, 6) if isinstance(v, float) else v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Per-stream SLO accounting
# ---------------------------------------------------------------------------
#: numeric status codes exported as ``nns.slo.status``
SLO_STATUS_CODES = {"met": 0, "warn": 1, "burned": 2}
#: burn-rate band edges: burn <= 1.0 is inside budget ("met"); at or above
#: SLO_BURN_BURNED the budget is being consumed at 2x+ ("burned")
SLO_BURN_BURNED = 2.0


def slo_status(burn: Optional[float]) -> str:
    """The met/warn/burned truth table for one burn rate (None = no armed
    objective = trivially met)."""
    if burn is None or burn <= 1.0:
        return "met"
    if burn < SLO_BURN_BURNED:
        return "warn"
    return "burned"


class _SloRow:
    """One tenant's SLO instruments (single writer: the generator's pump)."""

    __slots__ = ("ttft", "token", "good", "shed", "evicted", "expired", "errors")

    def __init__(self):
        self.ttft = Log2Histogram()
        self.token = Log2Histogram()
        self.good = 0
        self.shed = 0
        self.evicted = 0
        self.expired = 0
        self.errors = 0


class SloTracker:
    """Declarative per-tenant SLO objectives and the instruments their
    error-budget burn rates are computed from.

    Hot-path cost: one Log2Histogram record per first token (TTFT), one
    ``record_n`` per decode call (per-token inter-arrival), one integer
    increment per stream outcome.  Burn rates, percentiles and the
    met/warn/burned status are computed at snapshot (scrape) time.

    Objectives (0 / None = not armed): ``ttft_p95_s`` (burn = observed-over
    fraction / 0.05), ``token_p99_s`` (burn = observed-over fraction /
    0.01) and ``availability`` (bad = shed + evicted + expired + errors;
    burn = bad fraction / allowed bad fraction).  Violation counts use
    :meth:`Log2Histogram.count_over`: bucket-grain and deterministic."""

    def __init__(self, ttft_p95_s: float = 0.0, token_p99_s: float = 0.0,
                 availability: float = 0.0):
        self.ttft_p95_s = max(0.0, float(ttft_p95_s or 0.0))
        self.token_p99_s = max(0.0, float(token_p99_s or 0.0))
        self.availability = float(availability or 0.0)
        if not 0.0 <= self.availability < 1.0:
            raise ValueError(
                f"availability objective {availability!r} must be in "
                "[0, 1) (1.0 leaves a zero error budget — nothing can "
                "meet it)")
        self._rows: Dict[str, _SloRow] = {}
        self._lock = threading.Lock()

    @property
    def armed(self) -> bool:
        return bool(self.ttft_p95_s or self.token_p99_s or self.availability)

    def _row(self, tenant: str) -> _SloRow:
        row = self._rows.get(tenant)
        if row is None:
            with self._lock:
                row = self._rows.setdefault(tenant, _SloRow())
        return row

    # -- record paths (cheap; single writer per element) --------------------
    def note_ttft(self, tenant: str, seconds: float) -> None:
        self._row(tenant).ttft.record(seconds)

    def note_tokens(self, tenant: str, elapsed_s: float, n: int) -> None:
        """``n`` tokens arrived ``elapsed_s`` after the previous ones: n
        inter-arrival observations of elapsed/n each."""
        if n > 0:
            self._row(tenant).token.record_n(elapsed_s / n, n)

    def note_stream(self, tenant: str, outcome: str) -> None:
        """Terminal classification of one stream: ``good`` | ``shed`` |
        ``evicted`` | ``expired`` | ``error``."""
        row = self._row(tenant)
        if outcome == "good":
            row.good += 1
        elif outcome == "shed":
            row.shed += 1
        elif outcome == "evicted":
            row.evicted += 1
        elif outcome == "expired":
            row.expired += 1
        else:
            row.errors += 1

    # -- scrape-time views --------------------------------------------------
    @staticmethod
    def _latency_burn(hist: Log2Histogram, objective_s: float,
                      allowed_frac: float) -> Optional[float]:
        if objective_s <= 0.0 or hist.count == 0:
            return None
        frac_over = hist.count_over(objective_s) / hist.count
        return frac_over / allowed_frac

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """{tenant: row} for ``health_info()``: numeric gauges and counters
        only (the collector's ``slo`` branch maps them onto ``nns.slo.*``
        samples with a tenant label)."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            rows = dict(self._rows)
        for tenant, row in rows.items():
            classified = row.good + row.shed + row.evicted + row.expired + row.errors
            entry: Dict[str, Any] = {
                "good": row.good, "shed": row.shed, "evicted": row.evicted,
                "expired": row.expired, "errors": row.errors,
            }
            burns = []
            ttft_burn = self._latency_burn(row.ttft, self.ttft_p95_s, 0.05)
            if row.ttft.count:
                p95 = row.ttft.quantile(0.95)
                if p95 is not None:
                    entry["ttft_p95_ms"] = round(p95 * 1e3, 3)
            if ttft_burn is not None:
                entry["ttft_burn"] = round(ttft_burn, 3)
                burns.append(ttft_burn)
            token_burn = self._latency_burn(row.token, self.token_p99_s, 0.01)
            if row.token.count:
                p99 = row.token.quantile(0.99)
                if p99 is not None:
                    entry["token_p99_ms"] = round(p99 * 1e3, 3)
            if token_burn is not None:
                entry["token_burn"] = round(token_burn, 3)
                burns.append(token_burn)
            if classified:
                avail = row.good / classified
                entry["availability"] = round(avail, 6)
                if self.availability > 0.0:
                    avail_burn = (1.0 - avail) / (1.0 - self.availability)
                    entry["availability_burn"] = round(avail_burn, 3)
                    burns.append(avail_burn)
            worst = max(burns) if burns else None
            entry["status"] = SLO_STATUS_CODES[slo_status(worst)]
            out[tenant] = entry
        return out

    def hist_rows(self) -> List[Tuple[str, Log2Histogram, Dict[str, str]]]:
        """(metric name, histogram, extra labels) triples for the element's
        ``histograms_info`` hook: bucket series with a ``tenant`` label."""
        with self._lock:
            rows = dict(self._rows)
        out = []
        for tenant, row in rows.items():
            labels = {"tenant": tenant or "_"}
            out.append(("nns.slo.ttft_seconds", row.ttft, labels))
            out.append(("nns.slo.token_seconds", row.token, labels))
        return out


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------
class FlightRecorder:
    """Bounded ring of recent per-frame span events plus incident dumps.

    Fed by :class:`~.tracer.PipelineTracer` (the recorder rides the
    tracer's one-branch-per-frame hook): ``begin`` marks a frame entering
    an element (an open span identifies a frame STUCK inside a hung
    element), ``end`` appends the completed span to the ring.  ``dump``
    writes the per-trace timelines to the log and a JSON file,
    rate-limited.  With ``profile_incidents`` (default on) each dump also
    samples the named framework threads (:func:`~.profiler.profile_threads`)
    for ``profile_duration_s`` and attaches their collapsed top stacks.

    A dump never touches the card: the detail is ``repr``'d (a CUDA error
    or a tensor's repr names it without copying it anywhere) and spans hold
    host clocks only."""

    def __init__(self, capacity: int = 4096, dump_dir: Optional[str] = None,
                 min_dump_interval_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 profile_incidents: bool = True,
                 profile_duration_s: float = 0.2,
                 profile_hz: float = 50.0):
        self._ring: deque = deque(maxlen=max(16, capacity))
        self._open: Dict[str, Tuple[Any, float]] = {}
        self._dump_dir = dump_dir
        self._min_interval = float(min_dump_interval_s)
        self._clock = clock
        self._last_dump_ts = float("-inf")
        self._dump_lock = threading.Lock()
        self._profile = bool(profile_incidents)
        self._profile_duration_s = float(profile_duration_s)
        self._profile_hz = float(profile_hz)
        self.dumps = 0
        self.suppressed = 0

    # -- hot path (enabled only; worker threads) ----------------------------
    def begin(self, element: str, frame) -> None:
        meta = getattr(frame, "meta", None)
        tid = meta.get(TRACE_ID_META) if meta is not None else None
        self._open[element] = (tid, time.perf_counter())

    def end(self, element: str, frame, t_in: float, t_out: float, nframes: int) -> None:
        meta = getattr(frame, "meta", None)
        tid = meta.get(TRACE_ID_META) if meta is not None else None
        self._open.pop(element, None)
        # deque append is GIL-atomic; a full ring evicts the oldest
        self._ring.append((tid, element, t_in, t_out, nframes))

    # -- assembly -----------------------------------------------------------
    @staticmethod
    def _snap(dq: deque) -> list:
        for _ in range(4):  # concurrent appends can break list(deque)
            try:
                return list(dq)
            except RuntimeError:
                continue
        return []

    def timelines(self) -> Dict[Any, List[Dict[str, Any]]]:
        """Per-trace span lists, oldest span first; open spans (entered,
        never left: the stalled frame) are flagged ``open: true``."""
        out: Dict[Any, List[Dict[str, Any]]] = {}
        for tid, element, t_in, t_out, nframes in self._snap(self._ring):
            out.setdefault(tid, []).append({
                "element": element, "t_in": t_in, "t_out": t_out,
                "dur_ms": round((t_out - t_in) * 1e3, 3), "frames": nframes,
            })
        for element, (tid, t_in) in list(self._open.items()):
            out.setdefault(tid, []).append({
                "element": element, "t_in": t_in, "open": True,
                "stuck_for_ms": round((time.perf_counter() - t_in) * 1e3, 3),
            })
        return out

    def dump(self, reason: str, source: str, detail: Any = None,
             logger=None) -> Optional[str]:
        """Write the current timelines to a JSON file (and a log summary).
        Rate-limited; returns the file path, or None when suppressed or the
        file could not be written."""
        with self._dump_lock:
            now = self._clock()
            if now - self._last_dump_ts < self._min_interval:
                self.suppressed += 1
                return None
            self._last_dump_ts = now
        # the thread profile FIRST: a stalled thread is still parked on its
        # hang site right now
        profile = None
        if self._profile:
            try:
                from .profiler import profile_threads

                profile = profile_threads(duration_s=self._profile_duration_s,
                                          hz=self._profile_hz)
                REGISTRY.counter("nns.profiler.captures").inc()
            except Exception:  # profiling must never break the dump
                (logger or log).exception("incident thread profile failed")
        timelines = self.timelines()
        payload = {
            "reason": reason,
            "source": source,
            "detail": repr(detail) if detail is not None else None,
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "thread_profile": profile,
            "traces": [{"trace_id": tid, "spans": spans} for tid, spans in timelines.items()],
        }
        import tempfile

        dump_dir = self._dump_dir or os.environ.get("NNS_FLIGHT_DIR") or tempfile.gettempdir()
        path = os.path.join(
            dump_dir, f"nns_flight_{source}_{reason}_{int(time.time() * 1000)}.json")
        lg = logger or log
        try:
            os.makedirs(dump_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, indent=1)
        except OSError as e:
            lg.warning("flight-recorder dump failed: %s", e)
            return None
        self.dumps += 1
        REGISTRY.counter("nns.flight.dumps").inc()
        open_spans = [s for spans in timelines.values() for s in spans if s.get("open")]
        lg.warning(
            "flight recorder: %s at %s -> %s (%d trace(s), %d open span(s)%s)",
            reason, source, path, len(timelines), len(open_spans),
            "".join(f"; STUCK {s['element']} {s['stuck_for_ms']:.0f}ms"
                    for s in open_spans[:3]))
        return path


# ---------------------------------------------------------------------------
# Pipeline collector (scrape-time; called via REGISTRY collectors)
# ---------------------------------------------------------------------------
def _num(v) -> Optional[float]:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    return None


def collect_pipeline(pipe) -> List[Sample]:
    """Every signal source of one pipeline as labeled samples: element
    ``health_info()`` counters, the tracer's per-element statistics and
    log2 histograms, each element's ``metrics_info``/``histograms_info``
    rows, and the process's staging-buffer pools.  Runs only at scrape or
    snapshot time; reads host counters only."""
    base = {"pipeline": pipe.telemetry_label}
    out: List[Sample] = []
    out.append(Sample("nns.pipeline.delivered", dict(base), pipe.delivered_frames(), "counter"))
    out.append(Sample("nns.pipeline.errors", dict(base), len(pipe.errors), "gauge"))
    # -- health() -----------------------------------------------------------
    for el_name, entry in pipe.health().items():
        labels = {**base, "element": el_name}
        for key, val in entry.items():
            if key == "state":
                out.append(Sample("nns.lifecycle.state", dict(labels),
                                  STATE_CODES.get(val, -1), "gauge"))
                continue
            if key == "lifecycle":
                out.append(Sample("nns.lifecycle.server_state", dict(labels),
                                  SERVER_STATE_CODES.get(val, -1), "gauge"))
                continue
            if key == "swap_state":
                out.append(Sample("nns.lifecycle.swap_state", dict(labels),
                                  SWAP_STATE_CODES.get(val, -1), "gauge"))
                continue
            if key == "breakers" and isinstance(val, dict):
                for remote, snap in val.items():
                    rl = {**labels, "remote": remote}
                    out.append(Sample("nns.query.breaker_open", dict(rl),
                                      1.0 if snap.get("state") == "open" else 0.0, "gauge"))
                    out.append(Sample("nns.query.breaker_trips", dict(rl),
                                      snap.get("trips", 0), "counter"))
                    out.append(Sample("nns.query.breaker_failures", dict(rl),
                                      snap.get("recent_failures", 0), "gauge"))
                continue
            if key == "tenants" and isinstance(val, dict):
                for tenant, row in val.items():
                    tl = {**labels, "tenant": tenant or "_"}
                    for field_, mname, kind in (
                            ("inflight", "nns.query.tenant_inflight", "gauge"),
                            ("admitted", "nns.query.tenant_admitted", "counter"),
                            ("shed", "nns.query.tenant_shed", "counter"),
                            ("quota", "nns.query.tenant_quota", "gauge")):
                        out.append(Sample(mname, dict(tl), row.get(field_, 0), kind))
                continue
            if key == "remote_inflight" and isinstance(val, dict):
                for remote, v in val.items():
                    out.append(Sample("nns.query.remote_inflight",
                                      {**labels, "remote": remote}, v, "gauge"))
                continue
            if key == "remotes" and isinstance(val, dict):
                # per-remote span EWMAs: each numeric field onto its
                # catalogued nns.query.remote_* name
                for remote, agg in val.items():
                    rl = {**labels, "remote": remote}
                    for akey, aval in agg.items():
                        n = _num(aval)
                        mname = f"nns.query.remote_{akey}"
                        if n is not None and mname in METRICS:
                            out.append(Sample(mname, dict(rl), n, metric_kind(mname)))
                continue
            if key == "slo" and isinstance(val, dict):
                # per-tenant SLO rows: every numeric field maps onto its
                # catalogued nns.slo.* name
                for tenant, srow in val.items():
                    tl = {**labels, "tenant": tenant or "_"}
                    for skey, sval in srow.items():
                        n = _num(sval)
                        if n is None:
                            continue
                        mname = f"nns.slo.{skey}"
                        if mname in METRICS:
                            out.append(Sample(mname, dict(tl), n, metric_kind(mname)))
                continue
            if key in HEALTH_KEYS_SPECIAL:
                continue
            n = _num(val)
            if n is None:
                continue
            mname = HEALTH_KEY_METRICS.get(key, f"nns.health.{key}")
            out.append(Sample(mname, dict(labels), n, metric_kind(mname)))
    # -- tracer per-element stats ------------------------------------------
    tracer = pipe.tracer
    if tracer is not None:
        for el_name, r in tracer.report().items():
            labels = {**base, "element": el_name}
            pairs = (
                ("nns.element.frames", r["frames"]),
                ("nns.element.calls", r["calls"]),
                ("nns.element.proctime_us", r["proctime_us_avg"]),
                ("nns.element.proctime_p99_us", r["proctime_us_p99"]),
                ("nns.element.fps", r["framerate_fps"]),
                ("nns.element.interlatency_ms", r["interlatency_ms_avg"]),
                ("nns.element.queue_depth", r["queuelevel_avg"]),
                ("nns.element.queue_capacity", r["queue_capacity"]),
                ("nns.element.bitrate_mbps", r["bitrate_mbps"]),
            )
            for mname, v in pairs:
                if v is None:
                    continue
                out.append(Sample(mname, dict(labels), float(v), metric_kind(mname)))
        for el_name, mname, h in tracer.latency_histograms():
            out.extend(hist_samples(mname, h, {**base, "element": el_name}))
    # -- element-specific rows (the filter's window and lane, SLO hists) ---
    for el_name, el in pipe.elements.items():
        labels = {**base, "element": el_name}
        hinfo = getattr(el, "histograms_info", None)
        if hinfo is not None:
            try:
                for hrow in hinfo() or ():
                    # (name, hist) or (name, hist, extra_labels)
                    mname, h = hrow[0], hrow[1]
                    lb = dict(labels)
                    if len(hrow) > 2 and hrow[2]:
                        lb.update(hrow[2])
                    out.extend(hist_samples(mname, h, lb))
            except Exception:  # a scrape must survive element bugs
                log.exception("histograms_info failed for %s", el_name)
        info = getattr(el, "metrics_info", None)
        if info is None:
            continue
        try:
            rows = info() or ()
        except Exception:  # a scrape must survive element bugs
            log.exception("metrics_info failed for %s", el_name)
            continue
        for row in rows:
            if len(row) == 2:
                mname, v = row
                extra = None
            else:
                mname, v, extra = row
            n = _num(v)
            if n is None:
                continue
            lb = dict(labels)
            if extra:
                lb.update(extra)
            out.append(Sample(mname, lb, n, metric_kind(mname)))
    # -- process-wide staging pools (labeled by pipeline for context) -------
    from .buffer import staging_pool_totals

    pools = staging_pool_totals()
    for key, mname, kind in (("allocated", "nns.pool.device_allocated", "counter"),
                             ("reused", "nns.pool.device_reused", "counter"),
                             ("reuse_rate", "nns.pool.device_reuse_rate", "gauge"),
                             ("rings_evicted", "nns.pool.rings_evicted", "counter"),
                             ("trims", "nns.pool.trims", "counter")):
        out.append(Sample(mname, dict(base), pools[key], kind))
    return out
