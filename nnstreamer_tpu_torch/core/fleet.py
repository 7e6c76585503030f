"""Fleet observatory: telemetry digests on the discovery plane and fleet
rollups.

Port of ``nnstreamer_tpu/core/fleet.py``, in three pieces:

* :class:`DigestPublisher`: builds, on a clock it is given, a compact,
  versioned and bounded JSON digest of one server's live state (seq and
  monotonic age, a tokens/s EWMA, slot occupancy, memory headroom,
  per-tenant admitted and shed, inflight, draining, degraded and swap
  state).  The serversrc polls it on the watchdog sweeper's cadence and
  publishes each digest through the retained announce's ``update()``
  (``distributed/hybrid.py``): no new connection, no per-frame cost.
  Digests carry host numbers only (``health()`` rows, the memory
  monitor's snapshot), never a card tensor;
* :class:`FleetObservatory`: subscribes to the announce topics, keeps a
  bounded table of servers that retires a row when its digest outlives its
  own ``ttl_s`` or its announce is deleted, and rolls the fleet up.
  Counter rollups include retired servers, so fleet totals equal the sum
  of every server's own ledger exactly;
* :func:`hint_from_announce`: the one place where an announce becomes a
  routing hint (``draining``, ``degraded``), read by the query client's
  discovery; the digest's fields win over the announce's top-level keys.

A digest names its ``seq``, its publisher's monotonic ``age_s`` and its
``ttl_s``, so a consumer always tells a live number from a stale one.  The
digests are the JAX package's, key for key: either package's observatory
reads the other's servers.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .log import get_logger
from .telemetry import METRICS, REGISTRY, Sample, metric_kind

log = get_logger("fleet")

#: digest schema version (consumers skip digests they do not speak)
DIGEST_VERSION = 1
#: announce key the digest rides under (``info["digest"]``)
DIGEST_KEY = "digest"
#: serialized-size bound on one digest (the announce must stay a small
#: control-plane message; over-budget digests drop their per-tenant maps
#: loudly via ``truncated`` instead of growing without bound)
DIGEST_MAX_BYTES = 4096
#: per-tenant rows kept in one digest (busiest tenants win; the drop is
#: visible via ``tenants_dropped`` so truncation is never silent)
DIGEST_MAX_TENANTS = 16
#: default digest TTL = this many publish intervals without a fresh
#: digest before the observatory retires the row
DIGEST_TTL_INTERVALS = 3.0
#: fraction of a row's TTL after which it is STALE: still listed (the
#: server may be merely slow), but a wedged-but-announcing server must
#: never count as capacity, so stale rows are excluded from the rollup's
#: headroom/throughput gauges and from controller math
DIGEST_STALE_FRACTION = 0.5
#: retired-contribution snapshots kept for possible resurrection
#: (a topic is one process instance — pid+uuid — so a very old
#: snapshot can never match a new server; bound the ledger)
RETIRED_ROWS_MAX = 1024
#: smoothing for the tokens/s EWMA carried in the digest
_RATE_EWMA = 0.3

#: bound on live per-server rows in one observatory (beyond it the
#: oldest row is retired — table growth is an operator error, not OOM)
OBSERVATORY_MAX_SERVERS = 512


def hint_from_announce(info: dict) -> Dict[str, bool]:
    """The ONE capture path for per-endpoint routing hints from a
    retained announce: prefer the digest's ``draining``/``degraded``
    fields (they are refreshed on the digest cadence, not only at state
    changes), fall back to the legacy top-level announce keys so mixed
    fleets (pre-digest servers) keep propagating health."""
    d = info.get(DIGEST_KEY)
    if isinstance(d, dict) and "draining" in d:
        return {
            "draining": bool(d.get("draining", False)),
            "degraded": bool(d.get("degraded", False)),
        }
    return {
        "draining": bool(info.get("draining", False)),
        "degraded": bool(info.get("degraded", False)),
    }


def pipeline_digest_stats(pipe) -> Dict[str, Any]:
    """Scan one pipeline's ``health()`` rows for the digest's
    cross-element signals: slot-engine counters (summed over
    generators), the most interesting hot-swap state, per-tenant SLO
    burn (worst per tenant across elements), and the memory-watermark
    headroom.  The serversrc's digest source; the numbers are host
    counters, read without touching the card."""
    stats: Dict[str, Any] = {}
    gen_keys = ("gen_tokens", "gen_slots", "gen_occupied", "gen_waiting")
    sums = dict.fromkeys(gen_keys, 0)
    have_gen = False
    swap = "idle"
    slo_burn: Dict[str, float] = {}
    ttft_p95 = 0.0
    try:
        health = pipe.health()
    except Exception:  # a digest must never die on a health bug
        log.exception("digest health scan failed")
        return stats
    for row in health.values():
        if "gen_slots" in row:
            have_gen = True
            for k in gen_keys:
                sums[k] += int(row.get(k, 0) or 0)
        s = row.get("swap_state")
        if s and s != "idle":
            swap = s
        slo = row.get("slo")
        if isinstance(slo, dict):
            for tenant, srow in slo.items():
                burns = [
                    v for k, v in srow.items()
                    if k.endswith("_burn") and isinstance(v, (int, float))
                ]
                if burns:
                    slo_burn[tenant] = max(
                        slo_burn.get(tenant, 0.0), max(burns))
                t95 = srow.get("ttft_p95_ms")
                if isinstance(t95, (int, float)):
                    ttft_p95 = max(ttft_p95, float(t95))
    if have_gen:
        stats["tokens"] = sums["gen_tokens"]
        stats["slots"] = sums["gen_slots"]
        stats["occupied"] = sums["gen_occupied"]
        stats["waiting"] = sums["gen_waiting"]
    stats["swap"] = swap
    if ttft_p95 > 0:
        # worst observed p95 TTFT across tenants — the predictive
        # autoscaler's latency observable (core/autoscale.py PerfModel)
        stats["ttft_p95_ms"] = round(ttft_p95, 3)
    if slo_burn:
        stats["slo_burn"] = {
            t: round(float(b), 3) for t, b in slo_burn.items()}
    # shared-prefix cache advert: per-server hit/miss counters plus a
    # bounded MRU list of hot prefix digests, so peers (and the
    # observatory rollup) can see WHERE a shared prefix is already warm.
    # Duck-typed off the elements — only armed slotted generators grow a
    # prefix_digest_info(); everything else is silently skipped.
    pfx = {"hits": 0, "misses": 0, "entries": 0}
    pfx_hot: List[str] = []
    have_pfx = False
    for el in getattr(pipe, "elements", {}).values():
        info_fn = getattr(el, "prefix_digest_info", None)
        if info_fn is None:
            continue
        try:
            info = info_fn()
        except Exception:
            log.exception("prefix digest scan failed for %s",
                          getattr(el, "name", el))
            continue
        if not isinstance(info, dict):
            continue
        have_pfx = True
        for k in ("hits", "misses", "entries"):
            pfx[k] += int(info.get(k, 0) or 0)
        for d in info.get("hot", ()):
            if d not in pfx_hot:
                pfx_hot.append(d)
    if have_pfx:
        pfx["hot"] = pfx_hot[:8]
        stats["prefix"] = pfx
    mon = getattr(pipe, "memory_monitor", None)
    if mon is not None:
        snap = mon.snapshot()
        limit = int(snap.get("mem_bytes_limit", 0) or 0)
        in_use = int(snap.get("mem_bytes_in_use", 0) or 0)
        if limit > 0:
            headroom = max(0, int(limit * mon.high) - in_use)
        else:
            headroom = 0
        stats["mem_headroom_bytes"] = headroom
        stats["mem_pressure"] = int(snap.get("mem_pressure", 0) or 0)
    return stats


class DigestPublisher:
    """Periodic builder/publisher of one server's telemetry digest.

    ``source()`` returns the raw stats dict (the serversrc merges its
    admission ledger with :func:`pipeline_digest_stats`); ``publish(d)``
    ships the built digest (the serversrc routes it through the retained
    announce's ``update()``).  :meth:`poll` is rate-limited by
    ``interval_s`` on the injected ``clock`` — drive it from any slow
    cadence (the watchdog sweeper) or directly in tests with a fake
    clock; ``poll(force=True)`` publishes NOW (drain entry, final
    pre-stop flush) so state changes never wait out the interval.

    Every digest carries its own staleness contract: a monotonically
    increasing ``seq``, the publisher's monotonic ``age_s`` (resets on
    restart — a consumer can tell a reborn server from a stale row), and
    ``ttl_s`` after which consumers must treat the row as dead."""

    def __init__(self, source: Callable[[], Dict[str, Any]],
                 publish: Callable[[Dict[str, Any]], None],
                 interval_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "digest"):
        self.source = source
        self.publish = publish
        self.interval_s = max(0.05, float(interval_s))
        self.ttl_s = self.interval_s * DIGEST_TTL_INTERVALS
        self.clock = clock
        self.name = name
        self.seq = 0
        self.published = 0
        self.publish_failures = 0
        self.last_digest: Optional[Dict[str, Any]] = None
        self._t0 = clock()
        self._last_pub = float("-inf")
        # tokens/s EWMA state (successive gen_tokens deltas)
        self._last_tokens: Optional[int] = None
        self._last_tokens_ts: Optional[float] = None
        self._rate: Optional[float] = None
        self._lock = threading.Lock()

    def _tokens_rate(self, tokens: Optional[int], now: float) -> float:
        """Fold the cumulative token counter into a tokens/s EWMA —
        cheap, and unlike a raw counter it reads as LIVE throughput."""
        if tokens is None:
            return 0.0
        if self._last_tokens is not None and self._last_tokens_ts is not None:
            dt = now - self._last_tokens_ts
            if dt > 0:
                rate = max(0.0, tokens - self._last_tokens) / dt
                self._rate = (rate if self._rate is None
                              else self._rate + _RATE_EWMA
                              * (rate - self._rate))
        self._last_tokens = tokens
        self._last_tokens_ts = now
        return round(self._rate or 0.0, 3)

    def _bounded_tenants(self, tenants: Dict[str, Dict[str, Any]]
                         ) -> Tuple[Dict[str, Dict[str, int]], int]:
        rows = {
            str(t): {"admitted": int(r.get("admitted", 0)),
                     "shed": int(r.get("shed", 0))}
            for t, r in tenants.items()
        }
        if len(rows) <= DIGEST_MAX_TENANTS:
            return rows, 0
        busiest = sorted(
            rows, key=lambda t: (rows[t]["admitted"] + rows[t]["shed"]),
            reverse=True)[:DIGEST_MAX_TENANTS]
        return {t: rows[t] for t in busiest}, len(rows) - DIGEST_MAX_TENANTS

    def build(self) -> Dict[str, Any]:
        """One digest from the current ``source()`` stats (no publish,
        no rate limit — :meth:`poll` wraps this)."""
        now = self.clock()
        stats = dict(self.source() or {})
        self.seq += 1
        digest: Dict[str, Any] = {
            "v": DIGEST_VERSION,
            "seq": self.seq,
            "age_s": round(now - self._t0, 3),
            "interval_s": self.interval_s,
            "ttl_s": round(self.ttl_s, 3),
            "draining": bool(stats.get("draining", False)),
            "degraded": bool(stats.get("degraded", False)),
            "swap": str(stats.get("swap", "idle")),
            "inflight": int(stats.get("inflight", 0)),
            "admitted": int(stats.get("admitted", 0)),
            "shed": int(stats.get("shed", 0)),
            "tokens_per_s": self._tokens_rate(stats.get("tokens"), now),
        }
        for k in ("tokens", "slots", "occupied", "waiting",
                  "mem_headroom_bytes", "mem_pressure"):
            if k in stats:
                digest[k] = int(stats[k])
        if "ttft_p95_ms" in stats:
            digest["ttft_p95_ms"] = round(float(stats["ttft_p95_ms"]), 3)
        tenants, dropped = self._bounded_tenants(stats.get("tenants") or {})
        if tenants:
            digest["tenants"] = tenants
        if dropped:
            digest["tenants_dropped"] = dropped
        slo_burn = stats.get("slo_burn")
        if slo_burn:
            digest["slo_burn"] = dict(slo_burn)
        # shared-prefix cache advert (armed slotted generators only):
        # exact hit/miss counters for the fleet rollup plus the bounded
        # hot-digest list peers use to find warm prefixes
        pfx = stats.get("prefix")
        if isinstance(pfx, dict):
            digest["prefix"] = {
                "hits": int(pfx.get("hits", 0) or 0),
                "misses": int(pfx.get("misses", 0) or 0),
                "entries": int(pfx.get("entries", 0) or 0),
                "hot": [str(d) for d in pfx.get("hot", ())][:8],
            }
        # size bound: the announce is a control-plane message — an
        # oversized digest drops its per-tenant maps LOUDLY rather than
        # growing without bound (rollups then under-report those maps,
        # which `truncated` makes visible fleet-wide)
        if len(json.dumps(digest)) > DIGEST_MAX_BYTES:
            digest.pop("tenants", None)
            digest.pop("slo_burn", None)
            digest.pop("prefix", None)
            digest["truncated"] = True
        return digest

    def poll(self, force: bool = False) -> Optional[Dict[str, Any]]:
        """Publish a fresh digest when the interval elapsed (or
        ``force``).  Returns the digest published, None when skipped.
        The WHOLE build+publish runs under one lock: the sweeper thread
        and a force-publish (drain entry) may race, and the retained
        announce must end up holding the HIGHEST seq — an unlocked
        publish could let an older digest land last and sit retained
        until the next interval (publish itself is a non-blocking
        enqueue, so holding the lock across it is cheap)."""
        with self._lock:
            now = self.clock()
            if not force and now - self._last_pub < self.interval_s:
                return None
            digest = self.build()
            self._last_pub = now
            try:
                self.publish(digest)
            except Exception as e:  # noqa: BLE001 — broker I/O best-effort
                self.publish_failures += 1
                log.warning("%s: digest publish failed: %s", self.name, e)
                return None
            self.last_digest = digest
            self.published += 1
            return digest


# ---------------------------------------------------------------------------
# Observatory
# ---------------------------------------------------------------------------
class _ServerRow:
    """One live server's latest digest + receipt bookkeeping."""

    __slots__ = ("topic", "host", "port", "digest", "received_ts", "digests")

    def __init__(self, topic: str, host: str, port: int):
        self.topic = topic
        self.host = host
        self.port = port
        self.digest: Dict[str, Any] = {}
        self.received_ts = 0.0
        self.digests = 0  # digests ingested for this row

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"


class FleetObservatory:
    """Fleet-wide view over the discovery plane's telemetry digests.

    Subscribe with :meth:`start` (an MQTT wildcard subscription over the
    announce topics) or feed announces directly through :meth:`ingest`
    (tests, bench).  Rows age out on each digest's own ``ttl_s``
    (checked lazily at read time — the observatory needs no thread of
    its own); tombstoned or TTL-evicted rows move their counters into a
    retired accumulator so :meth:`rollup` totals remain exactly the sum
    of every per-server ledger that ever served.

    Export rides the one registry path: :meth:`start` registers a single
    scrape-time collector emitting ``nns.fleet.*`` samples (labels
    ``fleet=<topic>``), :meth:`serve_metrics` opens the same Prometheus
    endpoint pipelines use, and :meth:`snapshot` is the pollable view
    a dashboard and the autoscaling controller (``core/autoscale.py``)
    consume."""

    def __init__(self, topic: str = "", default_ttl_s: float = 10.0,
                 max_servers: int = OBSERVATORY_MAX_SERVERS,
                 clock: Callable[[], float] = time.monotonic,
                 stale_fraction: float = DIGEST_STALE_FRACTION,
                 retired_cap: int = RETIRED_ROWS_MAX):
        self.topic = topic
        self.default_ttl_s = float(default_ttl_s)
        self.max_servers = int(max_servers)
        self.stale_fraction = float(stale_fraction)
        self.retired_cap = max(1, int(retired_cap))
        self.clock = clock
        self._lock = threading.Lock()
        self._rows: Dict[str, _ServerRow] = {}   # topic -> row
        self._client = None
        self._server = None  # MetricsServer (serve_metrics)
        self._collector_registered = False
        # exactness across churn: retired counters accumulate at
        # tombstone/TTL-eviction time.  Per-topic contribution snapshots
        # (bounded LRU) let a RESURRECTED instance — a row TTL-evicted
        # while its server was merely slow/partitioned, then re-ingested
        # from the SAME instance topic — reverse its retired
        # contribution, or its cumulative counters would double-count
        # in the rollup forever
        self._retired_tokens = 0
        self._retired_admitted = 0
        self._retired_shed = 0
        self._retired_prefix_hits = 0
        self._retired_prefix_misses = 0
        self._retired_tenants: Dict[str, Dict[str, int]] = {}
        from collections import OrderedDict

        self._retired_rows: "OrderedDict[str, Dict[str, Any]]" = (
            OrderedDict())
        self.retired = 0         # rows retired (tombstone)
        self.stale_evicted = 0   # rows retired (TTL / table bound)
        self.retired_evicted = 0  # retired snapshots dropped by the cap
        self.resurrected = 0     # retired rows that came back alive
        self.digests = 0         # digests ingested, lifetime
        self.servers_seen = 0    # distinct announce instances ever seen
        # control-plane health: WHEN telemetry last arrived and WHETHER
        # the broker link is up — rows aging into the stale tier is a
        # symptom; this is the cause, surfaced explicitly
        self._plane_born_ts = self.clock()
        self._last_ingest_ts: Optional[float] = None

    # -- control-plane health ------------------------------------------------
    @property
    def plane_connected(self) -> bool:
        """True while the broker connection is up.  Direct-feed mode
        (tests/bench calling :meth:`ingest` with no broker) reads
        connected: there is no link to lose."""
        client = self._client
        return client is None or client.connected.is_set()

    @property
    def plane_reconnects(self) -> int:
        client = self._client
        return getattr(client, "reconnects", 0) if client is not None else 0

    def plane_ingest_age_s(self, now: Optional[float] = None) -> float:
        """Seconds since ANY discovery-plane traffic was ingested
        (dup-seq redeliveries and tombstones count — they prove the
        plane is moving); age since construction when nothing arrived
        yet."""
        now = self.clock() if now is None else now
        last = self._last_ingest_ts
        return max(0.0, now - (self._plane_born_ts if last is None
                               else last))

    # -- wiring -------------------------------------------------------------
    def start(self, broker_host: str, broker_port: int,
              brokers: Optional[List[Tuple[str, int]]] = None,
              ) -> "FleetObservatory":
        """Subscribe to ``nns/query/<topic>/#`` on the broker and
        register the ``nns.fleet.*`` registry collector.  ``brokers``
        is the ordered failover list handed to the MQTT client."""
        from ..distributed.mqtt import MqttClient

        self._client = MqttClient(broker_host, broker_port,
                                  brokers=brokers)
        # empty topic = EVERY announce topic: MQTT matches level by
        # level, so the pattern must be nns/query/# (nns/query//# would
        # only match servers whose topic= is literally empty)
        pattern = (f"nns/query/{self.topic}/#" if self.topic
                   else "nns/query/#")
        self._client.subscribe(pattern, self._on_msg, qos=0)
        if not self._collector_registered:
            REGISTRY.register_collector(self._collect)
            self._collector_registered = True
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None
        if self._collector_registered:
            REGISTRY.unregister_collector(self._collect)
            self._collector_registered = False
        client, self._client = self._client, None
        if client is not None:
            client.close()

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Prometheus exposition over the shared registry (the fleet
        collector registered by :meth:`start` rides it).  Returns the
        bound port."""
        from .telemetry import MetricsServer

        if not self._collector_registered:
            REGISTRY.register_collector(self._collect)
            self._collector_registered = True
        if self._server is None:
            self._server = MetricsServer(
                port=port, host=host, name=f"fleet-{self.topic or 'all'}")
        return self._server.port

    def _on_msg(self, topic: str, payload: bytes) -> None:
        if not payload:
            self.note_tombstone(topic)
            return
        try:
            info = json.loads(payload.decode())
        except ValueError:
            log.warning("undecodable announce on %s", topic)
            return
        self.ingest(topic, info)

    # -- ingest -------------------------------------------------------------
    def ingest(self, topic: str, info: dict) -> bool:
        """One retained announce (or announce update): upsert the
        server's row when it carries a digest this observatory speaks.
        Returns True when the row advanced (new instance or newer
        seq)."""
        digest = info.get(DIGEST_KEY)
        if not isinstance(digest, dict):
            return False
        if int(digest.get("v", 0)) != DIGEST_VERSION:
            return False
        try:
            host = str(info["host"])
            port = int(info["port"])
            seq = int(digest["seq"])
        except (KeyError, TypeError, ValueError):
            return False
        now = self.clock()
        with self._lock:
            # any decodable digest proves the plane is moving — set
            # BEFORE the dup-seq dedupe (a re-announced broker redelivers
            # retained state with an already-seen seq)
            self._last_ingest_ts = now
            self._evict_stale_locked(now)
            row = self._rows.get(topic)
            if row is None:
                row = _ServerRow(topic, host, port)
                self._rows[topic] = row
                if topic in self._retired_rows:
                    # resurrection: the instance was retired (transient
                    # staleness) but is alive — reverse its retired
                    # contribution, or its cumulative counters would
                    # be summed twice in every rollup from here on
                    self._unretire_locked(topic)
                else:
                    self.servers_seen += 1
            elif seq <= int(row.digest.get("seq", 0)):
                # retained redelivery / out-of-order duplicate: the row
                # already holds this digest or a newer one
                return False
            row.host, row.port = host, port
            row.digest = digest
            row.received_ts = now
            row.digests += 1
            self.digests += 1
            # table bound AFTER the upsert: the evicted row must be the
            # one with the oldest digest, never the half-initialized
            # newcomer (its counters retire exactly like a stale row's)
            while len(self._rows) > self.max_servers:
                oldest = min(
                    self._rows.values(), key=lambda r: r.received_ts)
                self._retire_locked(oldest, stale=True)
            return True

    def note_tombstone(self, topic: str) -> None:
        """The server deleted its retained announce (clean stop): retire
        its row — counters survive in the retired accumulator."""
        with self._lock:
            self._last_ingest_ts = self.clock()
            row = self._rows.pop(topic, None)
            if row is not None:
                self._retire_locked(row, stale=False, pop=False)

    def _retire_locked(self, row: _ServerRow, stale: bool,
                       pop: bool = True) -> None:
        d = row.digest
        pfx = d.get("prefix") or {}
        contrib = {
            "tokens": int(d.get("tokens", 0) or 0),
            "admitted": int(d.get("admitted", 0) or 0),
            "shed": int(d.get("shed", 0) or 0),
            "prefix_hits": int(pfx.get("hits", 0) or 0),
            "prefix_misses": int(pfx.get("misses", 0) or 0),
            "tenants": {
                t: {"admitted": int(r.get("admitted", 0)),
                    "shed": int(r.get("shed", 0))}
                for t, r in (d.get("tenants") or {}).items()
            },
        }
        self._retired_tokens += contrib["tokens"]
        self._retired_admitted += contrib["admitted"]
        self._retired_shed += contrib["shed"]
        self._retired_prefix_hits += contrib["prefix_hits"]
        self._retired_prefix_misses += contrib["prefix_misses"]
        for t, r in contrib["tenants"].items():
            agg = self._retired_tenants.setdefault(
                t, {"admitted": 0, "shed": 0})
            agg["admitted"] += r["admitted"]
            agg["shed"] += r["shed"]
        self._retired_rows[row.topic] = contrib
        self._retired_rows.move_to_end(row.topic)
        while len(self._retired_rows) > self.retired_cap:
            # aggregates already hold the evicted row's counters exactly
            # (the accumulators above are separate from these
            # snapshots); what is lost is only the ability to reverse a
            # resurrection for that topic — count it LOUDLY
            evicted_topic, _ = self._retired_rows.popitem(last=False)
            self.retired_evicted += 1
            log.warning(
                "retired-server ledger over cap (%d): dropping "
                "resurrection snapshot for %s (aggregates preserved)",
                self.retired_cap, evicted_topic)
        if stale:
            self.stale_evicted += 1
        else:
            self.retired += 1
        if pop:
            self._rows.pop(row.topic, None)

    def _unretire_locked(self, topic: str) -> None:
        contrib = self._retired_rows.pop(topic)
        self._retired_tokens -= contrib["tokens"]
        self._retired_admitted -= contrib["admitted"]
        self._retired_shed -= contrib["shed"]
        self._retired_prefix_hits -= int(contrib.get("prefix_hits", 0))
        self._retired_prefix_misses -= int(contrib.get("prefix_misses", 0))
        for t, r in contrib["tenants"].items():
            agg = self._retired_tenants.get(t)
            if agg is None:
                continue
            agg["admitted"] -= r["admitted"]
            agg["shed"] -= r["shed"]
            if agg["admitted"] == 0 and agg["shed"] == 0:
                self._retired_tenants.pop(t, None)
        self.resurrected += 1
        log.info(
            "digest row %s resurrected: its retired contribution "
            "(%d tokens) reversed", topic, contrib["tokens"])

    def _row_ttl(self, row: _ServerRow) -> float:
        return float(row.digest.get("ttl_s", self.default_ttl_s)
                     or self.default_ttl_s)

    def _stale_locked(self, row: _ServerRow, now: float) -> bool:
        """Stale tier below eviction: the digest outlived
        ``stale_fraction`` of its TTL.  The row stays listed (the server
        may be merely slow), but it is flagged in :meth:`servers`,
        counted in ``rollup()["stale"]``, and EXCLUDED from the
        headroom/throughput gauges — a wedged-but-announcing server must
        never count as capacity."""
        return now - row.received_ts > self.stale_fraction * self._row_ttl(row)

    def _evict_stale_locked(self, now: float) -> None:
        for row in list(self._rows.values()):
            ttl = self._row_ttl(row)
            if now - row.received_ts > ttl:
                log.warning(
                    "digest from %s (%s) stale for %.1fs > ttl %.1fs; "
                    "retiring the row", row.addr, row.topic,
                    now - row.received_ts, ttl)
                self._retire_locked(row, stale=True)

    # -- views --------------------------------------------------------------
    def servers(self) -> List[Dict[str, Any]]:
        """Live per-server table (stale rows evicted first): one dict
        per server with addr, digest fields, and the observed age."""
        now = self.clock()
        with self._lock:
            self._evict_stale_locked(now)
            # the digest's own age_s is the PUBLISHER's uptime; seen_s
            # is how long ago THIS observatory received it (staleness)
            return [
                {
                    **r.digest,
                    "topic": r.topic,
                    "addr": r.addr,
                    "seen_s": round(now - r.received_ts, 3),
                    "digests": r.digests,
                    "stale": self._stale_locked(r, now),
                }
                for r in sorted(self._rows.values(), key=lambda r: r.addr)
            ]

    def rollup(self) -> Dict[str, Any]:
        """Fleet aggregates.  Counters (``tokens``, ``admitted``,
        ``shed``, per-tenant rows) sum over live AND retired servers —
        exactly the sum of every per-server ledger that ever served;
        gauges (occupancy, headroom, tokens/s) cover live servers
        only."""
        now = self.clock()
        with self._lock:
            self._evict_stale_locked(now)
            rows = list(self._rows.values())
            roll: Dict[str, Any] = {
                "servers": len(rows),
                "stale": 0,
                "draining": 0,
                "degraded": 0,
                "swapping": 0,
                "mem_pressured": 0,
                "inflight": 0,
                "slots": 0,
                "occupied": 0,
                "waiting": 0,
                "tokens_per_s": 0.0,
                "slot_headroom": 0,
                "mem_headroom_bytes": 0,
                "ttft_p95_ms": 0.0,
                "tokens": self._retired_tokens,
                "admitted": self._retired_admitted,
                "shed": self._retired_shed,
                "prefix_hits": self._retired_prefix_hits,
                "prefix_misses": self._retired_prefix_misses,
                "prefix_entries": 0,
                "digests": self.digests,
                "retired": self.retired,
                "stale_evicted": self.stale_evicted,
                "retired_evicted": self.retired_evicted,
                "servers_seen": self.servers_seen,
                # control-plane health (explicit broker-loss signal)
                "plane_connected": 1 if self.plane_connected else 0,
                "plane_ingest_age_s": round(
                    self.plane_ingest_age_s(now), 3),
                "plane_reconnects": self.plane_reconnects,
            }
            tenants: Dict[str, Dict[str, int]] = {
                t: dict(r) for t, r in self._retired_tenants.items()
            }
            slo_burn: Dict[str, float] = {}
            for r in rows:
                d = r.digest
                stale = self._stale_locked(r, now)
                roll["stale"] += 1 if stale else 0
                roll["draining"] += 1 if d.get("draining") else 0
                roll["degraded"] += 1 if d.get("degraded") else 0
                roll["swapping"] += (
                    1 if d.get("swap", "idle") != "idle" else 0)
                pressured = bool(d.get("mem_pressure", 0))
                roll["mem_pressured"] += 1 if pressured else 0
                roll["inflight"] += int(d.get("inflight", 0) or 0)
                slots = int(d.get("slots", 0) or 0)
                occupied = int(d.get("occupied", 0) or 0)
                roll["slots"] += slots
                roll["occupied"] += occupied
                roll["waiting"] += int(d.get("waiting", 0) or 0)
                if not stale:
                    # capacity/throughput gauges come from FRESH rows
                    # only: a wedged-but-announcing server's numbers are
                    # fiction, and counting its free slots as headroom
                    # would talk the controller out of a needed scale-up
                    roll["tokens_per_s"] += float(d.get("tokens_per_s", 0.0)
                                                  or 0.0)
                    # admittable headroom: free slots on servers NOT
                    # under memory pressure (a pressured server sheds
                    # BUSY at the door, so its free slots are not
                    # admittable)
                    if not pressured:
                        roll["slot_headroom"] += max(0, slots - occupied)
                    roll["mem_headroom_bytes"] += int(
                        d.get("mem_headroom_bytes", 0) or 0)
                    roll["ttft_p95_ms"] = max(
                        roll["ttft_p95_ms"],
                        float(d.get("ttft_p95_ms", 0.0) or 0.0))
                roll["tokens"] += int(d.get("tokens", 0) or 0)
                roll["admitted"] += int(d.get("admitted", 0) or 0)
                roll["shed"] += int(d.get("shed", 0) or 0)
                pfx = d.get("prefix") or {}
                roll["prefix_hits"] += int(pfx.get("hits", 0) or 0)
                roll["prefix_misses"] += int(pfx.get("misses", 0) or 0)
                roll["prefix_entries"] += int(pfx.get("entries", 0) or 0)
                for t, trow in (d.get("tenants") or {}).items():
                    agg = tenants.setdefault(t, {"admitted": 0, "shed": 0})
                    agg["admitted"] += int(trow.get("admitted", 0))
                    agg["shed"] += int(trow.get("shed", 0))
                for t, b in (d.get("slo_burn") or {}).items():
                    slo_burn[t] = max(slo_burn.get(t, 0.0), float(b))
            roll["occupancy"] = round(
                roll["occupied"] / roll["slots"], 4) if roll["slots"] else 0.0
            lookups = roll["prefix_hits"] + roll["prefix_misses"]
            roll["prefix_hit_ratio"] = round(
                roll["prefix_hits"] / lookups, 4) if lookups else 0.0
            roll["tokens_per_s"] = round(roll["tokens_per_s"], 3)
            roll["tenants"] = tenants
            roll["slo_burn"] = {
                t: round(b, 3) for t, b in slo_burn.items()}
            return roll

    def snapshot(self) -> Dict[str, Any]:
        """Pollable fleet view: the rollup plus the live server table —
        what a dashboard renders and the controller plans on."""
        return {"rollup": self.rollup(), "servers": self.servers()}

    # -- registry export (ONE collector; scrape-time only) ------------------
    _ROLLUP_METRICS: Tuple[Tuple[str, str], ...] = (
        ("servers", "nns.fleet.servers"),
        ("stale", "nns.fleet.stale"),
        ("draining", "nns.fleet.draining"),
        ("degraded", "nns.fleet.degraded"),
        ("swapping", "nns.fleet.swapping"),
        ("mem_pressured", "nns.fleet.mem_pressured"),
        ("inflight", "nns.fleet.inflight"),
        ("slots", "nns.fleet.slots"),
        ("occupied", "nns.fleet.occupied"),
        ("waiting", "nns.fleet.waiting"),
        ("occupancy", "nns.fleet.occupancy"),
        ("tokens_per_s", "nns.fleet.tokens_per_s"),
        ("slot_headroom", "nns.fleet.slot_headroom"),
        ("mem_headroom_bytes", "nns.fleet.mem_headroom_bytes"),
        ("tokens", "nns.fleet.tokens"),
        ("admitted", "nns.fleet.admitted"),
        ("shed", "nns.fleet.shed"),
        ("prefix_hits", "nns.fleet.prefix_hits"),
        ("prefix_misses", "nns.fleet.prefix_misses"),
        ("prefix_hit_ratio", "nns.fleet.prefix_hit_ratio"),
        ("prefix_entries", "nns.fleet.prefix_entries"),
        ("digests", "nns.fleet.digests"),
        ("retired", "nns.fleet.retired"),
        ("stale_evicted", "nns.fleet.stale_evicted"),
        ("retired_evicted", "nns.fleet.retired_evicted"),
        ("ttft_p95_ms", "nns.fleet.ttft_p95_ms"),
        ("plane_connected", "nns.fleet.plane_connected"),
        ("plane_ingest_age_s", "nns.fleet.plane_ingest_age_s"),
        ("plane_reconnects", "nns.fleet.plane_reconnects"),
    )

    def _collect(self) -> List[Sample]:
        roll = self.rollup()
        base = {"fleet": self.topic or "all"}
        out: List[Sample] = []
        for key, mname in self._ROLLUP_METRICS:
            assert mname in METRICS, mname  # catalogued (schema lint)
            out.append(Sample(
                mname, dict(base), float(roll.get(key, 0) or 0),
                metric_kind(mname)))
        for t, trow in roll["tenants"].items():
            tl = {**base, "tenant": t or "_"}
            out.append(Sample("nns.fleet.tenant_admitted", dict(tl),
                              trow["admitted"], "counter"))
            out.append(Sample("nns.fleet.tenant_shed", dict(tl),
                              trow["shed"], "counter"))
        for t, b in roll["slo_burn"].items():
            out.append(Sample(
                "nns.fleet.slo_burn", {**base, "tenant": t or "_"},
                b, "gauge"))
        return out
