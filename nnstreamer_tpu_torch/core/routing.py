"""Fleet routing primitives: consistent-hash affinity and policy ranking.

Port of ``nnstreamer_tpu/core/routing.py``, the same functions on the same
inputs (framework-free, so the two packages rank one fleet alike):

* **Rendezvous (HRW) hashing** for session affinity (``affinity-key``):
  each (key, endpoint) pair gets a deterministic weight and the key's
  owner is the endpoint with the highest one, so a membership change
  remaps the provable minimum of keys (a joining server takes about
  K/(N+1), a leaving one's K/N spread evenly, every other key stays).
* **Routing-policy ranking** (``rotate`` | ``least-inflight`` | ``ewma``)
  inside availability tiers: a breaker-open, cooled-down, draining or
  degraded remote never ranks ahead of a healthy one; load scores only
  reorder remotes within a tier.

Allocation-light and clock-free; the query client owns locks, clocks and
sockets.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

#: the routing policies the query client accepts (element prop `routing`)
ROUTING_POLICIES = ("rotate", "least-inflight", "ewma")

#: availability tiers, best first — ranking never promotes across tiers
TIER_OK = 0        # serving, breaker closed, no cooldown
TIER_DEGRADED = 1  # announced degraded (lost a device; serving reduced)
TIER_DRAINING = 2  # announced draining (discovery hint / GOAWAY cooldown)
TIER_DOWN = 3      # cooldown active or breaker open


def rendezvous_owner(key: str, targets: Sequence[Tuple[str, int]]) -> int:
    """Index of ``key``'s owner among ``targets`` (highest-random-weight
    hashing, deterministic across processes and runs).

    blake2b is used for speed and stable cross-platform output; the
    weight is the first 8 bytes of ``H(host:port|key)`` as a big-endian
    integer, ties broken by endpoint order (deterministic — ties are a
    2^-64 event anyway)."""
    if not targets:
        raise ValueError("rendezvous_owner needs at least one target")
    kb = key.encode()
    best_i = 0
    best_w = -1
    for i, (host, port) in enumerate(targets):
        h = hashlib.blake2b(digest_size=8)
        h.update(f"{host}:{port}|".encode())
        h.update(kb)
        w = int.from_bytes(h.digest(), "big")
        if w > best_w:
            best_w, best_i = w, i
    return best_i


def ownership_map(keys: Sequence[str],
                  targets: Sequence[Tuple[str, int]]) -> Dict[str, int]:
    """{key: owner index} for a whole key set (tests + capacity planning)."""
    return {k: rendezvous_owner(k, targets) for k in keys}


def ewma_scores(
    idxs: Sequence[int],
    addrs: Sequence[str],
    spans: Dict[str, Dict[str, Optional[float]]],
) -> Dict[int, float]:
    """Per-index latency score for the ``ewma`` policy.

    ``spans`` is the client's per-remote EWMA aggregation keyed by
    ``"host:port"`` (element health ``remotes``); ``addrs`` the current
    pool's address strings.  Only rows for the CURRENT addresses are
    consulted — rows for endpoints evicted by ``_rediscover`` are
    unreachable by construction (lookup is by address, never by
    iterating the dict), which pins the frozen-EWMA bugfix at the API
    level.  Endpoints with no row yet (a server that just joined) score
    the MEAN of the known rows: a fresh server is neither flooded
    (score 0 would win every race before one request completes) nor
    starved (score inf would never let it build a signal)."""
    known: Dict[int, float] = {}
    for i in idxs:
        agg = spans.get(addrs[i])
        if agg:
            v = agg.get("e2e_ms")
            if v is not None and agg.get("requests", 0) > 0:
                known[i] = float(v)
    neutral = (sum(known.values()) / len(known)) if known else 0.0
    return {i: known.get(i, neutral) for i in idxs}


def rank_tier(
    policy: str,
    idxs: List[int],
    first: int,
    n: int,
    inflight: Optional[Dict[int, int]] = None,
    scores: Optional[Dict[int, float]] = None,
) -> List[int]:
    """Order one availability tier's indices by routing policy.

    ``first``/``n`` define the rotation base every policy shares (the
    tie-break, and the whole ordering for ``rotate``): index distances
    from ``first`` modulo ``n``.  ``least-inflight`` sorts by the live
    per-remote in-flight count; ``ewma`` sorts by latency score with
    in-flight count as the first tie-break (two equally-fast servers
    split load instead of dog-piling the rotation winner)."""
    if policy == "rotate" or len(idxs) <= 1:
        return sorted(idxs, key=lambda i: (i - first) % n)
    infl = inflight or {}
    if policy == "least-inflight":
        # rotation distance as the last key: equal in-flight counts
        # keep rotating instead of always dog-piling the lowest index
        return sorted(
            idxs, key=lambda i: (infl.get(i, 0), (i - first) % n))
    if policy == "ewma":
        sc = scores or {}
        return sorted(
            idxs,
            key=lambda i: (sc.get(i, 0.0), infl.get(i, 0),
                           (i - first) % n))
    raise ValueError(
        f"unknown routing policy {policy!r} (want one of {ROUTING_POLICIES})")


def order_remotes(
    policy: str,
    tiers: Dict[int, int],
    first: int,
    n: int,
    inflight: Optional[Dict[int, int]] = None,
    scores: Optional[Dict[int, float]] = None,
    affinity_owner: Optional[int] = None,
) -> List[int]:
    """The full routing decision: every index of the pool, best first.

    ``tiers`` maps index -> TIER_* (availability partition computed by
    the element from cooldowns, breaker peeks, and discovery hints).
    Tier boundaries are absolute: no load score ever ranks a
    :data:`TIER_DOWN` (breaker-open / cooled-down) remote ahead of a
    :data:`TIER_OK` one while any exists — the selection-side guard.
    ``affinity_owner`` (consistent-hash stickiness) is promoted to the
    very front of ITS tier only: an affinity owner that is draining or
    breaker-open still waits behind every healthy alternative, so
    stickiness can never pin a session to a dead host."""
    out: List[int] = []
    for tier in (TIER_OK, TIER_DEGRADED, TIER_DRAINING, TIER_DOWN):
        idxs = [i for i, t in tiers.items() if t == tier]
        if not idxs:
            continue
        ranked = rank_tier(policy, idxs, first, n, inflight, scores)
        if affinity_owner is not None and affinity_owner in ranked:
            ranked.remove(affinity_owner)
            ranked.insert(0, affinity_owner)
        out.extend(ranked)
    return out
