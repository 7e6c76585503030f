"""Port parity for fleet routing (``core/routing.py``) and the query
client's routing decision.

The pure functions run on the same inputs in both packages and must give
the same owners and orders; the contracts are the JAX package's
``tests/test_fleet.py::TestRouting*``: rendezvous fairness within 25% of
uniform over 2000 keys and 8 servers, the provable minimum remapped on a
join or a leave, tier ranking that never puts a breaker-open or draining
remote ahead of a healthy one, and the client's ranking on a synthetic
pool (no sockets).
"""

import math
from collections import Counter

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import routing as jr
from nnstreamer_tpu_torch.core import routing as tr
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.core.continuity import PREFIX_GRAIN
from nnstreamer_tpu_torch.core.resilience import CircuitBreaker
from nnstreamer_tpu_torch.elements.query import _PoolState
from nnstreamer_tpu_torch.pipeline import make_element

torch.set_num_threads(2)

KEYS = [f"sess-{i}" for i in range(2000)]
FLEET8 = [(f"10.0.0.{i}", 7000 + i) for i in range(8)]


def test_constants_are_the_jax_constants():
    assert tr.ROUTING_POLICIES == jr.ROUTING_POLICIES
    assert (tr.TIER_OK, tr.TIER_DEGRADED, tr.TIER_DRAINING, tr.TIER_DOWN) == (
        jr.TIER_OK, jr.TIER_DEGRADED, jr.TIER_DRAINING, jr.TIER_DOWN)


@pytest.mark.parametrize("fleet", [FLEET8[:1], FLEET8[:3], FLEET8,
                                   [("127.0.0.1", 7000 + i) for i in range(5)]])
def test_owners_equal_jax_over_2000_keys(fleet):
    assert tr.ownership_map(KEYS, fleet) == jr.ownership_map(KEYS, fleet)


def test_no_target_raises_like_jax():
    with pytest.raises(ValueError, match="at least one target"):
        tr.rendezvous_owner("k", [])
    with pytest.raises(ValueError, match="at least one target"):
        jr.rendezvous_owner("k", [])


def test_fairness_within_25pct_of_uniform_across_8_servers():
    owners = Counter(tr.rendezvous_owner(k, FLEET8) for k in KEYS)
    ideal = len(KEYS) / len(FLEET8)
    assert set(owners) == set(range(8))
    for i, n in owners.items():
        assert 0.75 * ideal <= n <= 1.25 * ideal, (i, n)


def test_join_remaps_only_what_the_newcomer_wins():
    before = tr.ownership_map(KEYS, FLEET8)
    grown = FLEET8 + [("10.0.0.8", 7008)]
    after = tr.ownership_map(KEYS, grown)
    moved = [k for k in KEYS if before[k] != after[k]]
    assert moved
    assert all(grown[after[k]] == ("10.0.0.8", 7008) for k in moved)
    assert len(moved) <= math.ceil(1.25 * len(KEYS) / len(grown))


@pytest.mark.parametrize("gone", [0, 3, 7])
def test_leave_remaps_only_the_departed_servers_keys(gone):
    before = tr.ownership_map(KEYS, FLEET8)
    survivors = FLEET8[:gone] + FLEET8[gone + 1:]
    after = tr.ownership_map(KEYS, survivors)
    moved = sorted(k for k in KEYS if FLEET8[before[k]] != survivors[after[k]])
    assert moved == sorted(k for k in KEYS if before[k] == gone)
    assert len(moved) <= math.ceil(1.25 * len(KEYS) / len(FLEET8))


def _rank_cases():
    ok, deg, dr, down = tr.TIER_OK, tr.TIER_DEGRADED, tr.TIER_DRAINING, tr.TIER_DOWN
    return [
        ({i: ok for i in range(4)}, 2, 4, None, None, None),
        ({i: ok for i in range(4)}, 3, 4, {0: 3, 1: 0, 2: 1, 3: 0}, None, None),
        ({i: ok for i in range(3)}, 0, 3, {0: 0, 1: 2, 2: 0}, {0: 40.0, 1: 5.0, 2: 5.0}, None),
        ({0: ok, 1: down, 2: ok}, 1, 3, {0: 9, 1: 0, 2: 7}, {0: 90.0, 1: 0.1, 2: 70.0}, None),
        ({0: down, 1: dr, 2: ok, 3: deg}, 0, 4, {}, {}, None),
        ({0: ok, 1: ok, 2: down}, 0, 3, None, None, 1),
        ({0: ok, 1: ok, 2: down}, 0, 3, None, None, 2),
        ({0: dr, 1: ok, 2: dr, 3: deg, 4: ok}, 4, 5, {0: 1, 1: 1, 4: 0}, {1: 3.0, 4: 3.0}, 2),
    ]


@pytest.mark.parametrize("policy", tr.ROUTING_POLICIES)
@pytest.mark.parametrize("case", range(len(_rank_cases())))
def test_order_remotes_equals_jax(policy, case):
    tiers, first, n, infl, scores, owner = _rank_cases()[case]
    got = tr.order_remotes(policy, tiers, first, n, infl, scores, owner)
    assert got == jr.order_remotes(policy, tiers, first, n, infl, scores, owner)
    assert sorted(got) == list(range(n))


def test_rank_truth_table():
    ok, dr, down = tr.TIER_OK, tr.TIER_DRAINING, tr.TIER_DOWN
    tiers4 = {i: ok for i in range(4)}
    assert tr.order_remotes("rotate", tiers4, 2, 4) == [2, 3, 0, 1]
    assert tr.order_remotes("least-inflight", tiers4, 3, 4,
                            inflight={0: 3, 1: 0, 2: 1, 3: 0}) == [3, 1, 2, 0]
    assert tr.order_remotes("ewma", {i: ok for i in range(3)}, 0, 3, inflight={0: 0, 1: 2, 2: 0},
                            scores={0: 40.0, 1: 5.0, 2: 5.0}) == [2, 1, 0]
    for policy in tr.ROUTING_POLICIES:
        order = tr.order_remotes(policy, {0: ok, 1: down, 2: ok}, 1, 3,
                                 inflight={0: 9, 1: 0, 2: 7}, scores={0: 90.0, 1: 0.1, 2: 70.0})
        assert order[-1] == 1  # the down remote never outranks a healthy one
        assert tr.order_remotes(policy, {0: down, 1: dr, 2: ok}, 0, 3,
                                inflight={}, scores={}) == [2, 1, 0]
    tiers = {0: ok, 1: ok, 2: down}
    assert tr.order_remotes("rotate", tiers, 0, 3, affinity_owner=1)[:2] == [1, 0]
    assert tr.order_remotes("rotate", tiers, 0, 3, affinity_owner=2) == [0, 1, 2]
    with pytest.raises(ValueError, match="unknown routing policy"):
        tr.rank_tier("random", [0, 1], 0, 2)


def test_ewma_scores_neutral_mean_equals_jax():
    addrs = ["a:1", "b:2", "c:3"]
    spans = {"a:1": {"e2e_ms": 10.0, "requests": 5}, "b:2": {"e2e_ms": 30.0, "requests": 5}}
    got = tr.ewma_scores(range(3), addrs, spans)
    assert got == jr.ewma_scores(range(3), addrs, spans)
    assert got[2] == pytest.approx(20.0)
    spans["c:3"] = {"e2e_ms": None, "requests": 0}  # no completed request: no signal
    assert tr.ewma_scores(range(3), addrs, spans)[2] == pytest.approx(20.0)
    assert tr.ewma_scores(range(2), addrs, {}) == {0: 0.0, 1: 0.0}


# -- the client's routing decision on a synthetic pool ------------------------
def _client(n=3, **props):
    el = make_element("tensor_query_client", "q")
    for k, v in props.items():
        el.set_property(k, v)
    targets = [("127.9.9.9", 7100 + i) for i in range(n)]
    el._pstate = _PoolState([object() for _ in range(n)], targets)
    return el


def _trip(el, target):
    b = el._breaker_for(target)
    for _ in range(int(el.props["breaker-threshold"])):
        b.record_failure()
    assert b.state == CircuitBreaker.OPEN


@pytest.mark.parametrize("policy", tr.ROUTING_POLICIES)
def test_open_breaker_never_selected_over_closed_alternative(policy):
    el = _client(3, routing=policy)
    _trip(el, el._pstate.targets[0])
    el._remote_inflight.update({"127.9.9.9:7101": 5, "127.9.9.9:7102": 7})
    el._remote_spans.update({"127.9.9.9:7100": {"e2e_ms": 0.1, "requests": 100},
                             "127.9.9.9:7101": {"e2e_ms": 80.0, "requests": 100},
                             "127.9.9.9:7102": {"e2e_ms": 90.0, "requests": 100}})
    for first in range(3):
        assert el._route_order(el._pstate, None, first)[-1] == 0


def test_cooled_down_remote_ranks_last():
    el = _client(3)
    el._pstate.down_until[1] = float("inf")
    assert el._route_order(el._pstate, None, 1) == [2, 0, 1]


def test_ewma_reads_only_current_endpoints():
    el = _client(2, routing="ewma")
    el._remote_spans.update({"10.66.66.66:9999": {"e2e_ms": 0.001, "requests": 10_000},
                             "127.9.9.9:7100": {"e2e_ms": 50.0, "requests": 10},
                             "127.9.9.9:7101": {"e2e_ms": 5.0, "requests": 10}})
    assert el._route_order(el._pstate, None, 0) == [1, 0]


def test_affinity_remap_counting():
    el = _client(2, **{"affinity-key": "sess"})
    f = TensorFrame([np.float32([1])], meta={"sess": "k1"})
    el._route_order(el._pstate, f, 0)
    el._route_order(el._pstate, f, 1)
    assert el._affinity_remaps == 0
    owner = tr.rendezvous_owner("k1", el._pstate.targets)
    survivors = [t for i, t in enumerate(el._pstate.targets) if i != owner]
    el._pstate = _PoolState([object()], survivors)
    el._route_order(el._pstate, f, 0)
    assert el._affinity_remaps == 1


def test_affinity_batch_uses_first_frame_key():
    el = _client(3, **{"affinity-key": "sess"})
    f = TensorFrame([np.float32([1])], meta={"sess": "sticky"})
    owner = tr.rendezvous_owner("sticky", el._pstate.targets)
    for first in range(3):
        assert el._route_order(el._pstate, [f, f], first)[0] == owner


def test_prefix_affinity_routes_shared_prompts_to_one_owner():
    """affinity-key=prefix: prompts sharing their first grain land on one
    owner, the owner the JAX client picks for the same prompt."""
    from nnstreamer_tpu.core.buffer import TensorFrame as JFrame
    from nnstreamer_tpu.elements.query import _PoolState as JPool
    from nnstreamer_tpu.pipeline.element import make_element as jmake

    el = _client(5, **{"affinity-key": "prefix"})
    jel = jmake("tensor_query_client", "jq")
    jel.props["affinity-key"] = "prefix"
    jel._pstate = JPool([object()] * 5, el._pstate.targets, 0)
    rng = np.random.default_rng(3)
    head = rng.integers(0, 50257, (1, PREFIX_GRAIN), dtype=np.int32)
    owners = set()
    for i in range(6):
        tail = rng.integers(0, 50257, (1, 7 + i), dtype=np.int32)
        prompt = np.concatenate([head, tail], axis=1)
        got = el._route_order(el._pstate, TensorFrame([prompt]), i % 5)[0]
        want = jel._route_order(jel._pstate, JFrame([prompt]), i % 5)[0]
        assert got == want
        owners.add(got)
    assert len(owners) == 1
    # no usable prompt: the plain policy order
    assert el._route_order(el._pstate, TensorFrame([]), 2) == [2, 3, 4, 0, 1]
