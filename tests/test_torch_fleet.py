"""Port parity for the fleet observatory: telemetry digests and rollups.

* ``DigestPublisher`` under a fake clock builds the JAX package's digests
  from the same stats, poll by poll (the tokens/s EWMA, bounded tenant
  maps, truncation, the prefix block, forced publishes and failures);
* both packages' ``FleetObservatory``, fed one announce sequence under one
  fake clock (fresh, stale, TTL-retired, tombstoned, resurrected and
  capped rows, duplicate seqs), give equal ``snapshot()`` and ``rollup()``
  after every step, and ``hint_from_announce`` equal hints;
* over a ``MiniBroker`` on 127.0.0.1, a JAX observatory rolls up port
  servers' digests and a port observatory JAX servers': after traffic and
  one server stopped (its announce tombstoned), the rollup's ``admitted``
  and ``tokens`` equal the sum of the servers' own ledgers exactly, the
  retired one included, and the port's ``/metrics`` carries ``nns.fleet.*``.
"""

import time
import urllib.request

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import fleet as jf
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core import fleet as tf
from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse
from torch_census import module_leak_check  # noqa: F401

torch.set_num_threads(2)

MOD = {"jax": jf, "port": tf}
PARSE = {"jax": jax_parse, "port": torch_parse}


def test_constants_are_the_jax_packages():
    for key in ("DIGEST_VERSION", "DIGEST_KEY", "DIGEST_MAX_BYTES", "DIGEST_MAX_TENANTS",
                "DIGEST_TTL_INTERVALS", "DIGEST_STALE_FRACTION", "RETIRED_ROWS_MAX",
                "OBSERVATORY_MAX_SERVERS"):
        assert getattr(tf, key) == getattr(jf, key), key


def _stats_script():
    """Stats a server's source returns at successive polls."""
    many = {f"t{i}": {"admitted": i, "shed": i % 3} for i in range(20)}
    return [
        {"inflight": 1, "admitted": 3, "shed": 0, "tokens": 0, "slots": 4, "occupied": 1,
         "waiting": 0, "swap": "idle", "tenants": {"a": {"admitted": 3, "shed": 0}}},
        {"inflight": 2, "admitted": 9, "shed": 1, "tokens": 120, "slots": 4, "occupied": 3,
         "waiting": 2, "mem_headroom_bytes": 1 << 30, "mem_pressure": 0, "ttft_p95_ms": 12.3456,
         "slo_burn": {"a": 0.5}, "tenants": many,
         "prefix": {"hits": 4, "misses": 2, "entries": 3, "hot": [f"d{i}" for i in range(12)]}},
        {"draining": True, "degraded": True, "swap": "staged", "inflight": 0, "admitted": 9,
         "shed": 1, "tokens": 300, "slots": 4, "occupied": 0, "waiting": 0,
         "tenants": {f"x{'y' * 300}{i}": {"admitted": i, "shed": 0} for i in range(16)}},
        {"admitted": 10, "tokens": 310},
    ]


@pytest.mark.parametrize("fail_at", [None, 2], ids=["ok", "publish-fails"])
def test_digest_publisher_builds_the_jax_digests(fail_at):
    script = _stats_script()

    def run(mod):
        t, i, out = [0.0], [0], []

        def publish(d):
            if fail_at is not None and d["seq"] == fail_at:
                raise OSError("broker down")
            out.append(d)

        pub = mod.DigestPublisher(lambda: script[min(i[0], len(script) - 1)], publish,
                                  interval_s=0.5, clock=lambda: t[0], name="srv")
        polls = []
        for dt, force, at in [(0.0, False, 0), (0.3, False, 0), (0.6, False, 1),
                              (0.7, True, 1), (1.5, False, 2), (2.25, False, 3)]:
            t[0], i[0] = dt, at
            polls.append(pub.poll(force=force))
        return polls, out, (pub.seq, pub.published, pub.publish_failures, pub.ttl_s)

    got, want = run(tf), run(jf)
    assert got == want
    digests = [d for d in got[0] if d]
    assert any(d.get("truncated") for d in digests)
    assert any(d.get("tenants_dropped") == 4 for d in digests)
    assert any(d.get("prefix", {}).get("hot") == [f"d{i}" for i in range(8)] for d in digests)


def _digest(seq=1, ttl=10.0, **kw):
    d = {"v": 1, "seq": seq, "age_s": 0.0, "interval_s": 1.0, "ttl_s": ttl, "draining": False,
         "degraded": False, "swap": "idle", "inflight": 0, "admitted": 0, "shed": 0,
         "tokens_per_s": 0.0}
    d.update(kw)
    return d


def _ann(digest, port):
    return {"host": "h", "port": port, "digest": digest}


#: (clock, op, topic, announce-or-None): one announce sequence
SEQUENCE = [
    (0.0, "ingest", "a", _ann(_digest(1, tokens=100, admitted=5, slots=4, occupied=1,
                                      tokens_per_s=50.0, mem_headroom_bytes=1000,
                                      ttft_p95_ms=20.0,
                                      tenants={"A": {"admitted": 5, "shed": 0}},
                                      prefix={"hits": 2, "misses": 1, "entries": 1}), 1)),
    (1.0, "ingest", "b", _ann(_digest(1, ttl=4.0, tokens=30, admitted=2, shed=1, slots=4,
                                      occupied=2, waiting=1, tokens_per_s=25.0,
                                      slo_burn={"A": 1.5}, mem_pressure=1,
                                      tenants={"A": {"admitted": 1, "shed": 1},
                                               "B": {"admitted": 1, "shed": 0}}), 2)),
    (1.5, "ingest", "a", _ann(_digest(1, tokens=999), 1)),   # duplicate seq: ignored
    (2.0, "ingest", "c", _ann(_digest(3, draining=True, swap="staging", tokens=7,
                                      admitted=1), 3)),
    (2.5, "ingest", "x", {"host": "h", "port": 9}),          # no digest
    (2.6, "ingest", "y", _ann(dict(_digest(1), v=2), 9)),    # another version
    (4.0, "read", "", None),                                  # b is stale now
    (6.0, "read", "", None),                                  # b retired on its TTL
    (6.5, "ingest", "b", _ann(_digest(2, ttl=4.0, tokens=40, admitted=3, shed=1), 2)),
    (7.0, "tombstone", "c", None),
    (7.5, "ingest", "a", _ann(_digest(2, tokens=150, admitted=8,
                                      tenants={"A": {"admitted": 8, "shed": 0}}), 1)),
    (9.0, "tombstone", "zz", None),                           # unknown topic
    (12.0, "read", "", None),
]


def _observe(mod):
    t = [0.0]
    obs = mod.FleetObservatory(topic="f", clock=lambda: t[0], retired_cap=2)
    views = []
    for now, op, topic, info in SEQUENCE:
        t[0] = now
        if op == "ingest":
            views.append(obs.ingest(topic, info))
        elif op == "tombstone":
            obs.note_tombstone(topic)
        views.append(obs.snapshot())
    return views, (obs.retired, obs.stale_evicted, obs.resurrected, obs.digests,
                   obs.servers_seen, obs.retired_evicted)


def test_observatories_roll_up_one_announce_sequence_equally():
    got, want = _observe(tf), _observe(jf)
    assert got == want
    final = got[0][-1]["rollup"]
    assert final["retired"] == 1 and final["stale_evicted"] >= 1
    assert final["tokens"] == 150 + 40 + 7 and final["admitted"] == 8 + 3 + 1
    for info in ({"draining": True}, {"digest": {"draining": False, "degraded": True}},
                 {"digest": {"seq": 1}, "degraded": True}, {}):
        assert tf.hint_from_announce(info) == jf.hint_from_announce(info)


def _gen_server(pkg, sid, broker_port):
    pipe = PARSE[pkg](
        f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 connect-type=tcp "
        f"topic=fleetx dest-host=127.0.0.1 dest-port={broker_port} digest-interval=0.1 ! "
        "tensor_generator name=gen slots=2 custom=sim:1,sim_step_ms:1,vocab:997 max-new=12 "
        f"chunk=4 ! tensor_query_serversink id={sid}", name=f"fleet-{pkg}-{sid}")
    pipe.start()
    return pipe


def _stream(pkg, port, prompts):
    cl = PARSE[pkg](f"appsrc name=src ! tensor_query_client name=q connect-type=tcp "
                    f"host=127.0.0.1 port={port} stream=true timeout=30 ! tensor_sink name=out",
                    name=f"fleet-cli-{pkg}")
    cl.start()
    try:
        for p in prompts:
            cl["src"].push(np.asarray(p, np.int32))
        cl["src"].end_of_stream()
        cl.wait(timeout=30)
    finally:
        cl.stop()


def _wait(pred, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


@pytest.mark.parametrize("server_pkg,obs_pkg", [("port", "jax"), ("jax", "port")])
def test_observatory_reads_the_other_packages_servers(server_pkg, obs_pkg):
    broker = MiniBroker()
    servers, obs = [], None
    try:
        obs = MOD[obs_pkg].FleetObservatory(topic="fleetx").start("127.0.0.1", broker.port)
        servers = [_gen_server(server_pkg, 1961 + i, broker.port) for i in range(2)]
        _wait(lambda: len(obs.servers()) == 2, "two servers seen")
        for i, s in enumerate(servers):
            _stream(server_pkg, s["ssrc"].props["port"], [[i + 1, 2, 3], [4, 5, i + 6]][:i + 1])

        def ledgers():
            rows = [s.health() for s in servers]
            return (sum(r["ssrc"]["admitted"] for r in rows),
                    sum(r["gen"]["gen_tokens"] for r in rows))

        admitted, tokens = ledgers()
        assert (admitted, tokens) == (3, 36)
        _wait(lambda: (obs.rollup()["admitted"], obs.rollup()["tokens"]) == (admitted, tokens),
              f"rollup {obs.rollup()} to reach {(admitted, tokens)}")
        servers[0].stop()  # a last digest, then the tombstone
        _wait(lambda: obs.rollup()["retired"] == 1, "the stopped server retired")
        roll = obs.rollup()
        assert (roll["servers"], roll["admitted"], roll["tokens"]) == (1, admitted, tokens)
        assert roll["slots"] == 2 and roll["tenants"] == {"": {"admitted": 3, "shed": 0}}
        if obs_pkg == "port":
            port = obs.serve_metrics(0)
            body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5).read()
            text = body.decode()
            assert 'nns_fleet_tokens{fleet="fleetx"} 36' in text
            assert 'nns_fleet_retired{fleet="fleetx"} 1' in text
    finally:
        for s in servers:
            s.stop()
        if obs is not None:
            obs.stop()
        broker.close()
