"""The slot engine's deadline cut (ROADMAP C15): the port's engine cuts a
decode call short so it ends before the nearest live deadline less
``EVICT_MARGIN_S``, reckoned as ``a + b*k`` (a fixed cost per call plus a
cost per token, fitted over the measured wall of each k it has run), so
the typed expiry reaches the client before the deadline.

Both packages' engines run ``SimSlotModel`` under one fake clock that only
the model's modelled step costs advance (10 ms a decode token, prefill
free): three streams at ``chunk=16`` (a 160 ms call, over three times the
50 ms margin), one with a 1.05 s deadline and one of 12 tokens whose end
makes the engine run a 12-token call beside its 16-token ones (two
measured k: the fit separates the fixed cost from the per-token cost).
The JAX engine evicts at the first call boundary past ``deadline -
margin``, 1.07 s, after the deadline (the reference's behaviour); the
port's evicts before ``deadline - margin``.  A port-only case charges a
fixed 40 ms a call on top (the host's loop and sync on the card): a call
cut by seconds per token alone would end past ``deadline - margin``; the
port's still ends before it.  The tokens are the same: the stream without
a deadline gets every token of the SimSlotModel oracle in the same
16-token chunks in both packages, and the expired stream's kept tokens
are a prefix of its oracle.  Tolerance: exact (tokens, chunk sizes); the
clock is fake, so the times are exact sums of the modelled costs (1e-9
for their float sums).
"""

import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import slots as jslots
from nnstreamer_tpu.core.buffer import TensorFrame as JFrame
from nnstreamer_tpu_torch.core import slots as tslots
from nnstreamer_tpu_torch.core.buffer import TensorFrame as TFrame

torch.set_num_threads(2)

VOCAB, NEW, SHORT, CHUNK, DEADLINE = 997, 160, 12, 16, 1.05
MARGIN = tslots.SlotEngine.EVICT_MARGIN_S


class FakeClock:
    def __init__(self):
        self._t = 0.0
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def advance(self, s: float) -> None:
        with self._lock:
            self._t += s


def oracle(prompt, n):
    t = int(np.sum(prompt)) % VOCAB
    out = []
    for _ in range(n):
        out.append(t)
        t = (31 * t + 17) % VOCAB
    return out


class CallCostSim(tslots.SimSlotModel):
    """The port's SimSlotModel with a fixed cost per decode call besides
    its cost per token."""

    def __init__(self, *args, call_ms: float, **kwargs):
        super().__init__(*args, **kwargs)
        self.call_s = call_ms * 1e-3

    def decode_fn(self, k: int):
        inner = super().decode_fn(k)

        def fn(*args):
            self._sleep(self.call_s)
            return inner(*args)

        return fn


def _run(pkg, deadline=DEADLINE, call_ms=0.0):
    clock = FakeClock()
    mod, frame = (tslots, TFrame) if pkg == "port" else (jslots, JFrame)
    kw = dict(step_base_ms=10.0, step_per_slot_ms=0.0, prefill_ms_per_token=0.0,
              sleep=clock.advance)
    model = CallCostSim(3, call_ms=call_ms, **kw) if call_ms else mod.SimSlotModel(3, **kw)
    args = () if pkg == "port" else (None,)
    eng = mod.SlotEngine(model, *args, max_seq=1 << 20, chunk=CHUNK, prefill_chunk=64,
                         clock=clock)
    evicted_at = []
    evict = eng._evict
    eng._evict = lambda s, reason: (evicted_at.append((s.sid, reason, clock())),
                                    evict(s, reason))[1]
    prompts = [np.arange(1, 9, dtype=np.int32)[None], np.arange(5, 13, dtype=np.int32)[None],
               np.arange(2, 6, dtype=np.int32)[None]]
    a = eng.submit(frame([prompts[0]], pts=0.0), prompts[0], NEW, CHUNK)
    b = eng.submit(frame([prompts[1]], pts=1.0), prompts[1], NEW, CHUNK, deadline_ts=deadline)
    c = eng.submit(frame([prompts[2]], pts=2.0), prompts[2], SHORT, CHUNK)
    eng.start()
    out = {a.sid: [], b.sid: [], c.sid: []}
    finals = set()
    end = time.monotonic() + 60
    try:
        while len(finals) < 3:
            assert time.monotonic() < end, "the engine did not finish"
            for _, f in eng.pop_ready():
                sid = (a.sid, b.sid, c.sid)[int(f.pts)]
                out[sid].append(f)
                if f.meta.get("final"):
                    finals.add(sid)
            eng.wait_progress(0.01)
    finally:
        eng.stop()
    tokens = {sid: [t for f in fs if f.tensors for t in np.asarray(f.tensors[0])[0].tolist()]
              for sid, fs in out.items()}
    sizes = [np.asarray(f.tensors[0]).shape[1] for f in out[a.sid] if f.tensors]
    return {"a": tokens[a.sid], "b": tokens[b.sid], "c": tokens[c.sid], "a_sizes": sizes,
            "b_last": out[b.sid][-1].meta, "evicted_at": evicted_at, "engine": eng,
            "oracle": (oracle(prompts[0], NEW), oracle(prompts[1], NEW),
                       oracle(prompts[2], SHORT))}


def _check_tokens(r):
    assert r["a"] == r["oracle"][0]  # every token, as the oracle has them
    assert r["c"] == r["oracle"][2]
    assert r["a_sizes"] == [CHUNK] * (NEW // CHUNK)  # the stream's own grain
    assert r["b_last"]["evicted"] == "deadline" and r["b_last"]["deadline_expired"]
    assert r["b"] == r["oracle"][1][:len(r["b"])] and 0 < len(r["b"]) < NEW
    assert r["b_last"]["tokens_done"] == len(r["b"])


def test_the_typed_expiry_lands_before_the_deadline_with_the_same_tokens():
    port, jax = _run("port"), _run("jax")
    for r in (port, jax):
        _check_tokens(r)
    (_, _, t_port), = port["evicted_at"]
    (_, _, t_jax), = jax["evicted_at"]
    assert t_jax == pytest.approx(1.07) and t_jax > DEADLINE  # the reference: late
    assert t_port < DEADLINE - MARGIN + 1e-9  # the port: in time
    eng = port["engine"]
    assert eng.deadline_cut_calls >= 1
    # 11- and 16-token calls measured (the short stream's first token
    # comes from its prefill): no fixed cost, 10 ms a token
    assert {11, 16} <= set(eng.decode_call_wall)
    assert eng.decode_call_s(1) == pytest.approx(0.010)
    assert eng.decode_call_s(16) == pytest.approx(0.160)
    assert (port["a"], port["c"]) == (jax["a"], jax["c"])


@pytest.mark.parametrize("deadline,cut", [(0.91, True), (0.97, True), (DEADLINE, False)])
def test_a_fixed_cost_per_call_still_ends_before_deadline_less_margin(deadline, cut):
    """40 ms a call on top of 10 ms a token: the fit separates the two, so
    the cut call (and so the typed expiry) ends before ``deadline -
    margin``, or a stream that even a one-token call would carry past it
    is evicted with no cut.  Seconds per token alone (each call's wall
    over its k) would spread the fixed cost over the tokens and charge a
    cut call too little."""
    r = _run("port", deadline=deadline, call_ms=40.0)
    _check_tokens(r)
    eng = r["engine"]
    (_, _, t), = r["evicted_at"]
    assert t < deadline - MARGIN + 1e-9
    assert (eng.deadline_cut_calls >= 1) == cut
    assert eng.decode_call_s(0) == pytest.approx(0.040)
    assert eng.decode_call_s(1) == pytest.approx(0.050)


def test_no_deadline_in_reach_cuts_nothing():
    """A deadline far beyond the run: no call is cut, and the port's
    chunks and tokens equal the JAX engine's exactly."""
    port, jax = _run("port", deadline=1e6), _run("jax", deadline=1e6)
    assert port["engine"].deadline_cut_calls == 0
    assert (port["a"], port["b"], port["c"]) == (jax["a"], jax["b"], jax["c"]) == port["oracle"]
    assert not port["evicted_at"] and not jax["evicted_at"]


@pytest.mark.parametrize("walls,now,want", [
    ({16: 0.16, 8: 0.08}, 0.0, 16), ({16: 0.16, 8: 0.08}, 0.905, 9),
    ({16: 0.16, 8: 0.08}, 0.955, 4), ({16: 0.16, 8: 0.08}, 0.995, 1),
    ({16: 0.20, 12: 0.16}, 0.76, 16), ({16: 0.20, 12: 0.16}, 0.80, 15),
    ({16: 0.20, 12: 0.16}, 0.905, 5),
    # one k measured: its whole wall may be fixed cost, so no shorter call
    # is reckoned to fit where the full call does not
    ({16: 0.16}, 0.84, 16), ({16: 0.16}, 0.905, 1),
], ids=["per-token-far", "per-token-9", "per-token-4", "per-token-1",
        "fixed-far", "fixed-15", "fixed-5", "one-k-fits", "one-k-no-cut"])
def test_deadline_k_arithmetic(walls, now, want):
    """k is the largest count whose reckoned call ``a + b*k`` ends by
    ``deadline - margin``, at least 1, at most the call's own k (lock held
    by the caller)."""
    eng = tslots.SlotEngine(tslots.SimSlotModel(1), max_seq=64, clock=lambda: now)
    eng.decode_call_wall = dict(walls)
    eng.submit(TFrame([], pts=0.0), np.arange(4, dtype=np.int32)[None], 8, 4,
               deadline_ts=DEADLINE)
    with eng._lock:
        assert eng._deadline_k(16, now) == want
