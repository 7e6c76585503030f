"""Port parity for the slot engine's device-resource resilience.

``SimSlotModel``'s chaos twins (``oom_at_step``, ``lost_at_step``,
``fail_next``) drive the port's ``SlotEngine`` and the JAX package's, both
with a resume signature, through the same script: the shed stream, every
stream's tokens and chunk meta (the resume state on every chunk and the
``goaway`` marker on a shed or handed-off stream's resumable final chunk
among them), and the counters are equal,
with the shared-prefix cache on as well (the JAX package's chaos smoke,
``tests/test_prefix_cache.py:517``, needs the query fleet; its in-process
part is held here), and through ``tensor_generator custom=sim:1`` with the
``sim_oom_step`` / ``sim_lost_step`` knobs.
"""

import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import resilience as jres
from nnstreamer_tpu.core import slots as jslots
from nnstreamer_tpu.core.buffer import TensorFrame as JFrame
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core import resilience as tres
from nnstreamer_tpu_torch.core import slots as tslots
from nnstreamer_tpu_torch.core.buffer import TensorFrame as TFrame
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse

torch.set_num_threads(2)

FAST = dict(step_base_ms=0.0, step_per_slot_ms=0.0, prefill_ms_per_token=0.0)


def _engine(pkg, slots, model_kw, engine_kw):
    if pkg == "port":
        model = tslots.SimSlotModel(slots, **FAST, **model_kw)
        return tslots.SlotEngine(model, max_seq=1 << 20, chunk=4, prefill_chunk=4,
                                 resume_sig="SIG", **engine_kw)
    model = jslots.SimSlotModel(slots, **FAST, **model_kw)
    return jslots.SlotEngine(model, None, max_seq=1 << 20, chunk=4, prefill_chunk=4,
                             resume_sig="SIG", **engine_kw)


def _run_engine(pkg, prompts, priorities, slots=2, model_kw=None, engine_kw=None, max_new=24,
                arm=None, timeout=20.0, until_error=False):
    """Submit every prompt before the pump starts (a deterministic
    schedule), drain until every stream ended; returns per stream its
    chunks (tokens, chunk_index, tokens_done, final, evicted, deadline
    marker, goaway marker, resume state), the snapshot and the pump error's
    type, if any."""
    frame_cls = TFrame if pkg == "port" else JFrame
    eng = _engine(pkg, slots, model_kw or {}, engine_kw or {})
    streams = []
    for p, pri in zip(prompts, priorities):
        prompt = np.asarray(p, np.int32)[None]
        streams.append(eng.submit(frame_cls([prompt]), prompt, max_new=max_new, chunk=4,
                                  priority=pri))
    seqs = [s.frame.seq for s in streams]
    if arm is not None:
        arm(eng)
    eng.start()
    out, err = [], None
    try:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                out.extend(eng.pop_ready())
            except Exception as e:  # noqa: BLE001 — a sticky pump error is compared
                err = type(e).__name__
                break
            finals = {f.meta["stream_seq"] for _, f in out if f.meta.get("final")}
            if set(seqs) <= finals and not until_error:
                break
            time.sleep(0.002)
        snap = eng.snapshot()
    finally:
        eng.stop()
    by = []
    for sq in seqs:
        by.append([(np.asarray(f.tensors[0]).tolist() if f.tensors else [],
                    f.meta["chunk_index"], f.meta["tokens_done"], f.meta["final"],
                    f.meta.get("evicted"), "deadline_expired" in f.meta,
                    f.meta.get("goaway"), f.meta.get("_nns_resume"))
                   for _, f in out if f.meta["stream_seq"] == sq])
    return by, snap, err


SNAP_KEYS = ("gen_joins", "gen_completed", "gen_evicted", "gen_tokens", "gen_decode_steps",
             "gen_prefill_chunks", "gen_oom_retries", "gen_oom_sheds", "gen_device_lost",
             "gen_device_lost_evicted", "gen_remeshes")

PROMPTS = [list(range(1, 9)), list(range(20, 26)), list(range(40, 50)), [7, 7, 7, 7]]


def _oracle(prompt, n, vocab=997):
    t = int(np.sum(prompt)) % vocab
    toks = [t]
    for _ in range(n - 1):
        t = (31 * t + 17) % vocab
        toks.append(t)
    return toks


@pytest.mark.parametrize("step", [0, 2, 5])
@pytest.mark.parametrize("priorities", [(0, 3, 1, 2), (3, 3, 3, 3), (2, 0, 3, 1)],
                         ids=["mixed", "equal", "other"])
def test_oom_sheds_the_lowest_priority_equal_to_jax(step, priorities):
    got = _run_engine("port", PROMPTS, priorities, model_kw={"oom_at_step": step})
    want = _run_engine("jax", PROMPTS, priorities, model_kw={"oom_at_step": step})
    assert got[0] == want[0] and got[2] is want[2] is None
    assert {k: got[1][k] for k in SNAP_KEYS} == {k: want[1][k] for k in SNAP_KEYS}
    assert (got[1]["gen_oom_retries"], got[1]["gen_oom_sheds"]) == (1, 1)
    shed = [i for i, chunks in enumerate(got[0]) if chunks[-1][4] == "oom"]
    assert len(shed) == 1
    for i, chunks in enumerate(got[0]):
        toks = [t for c in chunks for t in (c[0][0] if c[0] else [])]
        want_toks = _oracle(PROMPTS[i], 24)
        assert toks == want_toks[:len(toks)] and chunks[-1][3]
        assert not any(c[5] for c in chunks)  # a shed is no deadline expiry
        # every chunk carries the resume state; only the shed stream's final
        # chunk is a resumable hand-off
        assert all(c[7]["sig"] == "SIG" for c in chunks)
        assert [c[6] for c in chunks] == [None] * (len(chunks) - 1) + [
            True if i in shed else None]
        if i not in shed:
            assert toks == want_toks


def test_device_loss_hands_off_every_live_stream_equal_to_jax():
    hook = {"engine_kw": {"on_device_lost": lambda e: None}}
    got = _run_engine("port", PROMPTS, (3, 3, 3, 3), model_kw={"lost_at_step": 1}, **hook)
    want = _run_engine("jax", PROMPTS, (3, 3, 3, 3), model_kw={"lost_at_step": 1}, **hook)
    assert got[0] == want[0] and got[2] is want[2] is None
    assert {k: got[1][k] for k in SNAP_KEYS} == {k: want[1][k] for k in SNAP_KEYS}
    # every live stream, the waiting ones included, is handed off
    assert (got[1]["gen_device_lost"], got[1]["gen_device_lost_evicted"],
            got[1]["gen_remeshes"]) == (1, 4, 1)
    assert [chunks[-1][4] for chunks in got[0]] == ["device_lost"] * 4
    assert [chunks[-1][6] for chunks in got[0]] == [True] * 4  # resumable hand-offs


def test_device_loss_without_a_hook_is_sticky_like_jax():
    got = _run_engine("port", PROMPTS[:1], (3,), model_kw={"lost_at_step": 0},
                      until_error=True)
    want = _run_engine("jax", PROMPTS[:1], (3,), model_kw={"lost_at_step": 0},
                       until_error=True)
    assert got[2] == want[2] == "DeviceLostError"
    assert got[0] == want[0]


def test_fail_next_and_prefill_oom_equal_to_jax():
    """``fail_next`` armed before the first decode attempt, and an OOM
    raised at a prefill piece through the ``device.oom`` site (prefill is
    re-entrant: the piece re-runs)."""
    def arm_next(eng):
        eng.model.fail_next("oom")

    got = _run_engine("port", PROMPTS, (1, 2, 0, 3), arm=arm_next)
    want = _run_engine("jax", PROMPTS, (1, 2, 0, 3), arm=arm_next)
    assert got[0] == want[0] and got[1]["gen_oom_sheds"] == want[1]["gen_oom_sheds"] == 1
    with pytest.raises(ValueError):
        tslots.SimSlotModel(1).fail_next("hang")

    def arm_site(mod):
        return lambda eng: mod.FAULTS.arm("device.oom", exc=mod.DeviceOomError, times=1,
                                          after=1)

    try:
        got = _run_engine("port", PROMPTS, (3, 0, 3, 3), arm=arm_site(tres))
        want = _run_engine("jax", PROMPTS, (3, 0, 3, 3), arm=arm_site(jres))
    finally:
        tres.FAULTS.reset()
        jres.FAULTS.reset()
    assert got[0] == want[0]
    assert {k: got[1][k] for k in SNAP_KEYS} == {k: want[1][k] for k in SNAP_KEYS}


def test_prefix_cache_chaos_equal_to_jax():
    """Prompts sharing a 16-token prefix with the shared-prefix cache on
    (grain 8), an OOM shed mid-run: hits, misses, publishes, every
    stream's tokens and the shed equal to the JAX engine's."""
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, 997, 16).tolist()
    prompts = [prefix + rng.integers(0, 997, n).tolist() for n in (5, 9, 3, 12, 6)]

    def run(pkg):
        mod = tslots if pkg == "port" else jslots
        return _run_engine(pkg, prompts, (3, 1, 3, 0, 2), slots=2,
                           model_kw={"oom_at_step": 4},
                           engine_kw={"prefix_cache": mod.PrefixCache(grain=8)})

    got, want = run("port"), run("jax")
    assert got[0] == want[0]
    keys = SNAP_KEYS + ("prefix_hits", "prefix_misses", "prefix_publishes", "prefix_entries")
    assert {k: got[1][k] for k in keys} == {k: want[1][k] for k in keys}
    assert got[1]["prefix_hits"] > 0 and got[1]["gen_oom_sheds"] == 1


@pytest.mark.parametrize("knob,reason", [("sim_oom_step:3", "oom"),
                                         ("sim_lost_step:3", "device_lost")])
@pytest.mark.parametrize("which", ["port", "jax"])
def test_generator_chaos_knobs_hold_like_jax(knob, reason, which):
    """Through ``tensor_generator custom=sim:1`` in each package (prompts
    arrive while the pump runs, so the schedule is the threads', not a
    script's): every stream ends with one final chunk, its tokens a prefix
    of the oracle's, and at least one ends typed with the fault's reason;
    the others run whole."""
    def run(parse):
        pipe = parse(f"appsrc name=src ! tensor_generator name=g slots=2 custom=sim:1,{knob},"
                     "sim_step_ms:0,sim_per_slot_ms:0,sim_prefill_ms:0 max-new=12 chunk=4 "
                     "prefill-chunk=4 ! tensor_sink name=out")
        pipe.start()
        try:
            for i, p in enumerate(PROMPTS):
                pipe["src"].push(np.asarray(p, np.int32), pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=30)
        finally:
            pipe.stop()
        by = {}
        for f in pipe["out"].frames:
            by.setdefault(f.pts, []).append(
                (np.asarray(f.tensors[0]).tolist() if f.tensors else [], f.meta["final"],
                 f.meta.get("evicted")))
        return by

    got = run(torch_parse if which == "port" else jax_parse)
    assert sorted(got) == [float(i) for i in range(len(PROMPTS))]
    for i, chunks in got.items():
        toks = [t for c in chunks for t in (c[0][0] if c[0] else [])]
        assert [c[1] for c in chunks] == [False] * (len(chunks) - 1) + [True]
        assert toks == _oracle(PROMPTS[int(i)], 12)[:len(toks)]
        assert chunks[-1][2] in (None, reason) and (chunks[-1][2] or len(toks) == 12)
    assert any(chunks[-1][2] == reason for chunks in got.values())


# ---------------------------------------------------------------------------
# a real SlotModel: the cache is written in place, so a step that ran and
# then failed must leave the write positions as they were before it
# ---------------------------------------------------------------------------
LM_PROPS = {"dtype": "float32", "vocab": "61", "d_model": "32", "heads": "2", "layers": "2",
            "d_ff": "64", "seq": "64", "seed": "11"}


class _RunsThenFails:
    """A real slot model whose decode call (or prefill piece) number ``at``
    runs on the cache, advancing its positions in place, and then raises
    ``DeviceOomError``, as an allocation failing after the step's writes
    would."""

    def __init__(self, model, where, at):
        self._model, self._where, self._at = model, where, at
        self.calls = {"decode": 0, "prefill": 0}
        self.moved = None

    def __getattr__(self, name):
        return getattr(self._model, name)

    def _step(self, kind, fn, cache, *args):
        self.calls[kind] += 1
        if kind != self._where or self.calls[kind] != self._at:
            return fn(cache, *args)
        before = cache.pos.clone()
        fn(cache, *args)
        self.moved = not torch.equal(cache.pos, before)
        raise tres.DeviceOomError(f"injected after {kind} call {self._at} ran")

    def decode_fn(self, k):
        fn = self._model.decode_fn(k)
        return lambda *args: self._step("decode", fn, *args)

    def prefill_fn(self, n):
        fn = self._model.prefill_fn(n)
        return lambda *args: self._step("prefill", fn, *args)


def _lm_streams(fault=None, max_new=12):
    from nnstreamer_tpu_torch.models import transformer as tr

    model = tr.SlotModel(tr.lm_from_props(LM_PROPS), 3)
    if fault is not None:
        model = _RunsThenFails(model, *fault)
    eng = tslots.SlotEngine(model, max_seq=64, chunk=4, prefill_chunk=4)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 61, (1, n)).astype(np.int32) for n in (9, 6, 11, 7, 5)]
    streams = [eng.submit(TFrame([p]), p, max_new=max_new, chunk=4, priority=pri)
               for p, pri in zip(prompts, (2, 0, 3, 1, 2))]
    seqs = [s.frame.seq for s in streams]
    eng.start()
    out = []
    try:
        deadline = time.monotonic() + 30
        while {f.meta["stream_seq"] for _, f in out if f.meta["final"]} < set(seqs):
            assert time.monotonic() < deadline, "engine stuck"
            eng.wait_progress(0.05)
            out += eng.pop_ready()
        snap = eng.snapshot()
    finally:
        eng.stop()
    by = []
    for sq in seqs:
        chunks = [f for _, f in out if f.meta["stream_seq"] == sq]
        toks = [t for f in chunks if f.tensors for t in np.asarray(f.tensors[0])[0].tolist()]
        by.append((toks, chunks[-1].meta.get("evicted")))
    return by, snap, model


@pytest.mark.parametrize("fault", [("decode", 3), ("prefill", 2), ("prefill", 5)],
                         ids=["decode-3", "prefill-2", "prefill-5"])
def test_failed_step_on_a_real_lm_restores_positions(fault):
    """Greedy streams of a tiny LM through three slots: the step that ran
    and then failed advanced the cache positions; after the shed, every
    unshed stream's tokens equal the fault-free run's and the shed one's
    are a prefix of them."""
    clean, _, _ = _lm_streams()
    got, snap, model = _lm_streams(fault)
    assert model.moved, "the failing step never wrote the cache"
    assert (snap["gen_oom_retries"], snap["gen_oom_sheds"]) == (1, 1)
    shed = [i for i, (_, why) in enumerate(got) if why == "oom"]
    assert len(shed) == 1 and all(why is None for _, why in clean)
    for i, ((toks, _), (want, _)) in enumerate(zip(got, clean)):
        assert len(want) == 12
        if i in shed:
            assert toks == want[:len(toks)] and len(toks) < 12
        else:
            assert toks == want
