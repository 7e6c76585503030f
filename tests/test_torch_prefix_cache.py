"""Port parity: the shared-prefix KV cache and the simulated slot model
(``core/continuity.py`` digests, ``core/slots.py`` ``PrefixCache`` and
``SimSlotModel``, ``models/transformer.py`` ``export_prefix`` /
``attach_prefix``, ``tensor_generator``'s ``prefix-*`` properties) against
the JAX package, on the CPU.

The contracts are those of ``tests/test_prefix_cache.py``: digests byte-equal
to the JAX package's; exact pool accounting, with pins spanning a stream's
slot occupancy; warm streams' tokens equal to cold runs' and to the JAX
one-shot ``generate:<N>``.  The chaos smoke and resume wait for ROADMAP A4.3
and A7.3.  Float32, a 2-layer, 64-wide transformer whose weights are the
JAX build's, converted.
"""

import time
from unittest import mock

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import continuity as jax_cont
from nnstreamer_tpu.core.slots import PrefixCache as JaxPrefixCache
from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu_torch.core import continuity as cont
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.core.slots import PrefixCache, SimSlotModel, SlotEngine
from nnstreamer_tpu_torch.models import transformer as tr
from nnstreamer_tpu_torch.pipeline import parse_pipeline

torch.set_num_threads(2)

PROPS = {"dtype": "float32", "vocab": "61", "d_model": "64", "heads": "2", "layers": "2",
         "d_ff": "128", "seq": "64", "seed": "11"}
CUSTOM = ",".join(f"{k}:{v}" for k, v in PROPS.items())
SAMPLING = {"temperature": "0.8", "top_k": "7", "gen_seed": "3"}
N = 8


@pytest.fixture(scope="module")
def ref():
    """The JAX params converted for the port's transformer (substituted for
    ``lm_from_props`` while the fixture lives) and the JAX one-shot path."""
    _, params, _, _ = jax_build("transformer", dict(PROPS, generate=str(N)))
    sd = tr.state_dict_from_flax(params)
    build = tr.lm_from_props
    cache = {}

    def lm_from_props(props, device="cpu"):
        lm = build(props, device)
        lm.load_state_dict(sd, strict=True)
        return lm

    def oneshot(prompt, extra=None):
        key = tuple(sorted((extra or {}).items()))
        if key not in cache:
            cache[key] = jax_build("transformer", dict(PROPS, generate=str(N), **(extra or {})))
        fn, p, _, _ = cache[key]
        return np.asarray(fn(p, [prompt])[0])[:, prompt.shape[1]:]

    with mock.patch.object(tr, "lm_from_props", lm_from_props):
        yield {"lm": lm_from_props, "oneshot": oneshot}


def _drain(eng, timeout=60.0):
    out, deadline = [], time.monotonic() + timeout
    while time.monotonic() < deadline:
        out.extend(f for _pad, f in eng.pop_ready())
        if out and any(f.meta.get("final") for f in out):
            return out
        eng.wait_progress(0.02)
    raise TimeoutError("engine drain timed out")


def _tokens(frames):
    frames = sorted(frames, key=lambda f: f.meta["chunk_index"])
    parts = [np.asarray(f.tensors[0]) for f in frames if f.tensors]
    return np.concatenate(parts, axis=1) if parts else np.zeros((1, 0), np.int32)


def sim_oracle(vocab, prompt, n):
    t = int(prompt.sum()) % vocab
    out = [t]
    for _ in range(n - 1):
        t = (31 * t + 17) % vocab
        out.append(t)
    return np.asarray([out], np.int32)


# -- digests ------------------------------------------------------------------

@pytest.mark.parametrize("tp,grain,declared", [(200, 64, 0), (300, 64, 200), (10, 64, 0),
                                               (129, 32, 96), (64, 8, 7)])
def test_digests_byte_equal_to_jax(tp, grain, declared):
    a = np.random.default_rng(tp).integers(0, 50257, (1, tp)).astype(np.int32)
    assert cont.prompt_digest(a) == jax_cont.prompt_digest(a)
    assert cont.prefix_digests(a, grain) == jax_cont.prefix_digests(a, grain)
    assert cont.prefix_digests(a[0], grain) == jax_cont.prefix_digests(a[0], grain)
    assert (cont.prefix_route_key(a, grain, declared)
            == jax_cont.prefix_route_key(a, grain, declared))
    assert cont.PREFIX_GRAIN == jax_cont.PREFIX_GRAIN


def test_digest_identifies_full_left_context():
    a = np.arange(200, dtype=np.int32)
    b = a.copy()
    b[70] = 7  # inside chunk 1
    da, db = cont.prefix_digests(a, 64), cont.prefix_digests(b, 64)
    assert len(da) == 3 and da[0] == db[0] and da[1] != db[1] and da[2] != db[2]
    assert set(cont.prefix_digests(a[:128], 64)).isdisjoint(cont.prefix_digests(a[:128], 32))


# -- the pool -----------------------------------------------------------------

def _both(fn):
    """`fn` on a port pool and on a JAX pool: equal results and snapshots."""
    got, want = fn(PrefixCache), fn(JaxPrefixCache)
    assert got == want
    return got


class TestPrefixCachePool:
    def test_publish_acquire_release_exact_accounting(self):
        def run(cls):
            pc = cls(grain=8)
            out = [pc.publish("d0", 0, {"x": 0}, 8), pc.publish("d1", 1, {"x": 1}, 8),
                   pc.publish("d0", 0, {"x": 9}, 8)]
            got = pc.acquire(["d0", "d1", "dMISSING"])
            out += [[e.digest for e in got], pc.snapshot(), pc.acquire(["dX"])]
            pc.release(got)
            return out + [pc.snapshot()]

        out = _both(run)
        assert out[:4] == [True, True, False, ["d0", "d1"]]
        assert out[4]["prefix_hits"] == 1 and out[4]["prefix_hit_tokens"] == 16
        assert out[4]["prefix_refs"] == 2 and out[6]["prefix_misses"] == 1
        assert out[6]["prefix_refs"] == 0

    def test_acquire_stops_at_first_gap(self):
        def run(cls):
            pc = cls(grain=8)
            pc.publish("d0", 0, {}, 8)
            pc.publish("d2", 2, {}, 8)
            got = pc.acquire(["d0", "dGAP", "d2"])
            pc.release(got)
            return [e.digest for e in got]

        assert _both(run) == ["d0"]

    def test_lru_eviction_skips_pinned_entries(self):
        def run(cls):
            pc = cls(grain=8, cap_entries=1)
            pc.publish("d0", 0, {}, 8)
            pinned = pc.acquire(["d0"])
            out = [pc.publish("d1", 0, {}, 8), pc.snapshot()["prefix_publishes"]]
            pc.release(pinned)
            out += [pc.publish("d1", 0, {}, 8), pc.snapshot(), pc.contains("d0"),
                    pc.contains("d1")]
            return out

        out = _both(run)
        assert out[:3] == [False, 1, True] and out[4:] == [False, True]
        assert out[3]["prefix_evictions"] == 1 and out[3]["prefix_entries"] == 1

    def test_trim_reclaims_only_unpinned(self):
        def run(cls):
            pc = cls(grain=8)
            for i in range(4):
                pc.publish(f"d{i}", i, {"carry": i, "n": 8}, 8)
            pinned = pc.acquire(["d0", "d1"])
            out = [pc.trim(), pc.contains("d0"), pc.contains("d1")]
            pc.release(pinned)
            return out + [pc.trim(), pc.snapshot()]

        out = _both(run)
        assert out[:4] == [2, True, True, 2]
        assert out[4]["prefix_entries"] == 0 and out[4]["prefix_evictions"] == 4

    def test_byte_cap_counts_tensor_bytes_and_clear(self):
        """Bytes are the pages' ``nbytes``: 80 for 20 int32, numpy or torch."""
        for big in (np.zeros(20, np.int32), torch.zeros(20, dtype=torch.int32)):
            pc = PrefixCache(grain=8, cap_bytes=100)
            pc.publish("d0", 0, {"p": big}, 8)
            pc.publish("d1", 0, {"p": big}, 8)  # over 100 B: d0 evicted
            snap = pc.snapshot()
            assert snap["prefix_entries"] == 1 and snap["prefix_evictions"] == 1
            assert snap["prefix_bytes"] == 80
            pc.clear()
            snap = pc.snapshot()
            assert snap["prefix_entries"] == 0 and snap["prefix_bytes"] == 0
            assert snap["prefix_evictions"] == 2

    def test_hot_digests_mru_order(self):
        def run(cls):
            pc = cls(grain=8)
            for i in range(3):
                pc.publish(f"d{i}", i, {}, 8)
            pc.release(pc.acquire(["d0"]))
            return pc.hot_digests()

        hot = _both(run)
        assert hot[0] == "d0" and len(hot) == 3


# -- the engine on the simulated model ------------------------------------------

def _sim_engine(pool, slots=1, step_ms=0.05):
    model = SimSlotModel(slots, step_base_ms=step_ms, prefill_ms_per_token=0.01)
    eng = SlotEngine(model, max_seq=1 << 20, chunk=4, prefill_chunk=4, prefix_cache=pool)
    eng.start()
    return eng, model


class TestEnginePrefix:
    def test_grain_off_prefill_grid_refused(self):
        with pytest.raises(ValueError, match="multiple"):
            SlotEngine(SimSlotModel(1), max_seq=64, prefill_chunk=4,
                       prefix_cache=PrefixCache(grain=6))

    def test_sim_tokens_follow_the_oracle_in_many_slots(self):
        eng, model = _sim_engine(None, slots=3)
        prompts = [np.arange(i, i + 5 + 3 * i, dtype=np.int32)[None] for i in range(5)]
        try:
            for p in prompts:
                eng.submit(TensorFrame([p]), p, 9, 4)
            got, deadline = {}, time.monotonic() + 60
            while sum(any(f.meta["final"] for f in v) for v in got.values()) < len(prompts):
                assert time.monotonic() < deadline, "engine drain timed out"
                for _pad, f in eng.pop_ready():
                    got.setdefault(f.meta["stream_seq"], []).append(f)
                eng.wait_progress(0.02)
        finally:
            eng.stop()
        by_sum = {int(p.sum()) % model.vocab: p for p in prompts}
        for frames in got.values():
            toks = _tokens(frames)
            np.testing.assert_array_equal(
                toks, sim_oracle(model.vocab, by_sum[int(toks[0, 0])], 9))

    def test_shared_prefix_hit_exact_counters_and_tokens(self):
        eng, model = _sim_engine(PrefixCache(grain=8))
        try:
            p1 = np.arange(17, dtype=np.int32)[None]
            p2 = p1.copy()
            p2[0, 16] = 55  # same 16-token prefix, another tail
            eng.submit(TensorFrame([p1]), p1, 9, 4)
            t1 = _tokens(_drain(eng))
            eng.submit(TensorFrame([p2]), p2, 9, 4)
            t2 = _tokens(_drain(eng))
            snap = eng.snapshot()
        finally:
            eng.stop()
        np.testing.assert_array_equal(t1, sim_oracle(model.vocab, p1, 9))
        np.testing.assert_array_equal(t2, sim_oracle(model.vocab, p2, 9))
        assert (snap["prefix_misses"], snap["prefix_hits"], snap["prefix_hit_tokens"]) == (1, 1, 16)
        assert (snap["prefix_publishes"], snap["prefix_entries"], snap["prefix_refs"]) == (2, 2, 0)

    def test_partial_prefix_hit_publishes_the_divergent_chunk(self):
        eng, model = _sim_engine(PrefixCache(grain=8))
        try:
            p1 = np.arange(17, dtype=np.int32)[None]
            p2 = p1.copy()
            p2[0, 12] = 55  # diverges inside chunk 1
            eng.submit(TensorFrame([p1]), p1, 6, 4)
            _drain(eng)
            eng.submit(TensorFrame([p2]), p2, 6, 4)
            t2 = _tokens(_drain(eng))
            snap = eng.snapshot()
        finally:
            eng.stop()
        np.testing.assert_array_equal(t2, sim_oracle(model.vocab, p2, 6))
        assert (snap["prefix_hits"], snap["prefix_hit_tokens"], snap["prefix_publishes"]) == (1, 8, 3)

    def test_short_prompt_neither_hit_nor_miss(self):
        eng, _ = _sim_engine(PrefixCache(grain=8))
        try:
            p = np.arange(8, dtype=np.int32)[None]  # (8 - 1) // 8 == 0 chunks
            eng.submit(TensorFrame([p]), p, 4, 4)
            _drain(eng)
            snap = eng.snapshot()
        finally:
            eng.stop()
        assert (snap["prefix_hits"], snap["prefix_misses"], snap["prefix_publishes"]) == (0, 0, 0)

    def test_pins_span_slot_occupancy_trim_cannot_reclaim(self):
        pool = PrefixCache(grain=8)
        eng, _ = _sim_engine(pool, step_ms=30.0)
        try:
            p1 = np.arange(17, dtype=np.int32)[None]
            eng.submit(TensorFrame([p1]), p1, 3, 4)
            _drain(eng)
            p2 = p1.copy()
            p2[0, 16] = 55
            eng.submit(TensorFrame([p2]), p2, 64, 4)
            deadline = time.monotonic() + 20
            while pool.snapshot()["prefix_refs"] == 0:
                assert time.monotonic() < deadline, "attach never pinned"
                time.sleep(0.005)
            assert pool.trim() == 0  # a live reader holds both entries
            assert pool.snapshot()["prefix_entries"] == 2
        finally:
            eng.stop()
        assert pool.snapshot()["prefix_refs"] == 0  # stop() released the pins

    def test_cache_off_snapshot_has_no_prefix_keys(self):
        eng, _ = _sim_engine(None)
        try:
            assert not any(k.startswith("prefix_") for k in eng.snapshot())
        finally:
            eng.stop()


# -- the transformer: warm hits give cold tokens ----------------------------------

def _zoo_engine(ref, pool, extra=None, slots=2):
    props = dict(PROPS, **(extra or {}))
    model = tr.SlotModel(ref["lm"](props), slots, **tr._sampling(props))
    eng = SlotEngine(model, max_seq=model.cfg.max_seq, chunk=4, prefill_chunk=4,
                     prefix_cache=pool)
    eng.start()
    return eng


@pytest.mark.parametrize("extra", [None, SAMPLING], ids=["greedy", "seeded-topk"])
def test_warm_hit_tokens_equal_cache_off_and_jax(ref, extra):
    rng = np.random.default_rng(5)
    p1 = rng.integers(0, 61, (1, 19)).astype(np.int32)
    p2 = p1.copy()
    p2[0, 17:] = (p2[0, 17:] + 9) % 61  # a shared 16-token prefix
    runs = {}
    for name, pool in (("on", PrefixCache(grain=8)), ("off", None)):
        eng = _zoo_engine(ref, pool, extra)
        try:
            toks = []
            for p in (p1, p2):
                eng.submit(TensorFrame([p]), p, N, 4)
                toks.append(_tokens(_drain(eng)))
            runs[name] = (toks, eng.snapshot())
        finally:
            eng.stop()
    for i, p in enumerate((p1, p2)):
        np.testing.assert_array_equal(runs["on"][0][i], runs["off"][0][i])
        np.testing.assert_array_equal(runs["on"][0][i], ref["oneshot"](p, extra))
    snap = runs["on"][1]
    assert (snap["prefix_hits"], snap["prefix_misses"], snap["prefix_hit_tokens"]) == (1, 1, 16)
    # two chunks of (layers, 8, heads, d/heads) float32 K and V pages
    assert snap["prefix_bytes"] == 2 * 2 * 2 * 8 * 64 * 4


def test_export_is_a_copy_and_attach_touches_only_its_slot(ref):
    """A published entry does not change when its slot decodes on, and an
    attach leaves every neighbour row and position as it was."""
    model = tr.SlotModel(ref["lm"](PROPS), 3)
    p0 = np.random.default_rng(6).integers(0, 61, (1, 9)).astype(np.int32)
    cache = model.reset_slot(model.init_cache(), 0)
    cache, _ = model.prefill_fn(9)(cache, torch.from_numpy(p0), 0)
    pages = model.export_prefix(cache, 0, 0, 8)
    kept = {k: v.clone() for k, v in pages.items()}
    cache = model.reset_slot(cache, 0)  # the slot's next stream overwrites its rows
    cache, _ = model.prefill_fn(9)(cache, torch.from_numpy((p0 + 1) % 61), 0)
    for k in pages:
        assert torch.equal(pages[k], kept[k])
    before = (cache.k[:, :2].clone(), cache.v[:, :2].clone(), cache.pos[:2].clone())
    cache = model.reset_slot(cache, 2)
    cache = model.attach_prefix(cache, 2, [pages], 8)
    for b, a in zip(before, (cache.k[:, :2], cache.v[:, :2], cache.pos[:2])):
        assert torch.equal(a, b)
    assert int(cache.pos[2]) == 8 and torch.equal(cache.k[:, 2, :8], pages["k"])
    assert not cache.k[:, 2, 8:].any()


# -- the element ---------------------------------------------------------------

def _pipeline(extra="", fuse=True, slots=1, custom=CUSTOM, accelerator="accelerator=cpu"):
    return parse_pipeline(
        f"appsrc name=src ! tensor_generator name=gen slots={slots} custom={custom} "
        f"max-new={N} chunk=4 prefill-chunk=4 {extra} {accelerator} ! tensor_sink name=out",
        fuse=fuse)


def _run(pipe, prompts):
    pipe.start()
    try:
        for p in prompts:
            pipe["src"].push(p)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
        snap = pipe["gen"]._engine.snapshot()
    finally:
        pipe.stop()
    by_seq = {}
    for f in pipe["out"].frames:
        by_seq.setdefault(f.meta["stream_seq"], []).append(f)
    return [_tokens(fs) for fs in by_seq.values()], snap


class TestElementWiring:
    @pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
    def test_pipeline_warm_hit_equal_to_jax_and_accounted(self, ref, fuse):
        rng = np.random.default_rng(7)
        p1 = rng.integers(0, 61, (1, 19)).astype(np.int32)
        p2 = p1.copy()
        p2[0, 18] = (p2[0, 18] + 1) % 61
        got, snap = _run(_pipeline("prefix-cache=on prefix-grain=8", fuse=fuse), [p1, p2])
        for p in (p1, p2):  # slots=1 serializes: p1 publishes, p2 hits
            assert any(np.array_equal(g, ref["oneshot"](p)) for g in got)
        assert (snap["prefix_hits"], snap["prefix_misses"], snap["prefix_hit_tokens"]) == (1, 1, 16)

    def test_cache_off_is_zero_change(self, ref):
        p = np.random.default_rng(8).integers(0, 61, (1, 19)).astype(np.int32)
        got, snap = _run(_pipeline(), [p])
        assert not any(k.startswith("prefix_") for k in snap)
        np.testing.assert_array_equal(got[0], ref["oneshot"](p))

    def test_grain_rounds_up_to_prefill_chunk_and_restart_is_cold(self, ref):
        pipe = _pipeline("prefix-cache=on prefix-grain=6")
        pipe.start()
        try:
            assert pipe["gen"]._prefix_pool.grain == 8  # 6 -> ceil to 8
            pipe["src"].end_of_stream()
            pipe.wait(timeout=60)
        finally:
            pipe.stop()
        assert pipe["gen"]._prefix_pool is None

    def test_sim_model_through_the_element_needs_no_card(self):
        """``custom=sim:1`` serves the oracle's tokens with the prefix cache
        on, even where no CUDA device exists and no accelerator is named."""
        p1 = np.arange(17, dtype=np.int32)[None]
        p2 = p1.copy()
        p2[0, 16] = 3
        with mock.patch.object(torch.cuda, "is_available", lambda: False):
            got, snap = _run(_pipeline("prefix-cache=on prefix-grain=8",
                                       custom="sim:1,vocab:101,sim_step_ms:0.05", accelerator=""),
                             [p1, p2])
        for p in (p1, p2):
            assert any(np.array_equal(g, sim_oracle(101, p, N)) for g in got)
        assert (snap["prefix_hits"], snap["prefix_publishes"]) == (1, 2)

    @pytest.mark.parametrize("knob", ["sim_oom_step", "sim_lost_step"])
    def test_sim_chaos_knobs_name_the_roadmap(self, knob):
        """The chaos knobs of ROADMAP A4.3 (ported): decode attempt 3
        raises the typed device error once and the engine recovers."""
        pipe = _pipeline(custom=f"sim:1,{knob}:3", extra="chunk=1")
        _, snap = _run(pipe, [np.arange(1, 9, dtype=np.int32)])
        finals = [f for f in pipe["out"].frames if f.meta["final"]]
        reason = "oom" if knob == "sim_oom_step" else "device_lost"
        assert [f.meta.get("evicted") for f in finals] == [reason]
        assert finals[0].meta["tokens_done"] == 4  # token 1, then attempts 0-2 (k = 1)
        if knob == "sim_oom_step":
            assert (snap["gen_oom_retries"], snap["gen_oom_sheds"]) == (1, 1)
        else:
            assert (snap["gen_device_lost"], snap["gen_device_lost_evicted"],
                    snap["gen_remeshes"]) == (1, 1, 1)
