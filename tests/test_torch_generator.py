"""Port parity: ``tensor_generator`` and the slot engine against the JAX
package's, on the CPU.

Float32 with the JAX package's continuous-batching test config (vocab 61,
d_model 32, heads 2, layers 2, d_ff 64, seq 64, params seed 11).  The
port's element builds its model from the flax params converted by
``state_dict_from_flax`` (``lm_from_props`` substituted); the JAX element
builds the same params from the same seed.  Tokens and chunk meta per
stream must be equal; the engine's scheduling (priority joins, cancel,
deadline eviction) is checked on the port alone, its decode call held by
a gate so that the order of events is fixed.
"""

import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.core.liveness import DEADLINE_META
from nnstreamer_tpu_torch.core.slots import SlotEngine
from nnstreamer_tpu_torch.elements.generator import RESUME_REJECT_META, RESUME_REQ_META
from nnstreamer_tpu_torch.models import transformer as tr
from nnstreamer_tpu_torch.pipeline import make_element, parse_pipeline

torch.set_num_threads(2)

PROPS = {"dtype": "float32", "vocab": "61", "d_model": "32", "heads": "2", "layers": "2",
         "d_ff": "64", "seq": "64", "seed": "11"}
CUSTOM = ",".join(f"{k}:{v}" for k, v in PROPS.items())
N = 13


@pytest.fixture(scope="module")
def ref():
    """The JAX one-shot entry and the converted params; the port's element
    builds its transformer from them while the fixture lives."""
    gen_fn, params, _, _ = jax_build("transformer", dict(PROPS, generate=str(N)))
    sd = tr.state_dict_from_flax(params)
    build = tr.lm_from_props

    def lm_from_props(props, device="cpu"):
        lm = build(props, device)
        lm.load_state_dict(sd, strict=True)
        return lm

    with mock.patch.object(tr, "lm_from_props", lm_from_props):
        yield {"gen": gen_fn, "params": params, "lm": lm_from_props(PROPS)}


def _prompts(b, tp=7, seed=0):
    return np.random.default_rng(seed).integers(0, 61, (b, tp)).astype(np.int32)


def _oneshot(ref, prompt):
    return np.asarray(ref["gen"](ref["params"], [prompt])[0])[:, prompt.shape[1]:]


def _run(parse, extra, singles, block=None, max_new=N, accelerator="accelerator=cpu",
         custom=CUSTOM):
    """Push `singles` one by one (pts 0..), then `block` as one BatchFrame;
    returns the sink's frames grouped by pts, in arrival order."""
    pipe = parse(f"appsrc name=src ! tensor_generator name=g custom={custom} "
                 f"max-new={max_new} chunk=4 {extra} {accelerator} ! tensor_sink name=out")
    pipe.start()
    try:
        for i, p in enumerate(singles):
            pipe["src"].push(p, pts=float(i))
        if block is not None:
            pipe["src"].push_block(block, pts=[float(len(singles) + j) for j in range(len(block))])
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
    finally:
        pipe.stop()
    by = {}
    for f in pipe["out"].frames:
        by.setdefault(f.pts, []).append(f)
    return by


def _meta(frames):
    return [(f.meta["chunk_index"], f.meta["tokens_done"], f.meta["final"],
             np.asarray(f.tensors[0]).tolist()) for f in frames]


@pytest.mark.parametrize("slots", [0, 4])
def test_generator_matches_jax(ref, slots):
    """Five prompts one by one and a block of two: per stream the same
    chunks (tokens, chunk_index, tokens_done, final) as the JAX element,
    the tokens those of generate:<N>."""
    singles, block = _prompts(5), _prompts(2, seed=1)
    extra = f"slots={slots} prefill-chunk=3"
    want = _run(jax_parse, extra, singles, block, accelerator="")
    got = _run(parse_pipeline, extra, singles, block)
    assert sorted(got) == sorted(want) == [float(i) for i in range(7)]
    for pts in want:
        assert _meta(got[pts]) == _meta(want[pts])
        assert len({f.meta["stream_seq"] for f in got[pts]}) == 1
    oneshot = _oneshot(ref, np.concatenate([singles, block]))
    for i in range(7):
        toks = np.concatenate([f.tensors[0] for f in got[float(i)]], axis=1)
        np.testing.assert_array_equal(toks[0], oneshot[i])


@pytest.mark.parametrize("slots", [0, 4])
def test_max_new_zero_emits_nothing_as_jax(ref, slots):
    prompt = _prompts(1, seed=2)
    assert _run(jax_parse, f"slots={slots}", [prompt], max_new=0, accelerator="") == {}
    assert _run(parse_pipeline, f"slots={slots}", [prompt], max_new=0) == {}


@pytest.mark.parametrize("slots", [0, 4])
def test_resume_request_gets_the_typed_reject(ref, slots):
    frame = TensorFrame([_prompts(1, seed=3)], pts=0.0, meta={RESUME_REQ_META: {"sig": "x"}})
    by = _run(parse_pipeline, f"slots={slots}", [frame, _prompts(1, seed=3)])
    (reject,) = by[0.0]
    assert reject.tensors == [] and reject.meta["final"] is True
    assert RESUME_REJECT_META in reject.meta and reject.meta["tokens_done"] == 0
    assert by[1.0][-1].meta["tokens_done"] == N  # the other stream is served


@pytest.mark.parametrize("slots", [0, 4])
def test_overrun_fails_loud(ref, slots):
    with pytest.raises(Exception, match="exceeds the model's seq"):
        _run(parse_pipeline, f"slots={slots}", [_prompts(1, tp=60)], max_new=32)


def test_start_without_cuda_raises(ref):
    el = make_element("tensor_generator", custom=CUSTOM)
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            el.start()


@pytest.mark.parametrize("prop", ["mesh=tp:2", "prefix-cache=on", "custom=sim:1"])
def test_unported_options_raise(ref, prop):
    key, _, value = prop.partition("=")
    el = make_element("tensor_generator", accelerator="cpu", custom=CUSTOM)
    el.set_property(key, value)
    with pytest.raises(Exception, match="ROADMAP A(7|11)"):
        el.start()


@pytest.mark.parametrize("sampling", [{}, {"temperature": "0.8", "top_k": "7", "gen_seed": "3"}],
                         ids=["greedy", "sampling"])
def test_single_slotted_occupant_equals_one_shot(ref, sampling):
    """One stream in slot 2 of 4, decoded in calls of 5, 4 and 3."""
    kw = tr._sampling(sampling)
    prompt = torch.from_numpy(_prompts(1, seed=4))
    want = tr.GenerateLM(ref["lm"], N, **kw)(prompt)[0, 7:]
    if not sampling:
        np.testing.assert_array_equal(want.numpy(), _oneshot(ref, prompt.numpy())[0])
    model = tr.SlotModel(ref["lm"], 4, **kw)
    cache = model.reset_slot(model.init_cache(), 2)
    cache, logits = model.prefill_fn(7)(cache, prompt, 2)
    first = model.pick_first(logits)
    tok = torch.zeros(4, dtype=torch.int32)
    gen, active = torch.zeros_like(tok), torch.zeros_like(tok)
    tok[2], gen[2], active[2] = int(first[0]), 1, 1
    got = [first]
    for k in (5, 4, 3):
        cache, tok, gen, toks = model.decode_fn(k)(cache, tok, gen, active)
        got.append(toks[2])
    np.testing.assert_array_equal(torch.cat(got).numpy(), want.numpy())
    assert gen.tolist() == [0, 0, N, 0] and cache.pos.tolist() == [0, 0, 7 + N - 1, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neighbours_do_not_change_a_stream(ref, dtype):
    """ROADMAP C2: at a fixed width (slots=16), a greedy stream's tokens do
    not depend on its neighbours: one prompt alone equals the same prompt
    pushed sixth among 15 others of other lengths, in float32 and bf16."""
    custom = CUSTOM.replace("dtype:float32", f"dtype:{dtype}")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 61, (1, int(n))).astype(np.int32) for n in rng.integers(3, 21, 16)]
    extra = "slots=16 prefill-chunk=4"

    def tokens(frames):
        return np.concatenate([f.tensors[0] for f in frames], axis=1)[0]

    alone = _run(parse_pipeline, extra, [prompts[5]], custom=custom)
    among = _run(parse_pipeline, extra, prompts, custom=custom)
    assert sorted(among) == [float(i) for i in range(16)]
    np.testing.assert_array_equal(tokens(among[5.0]), tokens(alone[0.0]))
    assert len(tokens(alone[0.0])) == N


class _Gated:
    """A slot model whose decode calls wait for the test: ``entered`` is
    set when a call starts, ``gate`` lets it run."""

    def __init__(self, model):
        self._model = model
        self.entered = threading.Event()
        self.gate = threading.Event()

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_fn(self, k):
        fn = self._model.decode_fn(k)

        def gated(*args):
            self.entered.set()
            assert self.gate.wait(30)
            return fn(*args)

        return gated


def _engine(ref, slots, **kw):
    model = _Gated(tr.SlotModel(ref["lm"], slots))
    return SlotEngine(model, max_seq=64, chunk=4, prefill_chunk=32, **kw), model


def _drain(eng, until, timeout=30.0):
    out, end = [], time.monotonic() + timeout
    while not until(out):
        assert time.monotonic() < end, f"engine stuck; frames so far {len(out)}"
        eng.wait_progress(0.05)
        out += [f for _, f in eng.pop_ready()]
    return out


def _finals(frames):
    return [f.pts for f in frames if f.meta["final"]]


def test_priority_wins_a_free_slot(ref):
    """One slot, three waiting streams: the highest priority class joins
    first, then FIFO within what is left."""
    eng, model = _engine(ref, 1)
    model.gate.set()
    for pts, priority in ((0.0, 1), (1.0, 0), (2.0, 3)):
        eng.submit(TensorFrame([], pts=pts), _prompts(1, seed=int(pts)), 6, 4, priority=priority)
    eng.start()
    try:
        frames = _drain(eng, lambda out: len(_finals(out)) == 3)
    finally:
        eng.stop()
    assert _finals(frames) == [2.0, 0.0, 1.0]
    assert eng.snapshot()["gen_completed"] == 3 and eng.snapshot()["gen_joins"] == 3


def test_cancel_frees_the_slot(ref):
    eng, model = _engine(ref, 1)
    a = eng.submit(TensorFrame([], pts=0.0), _prompts(1), N, 4)
    eng.submit(TensorFrame([], pts=1.0), _prompts(1, seed=5), N, 4)
    eng.start()
    try:
        assert model.entered.wait(30)  # stream 0 holds the slot, mid-call
        assert eng.cancel(sid=a.sid) and not eng.cancel(sid=a.sid)
        model.gate.set()
        frames = _drain(eng, lambda out: 1.0 in _finals(out))
        assert eng.idle()
    finally:
        eng.stop()
    assert all(f.pts == 1.0 for f in frames)  # the cancelled stream emits nothing
    toks = np.concatenate([f.tensors[0] for f in frames], axis=1)
    np.testing.assert_array_equal(toks[0], _oneshot(ref, _prompts(1, seed=5))[0])
    snap = eng.snapshot()
    assert (snap["gen_cancelled"], snap["gen_completed"], snap["gen_occupied"]) == (1, 1, 0)


def test_deadline_eviction_has_the_typed_expiry(ref):
    now = [0.0]
    eng, model = _engine(ref, 2, clock=lambda: now[0])
    eng.submit(TensorFrame([], pts=0.0), _prompts(1), N, 4, deadline_ts=10.0)
    eng.submit(TensorFrame([], pts=1.0), _prompts(1, seed=6), N, 4)
    eng.start()
    try:
        assert model.entered.wait(30)  # first decode call: k = 4 for both
        now[0] = 10.0  # the deadline passes mid-call
        model.gate.set()
        frames = _drain(eng, lambda out: len(_finals(out)) == 2)
    finally:
        eng.stop()
    evicted = [f for f in frames if f.pts == 0.0]
    assert [f.meta["final"] for f in evicted] == [False, True]
    last = evicted[-1]
    assert last.meta["evicted"] == "deadline" and last.meta["deadline_expired"] is True
    assert last.meta["tokens_done"] == 5  # token 1 and the call's 4, kept
    kept = np.concatenate([f.tensors[0] for f in evicted], axis=1)[0]
    np.testing.assert_array_equal(kept, _oneshot(ref, _prompts(1))[0, :5])
    served = [f for f in frames if f.pts == 1.0]
    assert served[-1].meta["tokens_done"] == N and "evicted" not in served[-1].meta
    assert eng.snapshot()["gen_evicted"] == 1


def test_deadline_meta_reaches_the_engine(ref):
    """Through the element: a request whose deadline has passed is answered
    with a tensor-less typed-expiry final chunk."""
    frame = TensorFrame([_prompts(1)], pts=0.0, meta={DEADLINE_META: time.monotonic() - 1.0})
    by = _run(parse_pipeline, "slots=2", [frame])
    (last,) = by[0.0]
    assert last.tensors == [] and last.meta["final"] and last.meta["evicted"] == "deadline"
