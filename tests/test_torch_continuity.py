"""Port parity for stream continuity: the client's ledger, resume in the
slot engine, migration across the two packages, and the refusal of each
other's streams.

* The same chunk sequences through both packages' ``StreamContinuity``
  (plain chunks, a hand-off with overlap, a wholly duplicate chunk, a
  refusal, a gap): equal verdicts, equal emitted frames, and RESUME frames
  byte-equal on the wire (both framings);
* resume at every delivered count on ``SimSlotModel`` gives the oracle's
  suffix and the JAX engine's frames; on a 2-layer, 64-wide transformer
  whose weights come from the flax tree, resume at every chunk boundary
  (and one point between) gives the uninterrupted run's tokens, greedy and
  seeded top-k, and the greedy run equals the JAX package's ``generate``;
* a JAX client against two port servers, and a port client against two JAX
  servers, migrate a stream off a draining server with every token once,
  equal to the uninterrupted run;
* each package refuses the other's RESUME request (ROADMAP C4: the port
  signs with kinds of its own), counting one ``gen_resume_rejects``.
"""

import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import continuity as jc
from nnstreamer_tpu.core import slots as jslots
from nnstreamer_tpu.core.buffer import TensorFrame as JFrame
from nnstreamer_tpu.distributed import wire as jwire
from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core import continuity as tc
from nnstreamer_tpu_torch.core import slots as tslots
from nnstreamer_tpu_torch.core.buffer import TensorFrame as TFrame
from nnstreamer_tpu_torch.distributed import wire as twire
from nnstreamer_tpu_torch.models import transformer as tr
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse
from torch_census import module_leak_check  # noqa: F401

torch.set_num_threads(2)

PKG = {"jax": (jc, JFrame, jwire, jax_parse), "port": (tc, TFrame, twire, torch_parse)}
VOCAB, MAX_NEW = 997, 40


def sim_oracle(prompt, n, vocab=VOCAB):
    t = int(np.sum(prompt)) % vocab
    out = []
    for _ in range(n):
        out.append(t)
        t = (31 * t + 17) % vocab
    return out


def test_vocabulary_and_signature_are_the_jax_packages():
    for key in ("RESUME_META", "RESUME_REQ_META", "GOAWAY_META", "RESUME_REJECT_META"):
        assert getattr(tc, key) == getattr(jc, key)
    cfg = {"vocab": 61, "max_new": 12, "seed": "11"}
    assert tc.resume_signature("k", **cfg) == jc.resume_signature("k", **cfg)
    assert tc.resume_signature("k", **cfg) != tc.resume_signature("k2", **cfg)


# ---------------------------------------------------------------------------
# the client's ledger
# ---------------------------------------------------------------------------
PROMPT = np.array([[3, 1, 4, 1, 5]], np.int32)


def _chunk(pkg, toks, idx, done, final=False, goaway=False, reject=None, resumable=True):
    cont_mod, frame_cls = PKG[pkg][0], PKG[pkg][1]
    f = frame_cls([np.asarray(toks, np.int32)] if toks is not None else [], pts=1.0)
    f.meta.update(stream_seq=7, chunk_index=idx, tokens_done=done, final=final)
    if resumable:
        f.meta[cont_mod.RESUME_META] = {"v": 1, "sig": "S",
                                        "digest": cont_mod.prompt_digest(PROMPT), "chunk": 4}
    if goaway:
        f.meta[cont_mod.GOAWAY_META] = True
        f.meta["evicted"] = "goaway"
    if reject is not None:
        f.meta[cont_mod.RESUME_REJECT_META] = reject
    return f


SCRIPTS = {
    # a stream without resume state: untouched, no replay
    "plain": [([[1, 2, 3, 4]], 0, 4, False, False, None, False),
              ([[5, 6]], 1, 6, True, False, None, False)],
    # server A hands off at 10 tokens; B resumes at the boundary 8 and
    # re-decodes tokens 9-10 (dropped), then goes on to 16
    "handoff": [([[1, 2, 3, 4]], 0, 4, False, False, None, True),
                ([[5, 6, 7, 8]], 1, 8, False, False, None, True),
                ([[9, 10]], 2, 10, True, True, None, True),
                ([[9, 10, 11, 12]], 2, 12, False, False, None, True),
                ([[13, 14, 15, 16]], 3, 16, True, False, None, True)],
    # a chunk wholly at or below the delivered mark drops without an emit
    "duplicate": [([[1, 2, 3, 4]], 0, 4, False, False, None, True),
                  ([[1, 2, 3, 4]], 0, 4, False, False, None, True),
                  ([[5, 6, 7, 8]], 1, 8, True, False, None, True)],
    "reject": [([[1, 2, 3, 4]], 0, 4, False, True, None, True),
               (None, 0, 0, True, False, "model/sampling signature mismatch", True)],
    # a gap (tokens 5-8 never arrived): the ledger refuses to build a resume
    "gap": [([[1, 2, 3, 4]], 0, 4, False, False, None, True),
            ([[9, 10, 11, 12]], 2, 12, False, True, None, True)],
}


def _ledger_run(pkg, script):
    cont_mod, frame_cls, wire, _ = PKG[pkg]
    req = frame_cls([PROMPT], pts=1.0, meta={"tenant": "t", "priority": 2})
    cont = cont_mod.StreamContinuity(req)
    out = []
    for toks, idx, done, final, goaway, reject, resumable in script:
        v = cont.accept(_chunk(pkg, toks, idx, done, final, goaway, reject, resumable))
        emit = None
        if v.emit is not None:
            emit = ([np.asarray(t).tolist() for t in v.emit.tensors], dict(v.emit.meta))
        out.append((v.dup, v.handoff, v.finished, v.reject, emit, cont.take_handoff(),
                    cont.delivered, cont.resume_point(), cont.capable))
    try:
        rf = cont.build_resume_frame()
    except RuntimeError as e:
        return out, ("refused", str(e).split(":")[0]), cont.duplicates_dropped
    meta = dict(rf.meta)
    # the frame counter is each process's own: one value on both sides
    rf.seq = 11
    wires = [wire.encode_frame(rf, version=v) for v in (1, 2)]
    return out, ([np.asarray(t).tolist() for t in rf.tensors], meta, wires), \
        cont.duplicates_dropped


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_ledger_verdicts_frames_and_resume_wire_bytes_equal_jax(script):
    got = _ledger_run("port", SCRIPTS[script])
    want = _ledger_run("jax", SCRIPTS[script])
    assert got[0] == want[0]
    assert got[2] == want[2]
    if script == "plain":
        assert got[1][0] == "refused" and want[1][0] == "refused"
        return
    if script == "gap":
        assert got[1] == want[1] == ("refused", "resume ledger incoherent")
        return
    assert got[1][0] == want[1][0] and got[1][1] == want[1][1]
    assert got[1][2] == want[1][2]  # byte-equal on the wire, v1 and v2
    if script == "handoff":
        emitted = [t for step in got[0] if step[4] and step[4][0] for t in step[4][0][0][0]]
        assert emitted == list(range(1, 17)) and got[2] == 2
        assert [s[4][1]["chunk_index"] for s in got[0] if s[4]] == [0, 1, 2, 3, 4]


# ---------------------------------------------------------------------------
# resume in the slot engine
# ---------------------------------------------------------------------------
def _drain(eng, timeout=30.0):
    out = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out.extend(f for _, f in eng.pop_ready())
        if out and out[-1].meta.get("final"):
            return out
        eng.wait_progress(0.01)
    raise TimeoutError(f"no final chunk ({len(out)} frames)")


def _frames(frames):
    return [(np.asarray(f.tensors[0]).tolist() if f.tensors else [], f.meta["chunk_index"],
             f.meta["tokens_done"], f.meta["final"], f.meta["_nns_resume"]["digest"])
            for f in frames]


def _sim_run(pkg, prompt, max_new, chunk, resume=None):
    if pkg == "port":
        eng = tslots.SlotEngine(tslots.SimSlotModel(2, step_base_ms=0.0, step_per_slot_ms=0.0),
                                max_seq=1 << 20, chunk=chunk, resume_sig="SIG")
        frame = TFrame([prompt])
    else:
        eng = jslots.SlotEngine(jslots.SimSlotModel(2, step_base_ms=0.0, step_per_slot_ms=0.0),
                                None, max_seq=1 << 20, chunk=chunk, resume_sig="SIG")
        frame = JFrame([prompt])
    eng.start()
    try:
        eng.submit(frame, prompt, max_new, chunk, resume=resume)
        frames = _drain(eng)
        return frames, eng.snapshot()
    finally:
        eng.stop()


def test_sim_resume_at_every_point_equal_to_jax():
    prompt = np.arange(4, dtype=np.int32)[None]
    max_new, chunk = 16, 4
    oracle = np.asarray([sim_oracle(prompt, max_new)], np.int32)
    for r in range(1, max_new):
        resume = {"tokens_done": r, "prefix": oracle[:, :r]}
        got, snap = _sim_run("port", prompt, max_new, chunk, resume)
        want, _ = _sim_run("jax", prompt, max_new, chunk, resume)
        assert _frames(got) == _frames(want), r
        toks = [t for f in got for t in np.asarray(f.tensors[0])[0].tolist()]
        assert toks == oracle[0, r:].tolist(), r
        assert got[0].meta["chunk_index"] == r // chunk and got[-1].meta["tokens_done"] == max_new
        assert (snap["gen_resumes"], snap["gen_joins"]) == (1, 1)


LM_PROPS = {"dtype": "float32", "vocab": "61", "d_model": "64", "heads": "2", "layers": "2",
            "d_ff": "128", "seq": "64", "seed": "11"}
SAMPLING = {"temperature": "0.8", "top_k": "7", "gen_seed": "3"}
LM_NEW, LM_CHUNK = 12, 4


@pytest.fixture(scope="module")
def lm():
    """The JAX package's ``generate:12`` entry and the port's LM holding the
    same flax weights."""
    gen_fn, params, _, _ = jax_build("transformer", dict(LM_PROPS, generate=str(LM_NEW)))
    model = tr.lm_from_props(LM_PROPS)
    model.load_state_dict(tr.state_dict_from_flax(params), strict=True)
    return {"gen": gen_fn, "params": params, "lm": model}


def _lm_run(lm, sampling, prompt, resume=None, prefix_cache=None):
    model = tr.SlotModel(lm["lm"], 2, **tr._sampling(sampling))
    eng = tslots.SlotEngine(model, max_seq=64, chunk=LM_CHUNK, prefill_chunk=4, resume_sig="Z",
                            prefix_cache=prefix_cache)
    eng.start()
    try:
        eng.submit(TFrame([prompt]), prompt, LM_NEW, LM_CHUNK, resume=resume)
        return [t for f in _drain(eng) if f.tensors for t in np.asarray(f.tensors[0])[0].tolist()]
    finally:
        eng.stop()


@pytest.mark.parametrize("sampling", [{}, SAMPLING], ids=["greedy", "seeded-topk"])
def test_transformer_resume_at_every_boundary_is_bit_equal(lm, sampling):
    prompt = np.random.default_rng(5).integers(0, 61, (1, 6)).astype(np.int32)
    oracle = _lm_run(lm, sampling, prompt)
    assert len(oracle) == LM_NEW
    if not sampling:
        want = np.asarray(lm["gen"](lm["params"], [prompt[0]])[0])[prompt.shape[1]:]
        assert oracle == want.tolist()
    for r in (LM_CHUNK, 2 * LM_CHUNK, 6):
        pre = np.asarray([oracle[:r]], np.int32)
        got = _lm_run(lm, sampling, prompt, {"tokens_done": r, "prefix": pre})
        assert got == oracle[r:], r
    # a resume landing on a warm prefix cache attaches the prompt's pages
    # and decodes the same tokens
    pool = tslots.PrefixCache(grain=4)
    long_prompt = np.random.default_rng(6).integers(0, 61, (1, 13)).astype(np.int32)
    cold = _lm_run(lm, sampling, long_prompt, prefix_cache=pool)
    pre = np.asarray([cold[:LM_CHUNK]], np.int32)
    warm = _lm_run(lm, sampling, long_prompt, {"tokens_done": LM_CHUNK, "prefix": pre},
                   prefix_cache=pool)
    assert warm == cold[LM_CHUNK:] and pool.hits >= 1


# ---------------------------------------------------------------------------
# across the packages, over 127.0.0.1
# ---------------------------------------------------------------------------
def _gen_server(pkg, sid, max_new=MAX_NEW):
    parse = PKG[pkg][3]
    pipe = parse(f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 "
                 "connect-type=tcp ! tensor_generator name=gen slots=2 "
                 f"custom=sim:1,sim_step_ms:2,vocab:{VOCAB} max-new={max_new} chunk=4 ! "
                 f"tensor_query_serversink id={sid}", name=f"cont-{pkg}-{sid}")
    pipe.start()
    return pipe


def _client(pkg, ports, extra="", name="cont-cli"):
    parse = PKG[pkg][3]
    hosts = ",".join(f"127.0.0.1:{p}" for p in ports)
    pipe = parse(f"appsrc name=src ! tensor_query_client name=q connect-type=tcp hosts={hosts} "
                 f"stream=true timeout=30 retry-backoff=0.01 {extra} ! tensor_sink name=out",
                 name=name)
    pipe.start()
    return pipe


def _wait_frames(pipe, n=1, timeout=15.0):
    deadline = time.monotonic() + timeout
    while len(pipe["out"].frames) < n:
        assert time.monotonic() < deadline, "no chunk arrived"
        time.sleep(0.002)


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "port"), ("port", "jax")])
def test_drain_migrates_a_stream_across_packages(client_pkg, server_pkg):
    servers = [_gen_server(server_pkg, 1941), _gen_server(server_pkg, 1942)]
    ports = [s["ssrc"].props["port"] for s in servers]
    cl = _client(client_pkg, ports, name=f"cont-mig-{client_pkg}")
    try:
        prompt = np.arange(2, 8, dtype=np.int32)
        cl["src"].push(prompt)
        _wait_frames(cl)
        home = [s for s in servers if s.health()["gen"]["gen_joins"]]
        assert len(home) == 1
        home[0]["ssrc"].request_drain()
        cl["src"].end_of_stream()
        cl.wait(timeout=30)
        frames = list(cl["out"].frames)
        health = cl.health()["q"]
    finally:
        cl.stop()
        gens = [s.health()["gen"] for s in servers]
        for s in servers:
            s.stop()
    toks = [t for f in frames if f.tensors for t in np.asarray(f.tensors[0])[0].tolist()]
    assert toks == sim_oracle(prompt, MAX_NEW)
    assert [f.meta["chunk_index"] for f in frames] == list(range(len(frames)))
    assert [f.meta["final"] for f in frames] == [False] * (len(frames) - 1) + [True]
    assert (health["stream_migrations"], health["stream_resumes"],
            health["resume_failures"]) == (1, 0, 0)
    assert sorted(g["gen_goaway_evicted"] for g in gens) == [0, 1]
    assert sorted(g["gen_resumes"] for g in gens) == [0, 1]


@pytest.mark.parametrize("origin,other", [("jax", "port"), ("port", "jax")])
def test_each_package_refuses_the_others_resume(origin, other):
    """C4: a RESUME request built from one package's stream is refused by the
    other package's server with the typed chunk, counted once there."""
    src = _gen_server(origin, 1951)
    dst = _gen_server(other, 1952)
    try:
        assert src["gen"]._resume_sig != dst["gen"]._resume_sig
        cl = _client(origin, [src["ssrc"].props["port"]], name=f"cont-src-{origin}")
        prompt = np.arange(3, 9, dtype=np.int32)
        try:
            cl["src"].push(prompt)
            cl["src"].end_of_stream()
            cl.wait(timeout=30)
            chunks = list(cl["out"].frames)[:2]
        finally:
            cl.stop()
        cont_mod, frame_cls = PKG[origin][0], PKG[origin][1]
        cont = cont_mod.StreamContinuity(frame_cls([prompt[None]]))
        for f in chunks:  # the client's emitted chunks keep the resume state
            f.meta["final"] = False
            cont.accept(f)
        req = cont.build_resume_frame()
        assert req.meta[cont_mod.RESUME_REQ_META]["tokens_done"] == 8
        assert dst.health()["gen"]["gen_resume_rejects"] == 0
        cl = _client(origin, [dst["ssrc"].props["port"]], name=f"cont-dst-{origin}")
        try:
            cl["src"].push(req)
            cl["src"].end_of_stream()
            with pytest.raises(Exception):
                cl.wait(timeout=30)
            failures = cl.health()["q"]["resume_failures"]
        finally:
            cl.stop()
        assert dst.health()["gen"]["gen_resume_rejects"] == 1 and failures == 0
    finally:
        src.stop()
        dst.stop()
