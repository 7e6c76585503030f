"""Port parity for the generator's per-stream SLOs (the slot engine's
``slo=`` hooks and the ``slo-*`` properties).

``SimSlotModel`` drives the port's ``SlotEngine`` and the JAX package's
through one script (every stream submitted before the pump starts, so the
schedule is deterministic): the outcome counts per tenant (good, expired,
evicted, shed), the TTFT and inter-token histogram counts and the
count-driven availability burn and status are equal; then the same
through ``tensor_generator custom=sim:1`` with the three ``slo-*``
properties armed, down to the ``nns.slo.*`` series a scrape carries.
Latency VALUES are timing, so bucket placement and the percentiles are
not compared.
"""

import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import slots as jslots
from nnstreamer_tpu.core import telemetry as jt
from nnstreamer_tpu.core.buffer import TensorFrame as JFrame
from nnstreamer_tpu.core.liveness import TENANT_META as J_TENANT
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core import slots as tslots
from nnstreamer_tpu_torch.core import telemetry as tt
from nnstreamer_tpu_torch.core.buffer import TensorFrame as TFrame
from nnstreamer_tpu_torch.core.liveness import TENANT_META
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse

torch.set_num_threads(2)

FAST = dict(step_base_ms=0.0, step_per_slot_ms=0.0, prefill_ms_per_token=0.0)
OBJECTIVES = dict(ttft_p95_s=5.0, token_p99_s=5.0, availability=0.9)
#: the count-driven fields of a snapshot row (the rest is timing)
COUNTED = ("good", "shed", "evicted", "expired", "errors", "availability",
           "availability_burn", "ttft_burn", "token_burn", "status")

PROMPTS = [list(range(1, 9)), list(range(20, 26)), list(range(40, 50)), [7, 7, 7, 7],
           list(range(3, 12)), [5] * 5]
TENANTS = ["a", "b", "a", "", "b", "a"]


def _engine_run(pkg: str, expire=(), cancel=(), max_new: int = 12, slots: int = 2):
    """Submit every prompt, cancel and expire some before the pump starts,
    drain until every stream ended; the tracker's snapshot and histogram
    counts."""
    mod, frame_cls, tel = ((tslots, TFrame, tt) if pkg == "port" else (jslots, JFrame, jt))
    slo = tel.SloTracker(**OBJECTIVES)
    model = mod.SimSlotModel(slots, **FAST)
    if pkg == "port":
        eng = mod.SlotEngine(model, max_seq=1 << 20, chunk=4, prefill_chunk=4, slo=slo)
    else:
        eng = mod.SlotEngine(model, None, max_seq=1 << 20, chunk=4, prefill_chunk=4,
                             resume_sig=None, slo=slo)
    streams = []
    for i, (p, tenant) in enumerate(zip(PROMPTS, TENANTS)):
        prompt = np.asarray(p, np.int32)[None]
        deadline = time.monotonic() - 1.0 if i in expire else None
        streams.append(eng.submit(frame_cls([prompt]), prompt, max_new=max_new, chunk=4,
                                  tenant=tenant, deadline_ts=deadline))
    for i in cancel:
        assert eng.cancel(sid=streams[i].sid)
    eng.start()
    try:
        deadline = time.monotonic() + 20
        while not eng.idle() and time.monotonic() < deadline:
            eng.pop_ready()
            time.sleep(0.002)
        assert eng.idle()
        time.sleep(0.05)  # the pump classifies a cancelled stream at its next boundary
        snap = slo.snapshot()
        hists = {(name, lb["tenant"]): h.count for name, h, lb in slo.hist_rows()}
    finally:
        eng.stop()
    return {t: {k: row[k] for k in COUNTED if k in row} for t, row in snap.items()}, hists


@pytest.mark.parametrize("expire,cancel", [((), ()), ((1,), ()), ((), (2, 3)), ((0, 5), (4,))],
                         ids=["all_good", "expired", "cancelled", "mixed"])
def test_engine_outcomes_and_histograms_equal_to_jax(expire, cancel):
    got = _engine_run("port", expire, cancel)
    want = _engine_run("jax", expire, cancel)
    assert got == want
    rows, hists = got
    assert sum(r["good"] for r in rows.values()) == len(PROMPTS) - len(expire) - len(cancel)
    assert sum(r["expired"] for r in rows.values()) == len(expire)
    assert sum(r["shed"] for r in rows.values()) == 0
    # one TTFT per stream that reached its first token, 11 inter-arrivals
    # per stream that decoded all 12 tokens
    ttft = sum(n for (name, _), n in hists.items() if name == "nns.slo.ttft_seconds")
    assert ttft == len(PROMPTS) - len(expire) - len(cancel)


def test_engine_without_slo_costs_nothing():
    model = tslots.SimSlotModel(2, **FAST)
    eng = tslots.SlotEngine(model, max_seq=1 << 20, chunk=4, prefill_chunk=4)
    assert eng.slo is None


# ---------------------------------------------------------------------------
# Through tensor_generator
# ---------------------------------------------------------------------------
SLO_PROPS = "slo-ttft-p95=5 slo-token-p99=5 slo-availability=0.9"


def _element_run(pkg: str, props: str = SLO_PROPS):
    parse, frame_cls, tenant_key = ((torch_parse, TFrame, TENANT_META) if pkg == "port"
                                    else (jax_parse, JFrame, J_TENANT))
    pipe = parse("appsrc name=src ! tensor_generator name=g custom=sim:1,vocab:101,"
                 f"sim_step_ms:0,sim_per_slot_ms:0,sim_prefill_ms:0 slots=2 max-new=12 chunk=4 "
                 f"{props} ! tensor_sink name=out", name="slo")
    pipe.start()
    try:
        for i, (p, tenant) in enumerate(zip(PROMPTS, TENANTS)):
            f = frame_cls([np.asarray(p, np.int32)], pts=float(i))
            f.meta[tenant_key] = tenant
            pipe["src"].push(f)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
        health = pipe.health()["g"]
        snap = pipe.metrics_snapshot()
    finally:
        pipe.stop()
    toks = {}
    for f in pipe["out"].frames:
        if f.tensors:
            toks.setdefault(f.pts, []).extend(np.asarray(f.tensors[0]).reshape(-1).tolist())
    slo = {t: {k: row[k] for k in COUNTED if k in row} for t, row in health.get("slo", {}).items()}
    series = {(s.name, s.labels.get("tenant")) for s in snap.samples
              if s.name.startswith("nns.slo.") and not s.name.endswith("_bucket")}
    counts = {(s.name, s.labels.get("tenant")): s.value for s in snap.samples
              if s.name.startswith("nns.slo.") and s.name.endswith("_count")}
    return toks, slo, series, counts, health


def test_generator_slo_properties_equal_to_jax():
    got = _element_run("port")
    want = _element_run("jax")
    assert got[0] == want[0]  # the tokens
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert sum(r["good"] for r in got[1].values()) == len(PROMPTS)
    assert ("nns.slo.status", "a") in got[2] and ("nns.slo.ttft_p95_ms", "_") in got[2]
    assert got[3][("nns.slo.ttft_seconds_count", "a")] == 3
    assert got[3][("nns.slo.token_seconds_count", "b")] == 2 * 11
    assert got[4]["gen_completed"] == len(PROMPTS)
    assert set(got[4]["threads"]) == {"g-slots"}


def test_generator_without_slo_props():
    toks, slo, series, _, health = _element_run("port", props="")
    armed = _element_run("port")
    assert toks == armed[0]  # the objectives change no token
    assert not slo and not series and "slo" not in health


def test_generator_slo_property_refusal_like_jax():
    errs = []
    for parse in (torch_parse, jax_parse):
        pipe = parse("appsrc name=src ! tensor_generator name=g custom=sim:1 slots=2 "
                     "slo-availability=1.0 ! tensor_sink name=out")
        with pytest.raises(Exception) as e:
            pipe.start()
        errs.append(f"{type(e.value).__name__}: {e.value}")
    assert errs[0] == errs[1] and "zero error budget" in errs[0]


def test_generator_slo_defaults_equal_to_jax():
    from nnstreamer_tpu.elements.generator import TensorGenerator as JGen
    from nnstreamer_tpu_torch.elements.generator import TensorGenerator

    for key in ("slo-ttft-p95", "slo-token-p99", "slo-availability"):
        assert TensorGenerator.PROPERTIES[key].default == JGen.PROPERTIES[key].default
