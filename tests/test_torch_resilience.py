"""Port parity for ``core/resilience.py`` and the supervision it drives.

The port's classification of torch and CUDA errors (its own marker
strings, pinned here), ``RetryPolicy`` and ``CircuitBreaker`` on a fake
clock against the JAX package's, ``FAULTS`` plans firing at the same call
indices as the JAX package's, the error-policy truth table on
``framework=scaler`` with ``health()`` equal to the JAX pipeline's under
the same fault plan, and the filter's OOM and device-loss ladder on a
small MobileNet-v2 (``accelerator=cpu``) against the unfaulted run and the
JAX pipeline.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.core import resilience as jres
from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.core import resilience as tres
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models.mobilenet_v2 import state_dict_from_flax
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse

from torch_parity import randomized_batchnorm

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    jres.FAULTS.reset()
    tres.FAULTS.reset()


class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


# ---------------------------------------------------------------------------
# classification: torch's errors, pinned marker strings
# ---------------------------------------------------------------------------
OOM_MESSAGES = [
    "CUDA out of memory. Tried to allocate 20.00 MiB (GPU 0; 79.11 GiB total capacity)",
    "CUDA error: out of memory",
    "CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`",
    "cuDNN error: CUDNN_STATUS_ALLOC_FAILED",
    "top1: CUDA error 2 at launch: out of memory",  # the port's own kernels (ops/_build.py)
    "CUDA driver error: cudaErrorMemoryAllocation",
]
LOST_MESSAGES = [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: misaligned address",
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: device-side assert triggered",
    "CUDA error: the launch timed out and was terminated",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: hardware stack error",
    "int8_conv: CUDA error 700 at launch: an illegal memory access was encountered",
]


def test_torch_out_of_memory_error_is_typed_oom():
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    typed = tres.classify_device_error(err)
    assert isinstance(typed, tres.DeviceOomError) and typed.__cause__ is err


@pytest.mark.parametrize("msg", OOM_MESSAGES)
def test_runtime_error_allocation_failures_are_oom(msg):
    assert isinstance(tres.classify_device_error(RuntimeError(msg)), tres.DeviceOomError)


@pytest.mark.parametrize("msg", LOST_MESSAGES)
def test_sticky_cuda_errors_are_device_lost(msg):
    typed = tres.classify_device_error(RuntimeError(msg))
    assert isinstance(typed, tres.DeviceLostError) and typed.device_ids == ()


@pytest.mark.parametrize("err", [
    RuntimeError("out of memory"),            # no CUDA context in the text
    RuntimeError("CUDA error: invalid argument"),
    ValueError("CUDA out of memory"),         # not a RuntimeError
    TimeoutError("an illegal memory access was encountered"),
])
def test_unrelated_errors_are_not_classified(err):
    assert tres.classify_device_error(err) is None


def test_typed_errors_pass_through_and_are_transient():
    oom, lost = tres.DeviceOomError("x"), tres.DeviceLostError("y", device_ids=(1,))
    assert tres.classify_device_error(oom) is oom
    assert tres.classify_device_error(lost) is lost
    assert tres.is_transient(oom) and tres.is_transient(lost)
    assert jres.is_transient(jres.DeviceOomError("x")) and jres.is_transient(
        jres.DeviceLostError("y"))


def test_device_call_types_raw_errors_and_fires_sites_only_with_inject():
    def boom():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(tres.DeviceLostError) as info:
        tres.device_call(boom)
    assert isinstance(info.value.__cause__, RuntimeError)
    with pytest.raises(ValueError):
        tres.device_call(lambda: (_ for _ in ()).throw(ValueError("bad")))
    tres.FAULTS.arm("device.oom", exc=tres.DeviceOomError, times=1)
    assert tres.device_call(lambda: 7, inject=False) == 7  # the site does not fire
    with pytest.raises(tres.DeviceOomError):
        tres.device_call(lambda: 7)
    assert tres.device_call(lambda: 8) == 8


@pytest.mark.parametrize("make", [
    lambda m: ConnectionError("x"), lambda m: TimeoutError("x"), lambda m: OSError("x"),
    lambda m: ValueError("x"), lambda m: KeyError("x"), lambda m: NotImplementedError("x"),
    lambda m: RuntimeError("x"), lambda m: m.TransientError("x"), lambda m: m.FatalError("x"),
    lambda m: KeyboardInterrupt(), lambda m: m.RemoteApplicationError("x"),
], ids=["conn", "timeout", "oserror", "value", "key", "notimpl", "runtime", "transient",
        "fatal", "kbint", "remote"])
def test_is_transient_equal_to_jax(make):
    assert tres.is_transient(make(tres)) == jres.is_transient(make(jres))
    assert tres.is_remote_application_error(make(tres)) == jres.is_remote_application_error(
        make(jres))


# ---------------------------------------------------------------------------
# RetryPolicy and CircuitBreaker on a fake clock, against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(max_attempts=5, base_delay_s=0.05, multiplier=2.0, max_delay_s=0.15, jitter=0.0),
    dict(jitter=0.5, seed=42), dict(jitter=0.25, seed=7, base_delay_s=0.2, max_delay_s=1.0),
])
def test_retry_delays_equal_to_jax(kw):
    a, b = tres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
    assert [a.delay_for(k) for k in range(1, 8)] == [b.delay_for(k) for k in range(1, 8)]


@pytest.mark.parametrize("script", [
    ["conn", "conn", "ok"], ["value"], ["timeout"] * 5, ["slow"] * 10,
], ids=["until-ok", "fatal", "exhausted", "deadline"])
def test_retry_call_equal_to_jax(script):
    def run(mod):
        clk, calls, seen = FakeClock(), [], []

        def fn():
            i = len(calls)
            calls.append(i)
            kind = script[min(i, len(script) - 1)]
            if kind == "ok":
                return "ok"
            if kind == "slow":
                clk.t += 0.4
                raise TimeoutError("slow")
            raise {"conn": ConnectionError, "value": ValueError, "timeout": TimeoutError}[kind](
                kind)

        p = mod.RetryPolicy(max_attempts=5, base_delay_s=0.1, jitter=0.0,
                            deadline_s=1.0 if script[0] == "slow" else None)
        try:
            out = p.call(fn, sleep=clk.sleep, clock=clk,
                         on_retry=lambda a, e, d: seen.append((a, type(e).__name__, d)))
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            out = type(e).__name__
        return out, len(calls), clk.sleeps, seen

    assert run(tres) == run(jres)


def test_circuit_breaker_equal_to_jax():
    """One event script through both breakers: states, allow answers,
    trips and snapshots step for step."""
    script = (["fail"] * 3 + ["allow", "tick:1", "allow", "tick:5", "allow", "fail", "allow",
                              "tick:6", "allow", "ok", "allow"]
              + ["fail", "tick:40", "fail", "fail", "fail", "snap"])

    def run(mod):
        clk = FakeClock()
        trips = []
        br = mod.CircuitBreaker(failure_threshold=3, window_s=30.0, reset_timeout_s=5.0,
                                clock=clk, name="b", on_trip=lambda b: trips.append(clk.t))
        out = []
        for ev in script:
            if ev == "fail":
                br.record_failure()
            elif ev == "ok":
                br.record_success()
            elif ev == "allow":
                out.append(br.allow())
            elif ev.startswith("tick:"):
                clk.t += float(ev[5:])
            else:
                out.append(br.snapshot())
            out.append(br.state)
        return out, trips, br.trip_count

    assert run(tres) == run(jres)


# ---------------------------------------------------------------------------
# FAULTS: the same plan fires at the same call indices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(rate=0.3, seed=7), dict(rate=0.5, seed=11, times=9), dict(every=4, after=3),
    dict(every=2, times=3), dict(after=5, times=2), dict(rate=0.1, seed=0, after=20),
], ids=["rate", "rate-times", "every-after", "every-times", "after-times", "rate-after"])
def test_fault_plans_fire_at_the_same_indices(kw):
    def fired(mod):
        mod.FAULTS.arm("site.x", exc=ConnectionResetError, **kw)
        hits = []
        for i in range(200):
            try:
                mod.FAULTS.check("site.x")
            except ConnectionResetError:
                hits.append(i)
        return hits, mod.FAULTS.stats("site.x")

    got, want = fired(tres), fired(jres)
    assert got == want and got[0]


def test_fault_callback_delay_and_reset_equal_to_jax():
    for mod in (tres, jres):
        mod.FAULTS.arm("site.cb", callback=lambda i: ValueError(i) if i % 3 == 1 else None)
        hits = []
        for i in range(9):
            try:
                mod.FAULTS.check("site.cb")
            except ValueError as e:
                hits.append(e.args[0])
        assert hits == [1, 4, 7]
        mod.FAULTS.arm("site.d", delay=0.001, times=1)
        mod.FAULTS.check("site.d")  # latency only, no raise
        assert mod.FAULTS.armed_sites() == ["site.cb", "site.d"]
        mod.FAULTS.reset()
        assert not mod.FAULTS.is_armed() and mod.FAULTS.armed_sites() == []


# ---------------------------------------------------------------------------
# error-policy truth table on framework=scaler, health equal to JAX's
# ---------------------------------------------------------------------------
HEALTH_KEYS = ("state", "policy", "restarts", "restarts_window", "dead_letters",
               "dead_letter_depth", "deadline_drops")


def _policy_run(parse, mod, props, site_kw, n, block=False):
    pipe = parse("appsrc name=src ! tensor_filter name=f framework=scaler custom=factor:3 "
                 f"{props} ! tensor_sink name=out")
    bus = []
    pipe.add_bus_watcher(lambda m: bus.append(
        (m.kind, m.source, sorted(m.data) if isinstance(m.data, dict) else None)))
    mod.FAULTS.arm("element.f.handle_frame", **site_kw)
    pipe.start()
    err = None
    try:
        if block:
            pipe["src"].push_block(np.arange(n, dtype=np.float32).reshape(n, 1))
        else:
            for i in range(n):
                pipe["src"].push(np.float32([i]))
        pipe["src"].end_of_stream()
        try:
            pipe.wait(timeout=30)
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            err = type(e).__name__
        h = pipe.health()["f"]
    finally:
        pipe.stop()
        mod.FAULTS.reset()
    outs = [float(np.asarray(f.tensors[0]).reshape(-1)[0]) for f in pipe["out"].frames]
    return outs, {k: h[k] for k in HEALTH_KEYS}, err, sorted(bus)


TRUTH_TABLE = {
    "fail-stop": ("", dict(every=3, exc=ConnectionResetError)),
    "skip": ("error-policy=skip", dict(every=3, exc=ConnectionResetError)),
    "skip-bounded-dlq": ("error-policy=skip dead-letter-max=4", dict(rate=1.0)),
    "skip-dlq-zero": ("error-policy=skip dead-letter-max=0", dict(rate=1.0)),
    "restart": ("error-policy=restart restart-backoff=0.001 max-restarts=10",
                dict(every=4, times=2, exc=TimeoutError)),
    "restart-degrades": ("error-policy=restart restart-backoff=0 max-restarts=2",
                         dict(rate=1.0, exc=ConnectionResetError)),
    "restart-fatal-dead-letters": ("error-policy=restart max-restarts=1",
                                   dict(every=3, exc=ValueError)),
    "restart-device-oom": ("error-policy=restart restart-backoff=0",
                           dict(every=5, times=1, exc=None)),
}


@pytest.mark.parametrize("case", sorted(TRUTH_TABLE))
def test_error_policy_truth_table_equal_to_jax(case):
    props, site_kw = TRUTH_TABLE[case]
    n = 9

    def kw(mod):
        k = dict(site_kw)
        if case == "restart-device-oom":
            k["exc"] = mod.DeviceOomError
        return k

    got = _policy_run(torch_parse, tres, props, kw(tres), n)
    want = _policy_run(jax_parse, jres, props, kw(jres), n)
    assert got == want
    if case == "skip":
        assert got[1]["dead_letters"] == 3 and len(got[0]) == 6


@pytest.mark.parametrize("policy", ["skip", "restart"])
def test_block_of_frames_supervised_per_logical_frame_equal_to_jax(policy):
    """A BatchFrame reaching a per-frame call site is split and each
    logical frame supervised alone (max-batch=1)."""
    props = f"error-policy={policy} restart-backoff=0"
    site = dict(every=3, times=2, exc=TimeoutError)
    got = _policy_run(torch_parse, tres, props, site, 8, block=True)
    want = _policy_run(jax_parse, jres, props, site, 8, block=True)
    assert got == want


def test_filter_invoke_site_restart_zero_loss_equal_to_jax():
    def run(parse, mod):
        mod.FAULTS.arm("filter.invoke", every=5, times=3, exc=TimeoutError)
        pipe = parse("appsrc name=src ! tensor_filter name=f framework=scaler custom=factor:3 "
                     "error-policy=restart restart-backoff=0.001 max-restarts=10 ! "
                     "tensor_sink name=out")
        pipe.start()
        try:
            for i in range(20):
                pipe["src"].push(np.float32([i]))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=30)
            h = pipe.health()["f"]
        finally:
            pipe.stop()
        return sorted(float(f.tensors[0][0]) for f in pipe["out"].frames), h["restarts"]

    assert run(torch_parse, tres) == run(jax_parse, jres) == ([i * 3.0 for i in range(20)], 3)


def test_unknown_policy_is_refused_at_set_time():
    pipe = torch_parse("appsrc name=src ! tensor_sink name=out")
    with pytest.raises(ValueError):
        pipe["out"].set_property("error-policy", "retry-forever")
    with pytest.raises(ValueError):
        pipe["out"].set_property("stall-policy", "ignore")


# ---------------------------------------------------------------------------
# the filter's OOM and device-loss ladder on MobileNet-v2, against JAX
# ---------------------------------------------------------------------------
SIZE, MODEL = 32, "torch_resilience_mobilenet"
_PROPS = {"dtype": "float32", "classes": "10", "width": "0.35", "size": str(SIZE)}


@pytest.fixture(scope="module")
def mobilenet():
    fn, variables, in_spec, out_spec = jax_build("mobilenet_v2", _PROPS)
    variables = randomized_batchnorm(variables)
    register_jax_model(MODEL, fn, variables, in_spec, out_spec)
    module, t_in, t_out = torch_build("mobilenet_v2", _PROPS)
    module.load_state_dict(state_dict_from_flax(variables))
    register_torch_model(MODEL, module, t_in, t_out)
    rng = np.random.default_rng(5)
    yield rng.integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8)
    unregister_jax_model(MODEL)
    unregister_torch_model(MODEL)


def _ladder(parse, mod, framework, frames, arm=None, props="", fused=True):
    extra = "" if fused else "device-fused=never"
    pipe = parse(f"appsrc name=src ! tensor_filter name=f framework={framework} model={MODEL} "
                 f"max-batch=8 {props} ! tensor_decoder name=dec mode=image_labeling {extra} "
                 "! tensor_sink name=out")
    pipe.start()
    try:
        if arm is not None:
            arm(mod)
        pipe["src"].push_block(frames, pts=list(range(len(frames))))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
        h = pipe.health()["f"]
    finally:
        pipe.stop()
        mod.FAULTS.reset()
    labels = [f.meta["label_index"] for f in pipe["out"].frames]
    return labels, [f.pts for f in pipe["out"].frames], h


LADDER_KEYS = ("oom_retries", "oom_shrinks", "device_lost", "remeshes", "restarts",
               "dead_letters", "state")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_oom_ladder_shrinks_and_labels_equal_unfaulted_and_jax(mobilenet, fused):
    """One device.oom at the 8-frame micro-batch: trimmed, retried as two
    4-frame halves (a strictly smaller bucket), every label equal to the
    unfaulted run's and to the JAX pipeline's, the ladder counters equal."""
    def arm(mod):
        mod.FAULTS.arm("device.oom", exc=mod.DeviceOomError, times=1)

    clean = _ladder(torch_parse, tres, "torch-cuda accelerator=cpu", mobilenet, fused=fused)
    got = _ladder(torch_parse, tres, "torch-cuda accelerator=cpu", mobilenet, arm, fused=fused)
    want = _ladder(jax_parse, jres, "jax-xla", mobilenet, arm, fused=fused)
    assert got[0] == clean[0] == want[0] and got[1] == list(range(8))
    assert {k: got[2][k] for k in LADDER_KEYS} == {k: want[2][k] for k in LADDER_KEYS}
    assert (got[2]["oom_retries"], got[2]["oom_shrinks"]) == (1, 1)
    # the card allocator's segments and bytes: none on the CPU (JAX counts programs)
    assert (got[2]["oom_evictions"], got[2]["oom_trimmed_bytes"]) == (0, 0)


def test_second_oom_escalates_to_supervision_like_jax(mobilenet):
    """The retry is ONCE: an OOM on a half surfaces typed to supervision."""
    def arm(mod):
        mod.FAULTS.arm("device.oom", exc=mod.DeviceOomError, times=2)

    with pytest.raises(tres.DeviceOomError):
        _ladder(torch_parse, tres, "torch-cuda accelerator=cpu", mobilenet, arm)
    with pytest.raises(jres.DeviceOomError):
        _ladder(jax_parse, jres, "jax-xla", mobilenet, arm)


def test_device_lost_unsharded_restarts_like_jax(mobilenet):
    """An unsharded backend has no re-mesh: the loss re-raises into
    supervision (error-policy=restart), one restart retries the batch."""
    def arm(mod):
        mod.FAULTS.arm("device.lost", exc=mod.DeviceLostError, times=1)

    props = "error-policy=restart restart-backoff=0"
    clean = _ladder(torch_parse, tres, "torch-cuda accelerator=cpu", mobilenet, fused=False)
    got = _ladder(torch_parse, tres, "torch-cuda accelerator=cpu", mobilenet, arm, props,
                  fused=False)
    want = _ladder(jax_parse, jres, "jax-xla", mobilenet, arm, props, fused=False)
    assert got[0] == clean[0] == want[0] and got[1] == list(range(8))
    assert {k: got[2][k] for k in LADDER_KEYS} == {k: want[2][k] for k in LADDER_KEYS}
    assert (got[2]["device_lost"], got[2]["restarts"], got[2]["remeshes"]) == (1, 1, 0)


def test_restart_keeps_the_fused_device_half(mobilenet):
    """A restarted filter re-applies the decoder's device half the fusion
    pass folded in (the JAX package's restart drops it, ROADMAP C13): the
    labels after the restart equal the unfaulted fused run's."""
    def arm(mod):
        mod.FAULTS.arm("device.lost", exc=mod.DeviceLostError, times=1)

    clean = _ladder(torch_parse, tres, "torch-cuda accelerator=cpu", mobilenet)
    got = _ladder(torch_parse, tres, "torch-cuda accelerator=cpu", mobilenet, arm,
                  "error-policy=restart restart-backoff=0")
    assert got[0] == clean[0] and got[2]["restarts"] == 1


def test_no_fallback_without_a_card():
    """With no card, torch-cuda's start() raises: no rung of the ladder runs
    off the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pipe = torch_parse("appsrc name=src ! tensor_filter name=f framework=torch-cuda "
                       f"model=zoo custom=arch:mobilenet_v2,size:{SIZE},width:0.35,classes:10 "
                       "error-policy=restart ! tensor_sink name=out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.start()


def test_jax_restart_drops_the_fused_device_half(mobilenet):
    """ROADMAP C13, in the JAX reference: its restarted filter opens a
    backend without the decoder's device half and leaves batch-through off,
    so the fused decoder labels every frame after the restart 0.  The port
    re-applies the half (``test_restart_keeps_the_fused_device_half``)."""
    def arm(mod):
        mod.FAULTS.arm("device.lost", exc=mod.DeviceLostError, times=1)

    clean = _ladder(jax_parse, jres, "jax-xla", mobilenet)
    faulted = _ladder(jax_parse, jres, "jax-xla", mobilenet, arm,
                      "error-policy=restart restart-backoff=0")
    port = _ladder(torch_parse, tres, "torch-cuda accelerator=cpu", mobilenet, arm,
                   "error-policy=restart restart-backoff=0")
    assert faulted[2]["restarts"] == 1 and faulted[0] == [0] * 8 != clean[0]
    assert port[0] == clean[0]


def test_oom_retry_runs_outside_the_failed_attempts_handler():
    """The halves run after the handler of the failed attempt has exited:
    inside it, the attempt's traceback would keep the model's activations
    allocated on the card through the retry."""
    import sys

    from nnstreamer_tpu_torch.backends.base import FilterBackend, register_backend

    seen = []

    class OomOnce(FilterBackend):
        NAME = "oom-once-probe"

        def set_input_info(self, in_spec):
            return in_spec

        def invoke_batch(self, inputs):
            seen.append((int(inputs[0].shape[0]), sys.exc_info()[0]))
            if len(seen) == 1:
                raise tres.DeviceOomError("first attempt")
            return [np.asarray(inputs[0]) + 1]

    register_backend(OomOnce)
    pipe = torch_parse("appsrc name=src ! tensor_filter name=f framework=oom-once-probe "
                       "max-batch=8 ! tensor_sink name=out")
    pipe.start()
    try:
        pipe["src"].push_block(np.arange(8, dtype=np.float32).reshape(8, 1))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
    finally:
        pipe.stop()
    assert seen == [(8, None), (4, None), (4, None)]
    assert [float(f.tensors[0][0]) for f in pipe["out"].frames] == [i + 1.0 for i in range(8)]


def test_a_failed_attempts_tensors_are_freed_before_the_retry():
    """``device_call`` leaves no reference cycle through the typed error:
    the tensors the failed attempt allocated are gone (without the cyclic
    collector) when the filter retries, or a real OOM's halves would run
    beside the failed batch's activations."""
    import gc
    import weakref

    from nnstreamer_tpu_torch.backends.base import FilterBackend, register_backend

    refs, alive = [], []

    class OomAfterAlloc(FilterBackend):
        NAME = "oom-after-alloc-probe"

        def set_input_info(self, in_spec):
            return in_spec

        def invoke_batch(self, inputs):
            return tres.device_call(self._raw, inputs)

        def _raw(self, inputs):
            if not refs:
                activation = torch.zeros(1 << 16)
                refs.append(weakref.ref(activation))
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
            alive.append(refs[0]() is not None)
            return [np.asarray(inputs[0]) + 1]

    register_backend(OomAfterAlloc)
    pipe = torch_parse("appsrc name=src ! tensor_filter name=f framework=oom-after-alloc-probe "
                       "max-batch=8 ! tensor_sink name=out")
    gc.disable()
    try:
        pipe.start()
        pipe["src"].push_block(np.arange(8, dtype=np.float32).reshape(8, 1))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
    finally:
        gc.enable()
        pipe.stop()
    assert alive == [False, False]
    assert pipe.health()["f"]["oom_shrinks"] == 1


def test_staging_pool_trim_counts_buffers_like_jax():
    """``DeviceBufferPool.trim`` returns the buffers it dropped, as the JAX
    pool does, and the pool recycles afterwards."""
    from nnstreamer_tpu.core.buffer import DeviceBufferPool as JPool
    from nnstreamer_tpu_torch.core.buffer import DeviceBufferPool as TPool

    def run(cls):
        pool = cls(max_per_key=4)
        held = [pool.acquire((2, 3), np.uint8) for _ in range(3)] + [
            pool.acquire((5,), np.float32)]
        for b in held[:3]:
            pool.release(b)
        first = pool.trim()
        pool.release(held[3])
        return first, pool.trim(), pool.trim(), pool.trims, pool.allocated, pool.reused

    assert run(TPool) == run(JPool) == (3, 1, 0, 3, 4, 0)


@pytest.mark.parametrize("reads", ["card", "host"])
def test_memory_monitor_trims_host_pools_only_under_a_host_watermark(reads):
    """The staging pools hold host memory: past a card watermark only the
    backends' allocator caches are trimmed; past a host-RSS watermark the
    pools are too."""
    from nnstreamer_tpu_torch.core.buffer import DeviceBufferPool

    pool = DeviceBufferPool()
    pool.release(pool.acquire((4,), np.uint8))
    pipe = torch_parse("appsrc name=src ! tensor_filter name=f framework=scaler "
                       "custom=factor:2 ! tensor_sink name=out")
    sample = (lambda: (95, 100, 0)) if reads == "card" else (lambda: (0, 0, 95))
    mon = pipe.enable_memory_monitor(high=0.9, low=0.5, host_limit_bytes=100, sample=sample,
                                     clock=lambda: 0.0)
    assert mon.poll()
    names = [getattr(h, "__name__", "") for h in mon.trim_hooks]
    assert names == ["trim_prefix_cache", "trim_caches", "trim_staging_pools_on_host"]
    trimmed = mon.snapshot()["mem_trimmed_entries"]
    if reads == "card":
        assert pool.trims == 0 and trimmed == 0
    else:  # every live pool of the process is trimmed: this one's buffer at least
        assert pool.trims == 1 and trimmed >= 1
