"""Port parity for ``core/lifecycle.py``: hot swap, rollback, drain, and
the ingest lane's refusal under a replay policy, and the shared model
table (``shared-tensor-filter-key``).

A deterministic updatable backend (model ``f:<factor>`` scales its input)
is registered in both packages; a swap at the same point and a rollback
give per-frame outputs equal to the JAX pipeline's, with the same swap
counters.  The torch-cuda backend swaps between two registered modules on
the CPU against the JAX package's jax-xla swap, and keeps the decoder's
fused device half across the swap and an inline reload; filters sharing
a key hold one backend, reload it together and restart it after a loss.
``drain()`` and ``stop(drain=True)``
lose nothing; the lane is refused under ``error-policy=skip|restart`` and
``stall-policy=restart``.
"""

import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends import base as jbase
from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.core import resilience as jres
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu.pipeline.element import ElementError as JElementError
from nnstreamer_tpu_torch.backends import base as tbase
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.core import resilience as tres
from nnstreamer_tpu_torch.core.types import StreamSpec, TensorSpec
from nnstreamer_tpu_torch.pipeline import ElementError as TElementError
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse

torch.set_num_threads(2)

REC = "lc-rec-parity"


def _rec_backend(base):
    class RecBackend(base.FilterBackend):
        NAME = REC

        def __init__(self):
            super().__init__()
            self.factor = 2.0

        def open(self, model, props):
            super().open(model, props)
            model = model or ""
            if model.startswith("slow"):
                time.sleep(0.2)
            if model.startswith("explode-open"):
                raise RuntimeError("bad model artifact")
            if ":" in model:
                self.factor = float(model.split(":", 1)[1])

        def reload(self, model):
            if "explode" in (model or ""):
                raise RuntimeError("reload blew up")
            if ":" in (model or ""):
                self.factor = float(model.split(":", 1)[1])
            self.model_path = model

        def set_input_info(self, in_spec):
            return in_spec

        def invoke(self, inputs):
            return [np.asarray(a, np.float32) * self.factor for a in inputs]

    if hasattr(base.FilterBackend, "framework_info"):  # the JAX package's model-path check
        def framework_info(self):
            info = base.FilterBackend.framework_info(self)
            info.run_without_model = True
            info.verify_model_path = False
            return info

        RecBackend.framework_info = framework_info
    base.register_backend(RecBackend)
    return RecBackend


_rec_backend(jbase)
_rec_backend(tbase)

PACKAGES = {"port": (torch_parse, tres), "jax": (jax_parse, jres)}


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    tres.FAULTS.reset()
    jres.FAULTS.reset()


def _swap_pipe(parse, extra=""):
    pipe = parse(f"appsrc name=src ! tensor_filter name=f framework={REC} model=f:2 "
                 f"is-updatable=true {extra} ! tensor_sink name=out")
    pipe.start()
    return pipe


def _outs(pipe):
    return [float(np.asarray(f.tensors[0]).reshape(-1)[0]) for f in pipe["out"].frames]


def _wait_outs(pipe, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while len(pipe["out"].frames) < n and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(pipe["out"].frames) >= n


SWAP_KEYS = ("swaps", "swap_failures", "rollbacks", "model_version", "restarts",
             "dead_letters", "state")


def _health(pipe):
    h = pipe.health()["f"]
    return {k: h[k] for k in SWAP_KEYS}


def _swap_at_boundary(which):
    parse, _ = PACKAGES[which]
    pipe = _swap_pipe(parse)
    try:
        for i in range(3):
            pipe["src"].push(np.float32([i]))
        _wait_outs(pipe, 3)
        ticket = pipe.reload_model("f", "f:3")
        assert ticket.wait_staged(5) and ticket.ok, ticket.error
        for i in range(3, 6):
            pipe["src"].push(np.float32([i]))
        assert ticket.wait_applied(5)
        pipe["src"].end_of_stream()
        pipe.wait(10)
        return _outs(pipe), _health(pipe), ticket.state
    finally:
        pipe.stop()


def test_swap_at_a_frame_boundary_equal_to_jax():
    got = _swap_at_boundary("port")
    assert got == _swap_at_boundary("jax")
    assert got[0] == [0.0, 2.0, 4.0, 9.0, 12.0, 15.0] and got[1]["swaps"] == 1


def _rollback(which):
    parse, mod = PACKAGES[which]
    pipe = _swap_pipe(parse, "observation-window=60 rollback-error-burst=2")
    try:
        pipe["src"].push(np.float32([0]))
        ticket = pipe.reload_model("f", "f:3")
        assert ticket.wait_staged(5) and ticket.ok
        mod.FAULTS.arm("filter.reload.post", exc=RuntimeError("new model is broken"))
        for i in range(1, 5):
            pipe["src"].push(np.float32([i]))
        pipe["src"].end_of_stream()
        pipe.wait(10)
        return _outs(pipe), _health(pipe), ticket.state
    finally:
        pipe.stop()


def test_post_swap_error_burst_rolls_back_equal_to_jax():
    got = _rollback("port")
    assert got == _rollback("jax")
    assert got[0] == [0.0, 2.0, 4.0, 6.0, 8.0] and got[2] == "rolled-back"
    assert (got[1]["rollbacks"], got[1]["model_version"], got[1]["restarts"]) == (1, 0, 0)


@pytest.mark.parametrize("site", ["filter.reload.load", "filter.reload.warmup", "open"])
def test_staging_failure_keeps_the_old_model_equal_to_jax(site):
    def run(which):
        parse, mod = PACKAGES[which]
        pipe = _swap_pipe(parse)
        try:
            model = "explode-open:9" if site == "open" else "f:5"
            if site != "open":
                mod.FAULTS.arm(site, exc=RuntimeError("injected staging fault"))
            for i in range(2):
                pipe["src"].push(np.float32([i]))
            ticket = pipe.reload_model("f", model)
            assert ticket.wait_staged(5)
            for i in range(2, 4):
                pipe["src"].push(np.float32([i]))
            pipe["src"].end_of_stream()
            pipe.wait(10)
            return _outs(pipe), _health(pipe), ticket.state, ticket.ok
        finally:
            pipe.stop()

    got = run("port")
    assert got == run("jax")
    assert got[0] == [0.0, 2.0, 4.0, 6.0] and got[1]["swap_failures"] == 1 and not got[3]


@pytest.mark.parametrize("model", ["f:4", "explode:7"])
def test_inline_reload_equal_to_jax(model):
    def run(which):
        parse, _ = PACKAGES[which]
        pipe = _swap_pipe(parse, "staged-reload=false")
        try:
            pipe["src"].push(np.float32([1]))
            _wait_outs(pipe, 1)
            t = pipe.reload_model("f", model)
            pipe["src"].push(np.float32([2]))
            pipe["src"].end_of_stream()
            pipe.wait(10)
            return _outs(pipe), _health(pipe), t.state, t.ok
        finally:
            pipe.stop()

    assert run("port") == run("jax")


def test_reload_refusals_equal_to_jax():
    for parse, err in ((torch_parse, TElementError), (jax_parse, JElementError)):
        pipe = parse(f"appsrc name=src ! tensor_filter name=f framework={REC} model=f:2 ! "
                     "tensor_sink name=out")
        pipe.start()
        try:
            with pytest.raises(err, match="is-updatable"):
                pipe.reload_model("f", "f:3")
            with pytest.raises(err, match="hot model reload"):
                pipe.reload_model("out", "f:3")
        finally:
            pipe.stop()
    for which in PACKAGES:
        pipe = _swap_pipe(PACKAGES[which][0])
        try:
            t1 = pipe.reload_model("f", "slow:3")
            t2 = pipe.reload_model("f", "f:4")
            assert t2.state == "refused"
            assert t1.wait_staged(5) and t1.ok
            assert pipe.health()["f"]["swap_failures"] == 0
        finally:
            pipe.stop()


# ---------------------------------------------------------------------------
# torch-cuda on the CPU: a swap between registered modules, against jax-xla
# ---------------------------------------------------------------------------
class _Scale(torch.nn.Module):
    def __init__(self, k):
        super().__init__()
        self.k = k

    def forward(self, x):
        return x * self.k


@pytest.fixture(scope="module")
def scaled_models():
    spec = StreamSpec((TensorSpec((4,), np.float32),))
    for k in (2, 3):
        register_torch_model(f"lc_scale{k}", _Scale(float(k)), spec, spec)
        register_jax_model(f"lc_scale{k}", lambda p, xs, k=k: [xs[0] * float(k)], None)
    yield
    for k in (2, 3):
        unregister_torch_model(f"lc_scale{k}")
        unregister_jax_model(f"lc_scale{k}")


def test_torch_cuda_swap_equal_to_jax_xla(scaled_models):
    """max-batch=4 micro-batches; the swap lands at a drained boundary."""
    def run(parse, framework):
        pipe = parse(f"appsrc name=src ! tensor_filter name=f framework={framework} "
                     "model=lc_scale2 is-updatable=true max-batch=4 ! tensor_sink name=out")
        pipe.start()
        try:
            for i in range(8):
                pipe["src"].push(np.full(4, i, np.float32))
            _wait_outs(pipe, 8)
            ticket = pipe.reload_model("f", "lc_scale3")
            assert ticket.wait_staged(30) and ticket.ok, ticket.error
            for i in range(8, 16):
                pipe["src"].push(np.full(4, i, np.float32))
            pipe["src"].end_of_stream()
            pipe.wait(30)
            return _outs(pipe), _health(pipe)
        finally:
            pipe.stop()

    got = run(torch_parse, "torch-cuda accelerator=cpu")
    assert got == run(jax_parse, "jax-xla")
    assert got[0] == [2.0 * i for i in range(8)] + [3.0 * i for i in range(8, 16)]


def test_swap_keeps_the_fused_device_half(scaled_models):
    """The decoder's device half the fusion pass folded in is appended to
    the staged backend as well (the JAX package's swap drops it, ROADMAP
    C13): labels before and after the swap are the argmax of each model's
    output."""
    w = {k: torch.randn(4, 6, generator=torch.Generator().manual_seed(k)) for k in (5, 6)}
    spec_in = StreamSpec((TensorSpec((4,), np.float32),))
    spec_out = StreamSpec((TensorSpec((6,), np.float32),))
    for k in (5, 6):
        register_torch_model(f"lc_lin{k}", torch.nn.Linear(4, 6, bias=False), spec_in, spec_out)
    try:
        from nnstreamer_tpu_torch.backends import torch_cuda

        for k in (5, 6):
            torch_cuda._model_registry[f"lc_lin{k}"][0].weight.data = w[k].T.contiguous()
        pipe = torch_parse("appsrc name=src ! tensor_filter name=f framework=torch-cuda "
                           "accelerator=cpu model=lc_lin5 is-updatable=true max-batch=4 ! "
                           "tensor_decoder mode=image_labeling ! tensor_sink name=out")
        rng = np.random.default_rng(3)
        xs = rng.normal(size=(16, 4)).astype(np.float32)
        pipe.start()
        try:
            assert pipe["f"]._fused_posts
            for i in range(8):
                pipe["src"].push(xs[i])
            _wait_outs(pipe, 8)
            ticket = pipe.reload_model("f", "lc_lin6")
            assert ticket.wait_staged(30) and ticket.ok, ticket.error
            for i in range(8, 16):
                pipe["src"].push(xs[i])
            pipe["src"].end_of_stream()
            pipe.wait(30)
        finally:
            pipe.stop()
        got = [f.meta["label_index"] for f in pipe["out"].frames]
        want = [int(np.argmax(xs[i] @ w[5 if i < 8 else 6].numpy())) for i in range(16)]
        assert got == want
    finally:
        for k in (5, 6):
            unregister_torch_model(f"lc_lin{k}")


# ---------------------------------------------------------------------------
# inline reload and shared-tensor-filter-key on torch-cuda (on the CPU)
# ---------------------------------------------------------------------------
@pytest.fixture
def keyed_models():
    """lc_key5 / lc_key6: ``x @ W_k`` (4 -> 6) in both packages."""
    w = {k: np.random.default_rng(k).normal(size=(4, 6)).astype(np.float32) for k in (5, 6)}
    spec_in = StreamSpec((TensorSpec((4,), np.float32),))
    spec_out = StreamSpec((TensorSpec((6,), np.float32),))
    for k in (5, 6):
        lin = torch.nn.Linear(4, 6, bias=False)
        lin.weight.data = torch.from_numpy(w[k].T.copy())
        register_torch_model(f"lc_key{k}", lin, spec_in, spec_out)
        register_jax_model(f"lc_key{k}", lambda p, xs, m=w[k]: [xs[0] @ m], None)
    yield w
    for k in (5, 6):
        unregister_torch_model(f"lc_key{k}")
        unregister_jax_model(f"lc_key{k}")


def _labels(pipe, sink="out"):
    return [f.meta["label_index"] for f in pipe[sink].frames]


def test_inline_reload_keeps_the_placement_and_the_fused_half(keyed_models):
    """staged-reload=false on ``accelerator=cpu``: the reload stays on the
    CPU (no card is picked) and the decoder's fused device half is kept
    once: labels are each model's argmax."""
    w = keyed_models
    xs = np.random.default_rng(3).normal(size=(16, 4)).astype(np.float32)
    pipe = torch_parse("appsrc name=src ! tensor_filter name=f framework=torch-cuda "
                       "accelerator=cpu model=lc_key5 is-updatable=true staged-reload=false "
                       "max-batch=4 ! tensor_decoder mode=image_labeling ! tensor_sink name=out")
    pipe.start()
    try:
        assert pipe["f"]._fused_posts
        for i in range(8):
            pipe["src"].push(xs[i])
        _wait_outs(pipe, 8)
        ticket = pipe.reload_model("f", "lc_key6")
        assert ticket.ok, ticket.error
        assert pipe["f"].backend.device.type == "cpu"
        assert len(pipe["f"].backend._posts) == len(pipe["f"]._fused_posts)
        for i in range(8, 16):
            pipe["src"].push(xs[i])
        pipe["src"].end_of_stream()
        pipe.wait(30)
        h = _health(pipe)
    finally:
        pipe.stop()
    want = [int(np.argmax(xs[i] @ w[5 if i < 8 else 6])) for i in range(16)]
    assert _labels(pipe) == want
    assert (h["swaps"], h["swap_failures"], h["model_version"]) == (1, 0, 1)


def _two_keyed(parse, framework, xs):
    """Two branches whose filters share one backend; an inline reload of
    one filter swaps the model both serve."""
    text = "  ".join(
        f"appsrc name={s} ! tensor_filter name=f{s} framework={framework} model=lc_key5 "
        f"is-updatable=true shared-tensor-filter-key=lc-shared ! "
        f"tensor_decoder mode=image_labeling ! tensor_sink name=o{s}" for s in "ab")
    pipe = parse(text)
    pipe.start()
    try:
        shared = pipe["fa"].backend is pipe["fb"].backend
        for s in "ab":
            for i in range(4):
                pipe[s].push(xs[i])
        for s in "ab":
            _wait_outs_at(pipe, f"o{s}", 4)
        ticket = pipe.reload_model("fa", "lc_key6")
        for s in "ab":
            for i in range(4, 8):
                pipe[s].push(xs[i])
            pipe[s].end_of_stream()
        pipe.wait(30)
        h = {f: {k: pipe.health()[f][k] for k in SWAP_KEYS} for f in ("fa", "fb")}
        fused = [bool(getattr(pipe[f], "_fused_posts", ())) for f in ("fa", "fb")]
    finally:
        pipe.stop()
    return _labels(pipe, "oa"), _labels(pipe, "ob"), h, ticket.ok, shared, fused


def _wait_outs_at(pipe, sink, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while len(pipe[sink].frames) < n and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(pipe[sink].frames) >= n


def test_shared_key_serves_both_filters_and_reloads_inline_like_jax(keyed_models):
    """Both keyed filters hold one backend, neither folds its decoder half
    into it, the reload through one swaps the model of both, and the last
    release closes it: labels and swap counters equal the JAX package's."""
    from nnstreamer_tpu_torch.elements import filter as tfilter

    w = keyed_models
    xs = np.random.default_rng(4).normal(size=(8, 4)).astype(np.float32)
    got = _two_keyed(torch_parse, "torch-cuda accelerator=cpu", xs)
    want = _two_keyed(jax_parse, "jax-xla", xs)
    assert got[:4] == want[:4]
    labels = [int(np.argmax(xs[i] @ w[5 if i < 4 else 6])) for i in range(8)]
    assert got[0] == got[1] == labels and got[3]
    assert got[4] and got[5] == [False, False]
    assert not tfilter._shared_table


def _keyed_loss(parse, mod, framework, xs):
    pipe = parse(f"appsrc name=src ! tensor_filter name=f framework={framework} model=lc_key5 "
                 "shared-tensor-filter-key=lc-lost error-policy=restart restart-backoff=0 ! "
                 "tensor_decoder mode=image_labeling ! tensor_sink name=out")
    pipe.start()
    try:
        mod.FAULTS.arm("device.lost", exc=mod.DeviceLostError, times=1, after=2)
        for x in xs:
            pipe["src"].push(x)
        pipe["src"].end_of_stream()
        pipe.wait(30)
        h = pipe.health()["f"]
    finally:
        pipe.stop()
        mod.FAULTS.reset()
    keys = ("device_lost", "remeshes", "restarts", "dead_letters", "state")
    return _labels(pipe), [f.pts for f in pipe["out"].frames], {k: h[k] for k in keys}


def test_device_loss_on_a_shared_backend_restarts_like_jax(keyed_models):
    """A shared backend is not the element's to replace: the loss re-raises
    into supervision, whose restart releases the key and acquires it anew."""
    from nnstreamer_tpu_torch.elements import filter as tfilter

    w = keyed_models
    xs = np.random.default_rng(5).normal(size=(6, 4)).astype(np.float32)
    got = _keyed_loss(torch_parse, tres, "torch-cuda accelerator=cpu", xs)
    assert got == _keyed_loss(jax_parse, jres, "jax-xla", xs)
    assert got[0] == [int(np.argmax(x @ w[5])) for x in xs]
    assert (got[2]["device_lost"], got[2]["restarts"], got[2]["remeshes"]) == (1, 1, 0)
    assert not tfilter._shared_table


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_drain_loses_nothing_equal_to_jax(fuse):
    def run(parse):
        pipe = parse("appsrc name=src ! tensor_filter name=f framework=scaler custom=factor:2 "
                     "max-batch=4 ! tensor_sink name=out", fuse=fuse)
        pipe.start()
        for i in range(12):
            pipe["src"].push(np.float32([i]))
        r = pipe.drain(timeout=10)
        delivered, draining = pipe.delivered_frames(), pipe.draining
        pipe.stop()
        late = parse("appsrc name=src ! tensor_sink name=out", fuse=fuse)
        late.start()
        for i in range(5):
            late["src"].push(np.float32([i]))
        late.stop(drain=True, drain_timeout=10)
        return (r["dropped"], r["drained"] <= 12, delivered, draining, _outs(pipe),
                len(late["out"].frames))

    got = run(torch_parse)
    assert got == run(jax_parse)
    assert got == (0, True, 12, True, [2.0 * i for i in range(12)], 5)


def test_drain_not_started_is_empty():
    for parse in (torch_parse, jax_parse):
        pipe = parse("appsrc name=src ! tensor_sink name=out")
        assert pipe.drain() == {"drained": 0, "dropped": 0, "elapsed": 0.0}


# ---------------------------------------------------------------------------
# the ingest lane under a replay policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("props", ["error-policy=skip", "error-policy=restart",
                                   "stall-policy=restart"])
def test_ingest_lane_refused_under_replay_policies_like_jax(props):
    for parse, err in ((torch_parse, TElementError), (jax_parse, JElementError)):
        on = parse("appsrc name=src ! tensor_filter name=f framework=async-sim max-batch=4 "
                   f"ingest-lane=on {props} ! tensor_sink name=out")
        with pytest.raises(err, match="ingest-lane=on is incompatible"):
            on.start()
        auto = parse("appsrc name=src ! tensor_filter name=f framework=async-sim max-batch=4 "
                     f"{props} ! tensor_sink name=out")
        auto.start()
        try:
            assert auto["f"]._lane is None
        finally:
            auto.stop()
    lane = torch_parse("appsrc name=src ! tensor_filter name=f framework=async-sim "
                       "max-batch=4 ! tensor_sink name=out")
    lane.start()
    try:
        assert lane["f"]._lane is not None  # fail-stop keeps it
    finally:
        lane.stop()
