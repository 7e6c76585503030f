"""Port parity for ``core/tracer.py``.

Per-element ``frames``/``calls`` equal to the JAX package's on the same
pipelines, fused and unfused (a filter on plain frames, a block split for
a per-frame element, a micro-batching filter fed one block); the mailbox
queue-wait and queue-level hooks at thread boundaries; the Chrome-trace
export; and ``frame_nbytes`` of torch frames, equal to the numpy frames'
bytes, read from metadata: a tensor that refuses ``.numpy()`` and
``.cpu()`` goes through a traced pipeline untouched.
"""

import json

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import tracer as jtr
from nnstreamer_tpu.core.buffer import TensorFrame as JFrame
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core import tracer as ttr
from nnstreamer_tpu_torch.core.buffer import BatchFrame, TensorFrame
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse

torch.set_num_threads(2)

GRAPHS = {
    "filter": ("appsrc name=src ! tensor_filter name=f framework=scaler custom=factor:2 ! "
               "identity name=i ! tensor_sink name=out", "frames"),
    "block_split": ("appsrc name=src ! tensor_filter name=f framework=scaler custom=factor:2 "
                    "! tensor_transform name=t mode=arithmetic option=add:1 ! "
                    "tensor_sink name=out", "block"),
    "microbatch": ("appsrc name=src ! tensor_filter name=f framework=scaler custom=factor:2 "
                   "max-batch=8 ! tensor_sink name=out", "block"),
}


def _report(parse, text: str, feed: str, fuse: bool):
    pipe = parse(text, name="tr", fuse=fuse)
    tracer = pipe.enable_tracing()
    pipe.start()
    try:
        if feed == "frames":
            for i in range(12):
                pipe["src"].push(np.float32([i, i + 1]))
        else:
            pipe["src"].push_block(np.arange(24, dtype=np.float32).reshape(12, 2))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=20)
        out = [np.asarray(f.tensors[0]).tolist() for f in pipe["out"].frames]
    finally:
        pipe.stop()
    return {k: (r["frames"], r["calls"]) for k, r in tracer.report().items()}, out


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_frames_and_calls_equal_to_jax(graph, fuse):
    text, feed = GRAPHS[graph]
    got = _report(torch_parse, text, feed, fuse)
    want = _report(jax_parse, text, feed, fuse)
    assert got == want
    assert got[0]["out"][0] == 12


def test_queue_hooks_at_thread_boundaries():
    """Unfused, every element behind a mailbox records its frames' queue
    waits and its mailbox depth; fused, the one segment head (a source)
    has no mailbox, so nothing is recorded."""
    for fuse, want in ((False, {"a", "b", "out"}), (True, set())):
        pipe = torch_parse("appsrc name=src ! identity name=a ! identity name=b ! "
                           "tensor_sink name=out", fuse=fuse)
        tracer = pipe.enable_tracing()
        pipe.start()
        try:
            for i in range(10):
                pipe["src"].push(np.float32([i]))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=10)
        finally:
            pipe.stop()
        waits = {el: h.count for el, name, h in tracer.latency_histograms()
                 if name == "nns.element.queue_wait_seconds"}
        assert set(waits) == want and all(n == 10 for n in waits.values())
        rep = tracer.report()
        assert all((rep[el]["queue_capacity"] > 0) == (el in want) for el in rep)
        # the stamp is popped at dequeue: none reaches the sink
        assert all(ttr.META_SRC_TS in f.meta and "_nns_tl_qput" not in f.meta
                   for f in pipe["out"].frames)


@pytest.mark.parametrize("detail", [True, False])
def test_chrome_trace_export(detail, tmp_path):
    pipe = torch_parse("appsrc name=src ! identity name=a ! tensor_sink name=out")
    tracer = pipe.enable_tracing(detail=detail)
    pipe.start()
    try:
        for i in range(5):
            pipe["src"].push(np.float32([i]))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=10)
    finally:
        pipe.stop()
    path = tmp_path / "trace.json"
    tracer.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    lanes = {e["args"]["name"] for e in events if e["name"] == "thread_name"}
    assert lanes == {"a", "out"}
    spans = [e for e in events if e["ph"] == "X"]
    assert len(spans) == (10 if detail else 2)
    assert {e["name"] for e in events if e["ph"] == "C"} == {"a/fps", "out/fps"}
    lines = tracer.summary_lines()
    assert lines[0].split()[0] == "element" and lines[-1].startswith("cpu usage")


class _NoHost(torch.Tensor):
    """A tensor that refuses to come to the host, standing in for a card
    tensor whose copy or synchronization the tracer must never cause."""

    def numpy(self, *a, **k):
        raise AssertionError("numpy() of a traced tensor")

    def cpu(self, *a, **k):
        raise AssertionError("cpu() of a traced tensor")

    def item(self, *a, **k):
        raise AssertionError("item() of a traced tensor")


def _no_host(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).as_subclass(_NoHost)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int32])
def test_frame_nbytes_equal_to_numpy_without_a_host_copy(dtype):
    rng = np.random.default_rng(3)
    arrs = [rng.integers(0, 100, (4, 5, 3)).astype(dtype), rng.integers(0, 9, (7,)).astype(dtype)]
    want = jtr.frame_nbytes(JFrame(arrs))
    assert ttr.frame_nbytes(TensorFrame([_no_host(a) for a in arrs])) == want
    assert ttr.frame_nbytes(TensorFrame(arrs)) == want
    meta = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, device="meta") for a in arrs]
    assert ttr.frame_nbytes(TensorFrame(meta)) == want
    block = BatchFrame(tensors=[torch.stack([_no_host(arrs[0])] * 3)], pts=0.0,
                       frames_info=[(None, None, {})] * 3)
    assert ttr.frame_nbytes(block) == 3 * arrs[0].nbytes
    assert ttr.frame_nbytes(object()) == 0


def test_traced_pipeline_never_brings_a_tensor_to_the_host():
    arrs = [np.full((8, 8, 3), i, np.uint8) for i in range(6)]
    pipe = torch_parse("appsrc name=src ! identity name=a ! queue name=q ! "
                       "tensor_sink name=out to-host=false")
    tracer = pipe.enable_tracing()
    pipe.enable_flight_recorder(profile_incidents=False)
    pipe.start()
    try:
        for a in arrs:
            pipe["src"].push(_no_host(a))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=10)
        snap = pipe.metrics_snapshot()
    finally:
        pipe.stop()
    assert len(pipe["out"].frames) == 6
    assert all(isinstance(f.tensors[0], _NoHost) for f in pipe["out"].frames)
    span = tracer.report()["a"]
    assert span["frames"] == 6 and tracer._stats["a"].bytes == 6 * 8 * 8 * 3
    assert snap.get("nns.element.frames", element="q") == 6
    # the recorder minted a trace id per frame at the source
    assert len({f.meta["_nns_trace_id"] for f in pipe["out"].frames}) == 6
