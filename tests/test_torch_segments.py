"""The port's streaming-thread fusion, and fused-vs-unfused parity of its
asynchronous feed.

Holds on the port the ``TestSegmentation`` partitions and the
``TestAsyncWindowParity`` FIFO contract of ``tests/test_fusion_parity.py``
(with appsrc and a pass-through element defined here, since the port has
no videotestsrc, identity or tee yet), and runs one seeded stream through
the JAX pipeline and the port's with the feed on: byte-identical float32
outputs, in order.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse_pipeline
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.elements.basic import AppSrc, TensorSink
from nnstreamer_tpu_torch.pipeline import Element, Pipeline, TransformElement, element, parse_pipeline

torch.set_num_threads(2)


@element("torch_seg_pass")
class Pass(TransformElement):
    """Pass-through element."""

    BATCH_AWARE = True

    def transform(self, frame):
        return frame


class Tee2(Element):
    """Two-way fan-out (the port has no tee yet)."""

    NUM_SRC_PADS = 2
    BATCH_AWARE = True

    def handle_frame(self, pad, frame):
        return [(0, frame), (1, frame)]


class _Affine(torch.nn.Module):
    def forward(self, x):
        return x * 2.0 + 1.0


@pytest.fixture(scope="module", autouse=True)
def _models():
    register_torch_model("seg_affine", _Affine())
    register_jax_model("seg_affine", lambda p, xs: [xs[0] * 2.0 + 1.0], None)
    yield
    unregister_torch_model("seg_affine")
    unregister_jax_model("seg_affine")


class TestSegmentation:
    @staticmethod
    def _segs(pipe):
        pipe.start()
        try:
            return [[e.name for e in seg.chain] for seg in pipe._segments]
        finally:
            pipe.stop()

    def test_linear_chain_one_thread(self):
        pipe = parse_pipeline(
            "appsrc name=a ! torch_seg_pass name=b ! torch_seg_pass name=c ! tensor_sink name=d")
        assert self._segs(pipe) == [["a", "b", "c", "d"]]

    def test_queue_is_a_boundary(self):
        pipe = parse_pipeline(
            "appsrc name=a ! torch_seg_pass name=b ! queue name=q ! tensor_sink name=d")
        assert self._segs(pipe) == [["a", "b"], ["q", "d"]]

    def test_tee_branches_keep_threads(self):
        pipe = Pipeline("tee")
        a, t, x, y = AppSrc("a"), Tee2("t"), TensorSink("x"), TensorSink("y")
        pipe.add(a, t, x, y)
        a.link(t)
        t.link(x, src_pad=0)
        t.link(y, src_pad=1)
        segs = self._segs(pipe)
        assert ["a", "t"] in segs and ["x"] in segs and ["y"] in segs

    def test_micro_batcher_keeps_boundaries(self):
        pipe = parse_pipeline(
            "appsrc name=src ! tensor_filter name=f model=seg_affine accelerator=cpu "
            "max-batch=4 ! torch_seg_pass name=p ! tensor_sink name=out")
        assert self._segs(pipe) == [["src"], ["f"], ["p", "out"]]

    def test_fuse_false_gives_one_thread_per_element(self):
        pipe = parse_pipeline(
            "appsrc name=a ! torch_seg_pass name=b ! tensor_sink name=c", fuse=False)
        assert sorted(self._segs(pipe)) == [["a"], ["b"], ["c"]]

    def test_nns_fuse_env_default(self, monkeypatch):
        monkeypatch.setenv("NNS_FUSE", "0")
        assert not parse_pipeline("appsrc ! tensor_sink")._fuse
        monkeypatch.setenv("NNS_FUSE", "1")
        assert parse_pipeline("appsrc ! tensor_sink")._fuse

    def test_fused_chain_delivers_and_fails_on_the_element(self):
        pipe = parse_pipeline(
            "appsrc name=a ! torch_seg_pass name=b ! tensor_decoder mode=image_labeling ! "
            "tensor_sink name=d")
        pipe.start()
        pipe["a"].push(np.float32([0.0, 3.0, 1.0]))
        pipe["a"].push(np.zeros(0, np.float32))  # argmax of nothing: the decoder fails
        pipe["a"].end_of_stream()
        with pytest.raises(ValueError):
            pipe.wait(timeout=30)
        threads = list(pipe._threads)
        pipe.stop()
        assert len(threads) == 1 and not threads[0].is_alive()
        assert [f.meta["label_index"] for f in pipe["d"].frames] == [1]


def _sink_bytes(pipe):
    return [np.ascontiguousarray(np.asarray(f.tensors[0])).tobytes() for f in pipe["out"].frames]


class TestAsyncWindowParity:
    """FIFO emission byte-identical fused and unfused at depths 1, 4 and 8,
    lane on and off; at depth > 1 every wait before a batch completed
    happens on the window's reaper thread."""

    def _run(self, fuse, depth, lane, n=24):
        pipe = parse_pipeline(
            "appsrc name=src max-buffers=256 ! tensor_filter name=f framework=async-sim "
            f"custom=compute_ms:3,transfer_ms:1 max-batch=4 dispatch-depth={depth} "
            f"ingest-lane={lane} ! torch_seg_pass ! tensor_sink name=out", fuse=fuse)
        pipe.start()
        for i in range(n):
            pipe["src"].push(np.float32([i]))
        pipe["src"].end_of_stream()
        be = pipe["f"].backend
        pipe.wait(timeout=30)
        out = _sink_bytes(pipe)
        foreign = [t for t in be.blocking_syncs if not t.endswith("-reaper")]
        pipe.stop()
        return out, foreign

    @pytest.mark.parametrize("lane", ["on", "off"])
    @pytest.mark.parametrize("depth", [1, 4, 8])
    def test_fifo_emission_byte_identical(self, depth, lane):
        fused, f_foreign = self._run(True, depth, lane)
        unfused, u_foreign = self._run(False, depth, lane)
        assert fused == unfused
        assert fused == [np.float32([2.0 * i + 1.0]).tobytes() for i in range(24)]
        if depth > 1:
            assert f_foreign == [] and u_foreign == []


def test_jax_and_port_pipelines_emit_the_same_bytes():
    """One seeded stream through the JAX pipeline (jax-xla, depth 4, lane
    on) and the port's (torch-cuda on the CPU, the same affine, the same
    feed): byte-identical float32 outputs, in order."""
    frames = np.random.default_rng(7).standard_normal((37, 5)).astype(np.float32)

    def run(parse, framework, extra=""):
        pipe = parse(
            f"appsrc name=src ! tensor_filter name=f framework={framework} model=seg_affine "
            f"max-batch=4 dispatch-depth=4 ingest-lane=on {extra} ! tensor_sink name=out")
        pipe.start()
        try:
            for i, x in enumerate(frames):
                pipe["src"].push(x, pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=60)
        finally:
            pipe.stop()
        assert [f.pts for f in pipe["out"].frames] == list(range(len(frames)))
        return _sink_bytes(pipe)

    want = run(jax_parse_pipeline, "jax-xla")
    assert want == [(x * 2.0 + 1.0).tobytes() for x in frames]
    assert run(parse_pipeline, "torch-cuda", "accelerator=cpu") == want
