"""Port parity: a composed NNStreamer pipeline (the graph of
``chip_smoke.py``'s path e at a tiny width) and the scheduler's ``Flush``,
against the JAX package, on the CPU.

Path e's graph: ``videotestsrc ! tensor_converter ! tee``.  One branch
runs ``queue ! tensor_filter ! tensor_decoder mode=image_labeling``.  The
other runs ``queue ! tensor_transform (arithmetic) ! tensor_transform
(clamp)``.  The branches meet in ``tensor_mux`` and part again in
``tensor_demux``.  Both packages parse the same text.  The model is a
registered tiny module: the channel means of each frame times a seeded
(3, 10) matrix, in float32.  The labels, the ``pre`` tensors and the sinks'
frame counts must be equal; the ``pre`` tensors bit for bit.  Each must
also equal the same computation on the regenerated frames: labels from
numpy's float64 logits, where the top-2 margin is wide, and ``pre`` from
numpy's ``clip((x.astype(float32) + -127.5) / 127.5, -1, 1)``.

Path e's second phase (``chip_smoke.composed_e2_text``) runs here too, on
CPU torch tensors in place of card tensors, and so does a block of torch
frames: a micro-batch that reaches a per-frame element or a splitting sink
is split into rows that stay torch tensors where they live.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.core.buffer import Event as JaxEvent
from nnstreamer_tpu.core.buffer import Flush as JaxFlush
from nnstreamer_tpu.pipeline import Pipeline as JaxPipeline
from nnstreamer_tpu.pipeline import TransformElement as JaxTransform
from nnstreamer_tpu.pipeline import make_element as jax_make
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.core.buffer import BatchFrame, Event, Flush, HostCopy
from nnstreamer_tpu_torch.pipeline import Pipeline, TransformElement, make_element
from torch_parity import assert_frames_equal, jax_parse, run, torch_parse

torch.set_num_threads(2)

MODEL, SIZE, FRAMES, CLASSES, SEED = "torch_composed_tiny", 16, 24, 10, 3
W = np.random.default_rng(1).normal(0, 1, (3, CLASSES)).astype(np.float32)


class _Tiny(torch.nn.Module):
    def forward(self, x):
        return x.to(torch.float32).mean(dim=(-3, -2)) @ torch.from_numpy(W)


@pytest.fixture(scope="module", autouse=True)
def _models():
    register_torch_model(MODEL, _Tiny())
    register_jax_model(MODEL, lambda p, xs: [jnp.mean(xs[0].astype(jnp.float32), axis=(-3, -2))
                                             @ jnp.asarray(W)])
    yield
    unregister_torch_model(MODEL)
    unregister_jax_model(MODEL)


def path_e(framework, labels):
    return (
        f"videotestsrc num-buffers={FRAMES} width={SIZE} height={SIZE} pattern=random "
        f"seed={SEED} ! tensor_converter ! tee name=t "
        f"t. ! queue ! tensor_filter framework={framework} model={MODEL} max-batch=8 "
        f"batch-timeout=200 ! tensor_decoder mode=image_labeling option1={labels} ! m. "
        "t. ! queue ! tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,"
        "div:127.5 ! tensor_transform mode=clamp option=-1:1 ! m. "
        "tensor_mux name=m ! tensor_demux name=d  d. ! tensor_sink name=labels  "
        "d. ! tensor_sink name=pre")


def test_path_e_matches_jax(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"class{i}" for i in range(CLASSES)))
    want = run(jax_parse, path_e("jax-xla", labels), timeout=120)
    got = run(torch_parse, path_e("torch-cuda accelerator=cpu", labels), timeout=120)
    for sink in ("labels", "pre"):
        assert len(got[sink].frames) == len(want[sink].frames) == FRAMES
        assert_frames_equal(got[sink].frames, want[sink].frames, meta=("label_index", "label"))
    # against the computation itself, on the regenerated frames
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(FRAMES)]
    logits = np.stack([f.astype(np.float64).mean(axis=(0, 1)) for f in frames]) @ W
    top2 = np.sort(logits, axis=1)[:, -2:]
    wide = top2[:, 1] - top2[:, 0] > 1e-3
    idx = np.array([f.meta["label_index"] for f in got["labels"].frames])
    assert wide.sum() >= FRAMES // 2
    np.testing.assert_array_equal(idx[wide], logits.argmax(axis=1)[wide])
    for f, x in zip(got["pre"].frames, frames):
        np.testing.assert_array_equal(
            f.tensors[0], np.clip((x.astype(np.float32) + -127.5) / 127.5, -1, 1))
        assert f.tensors[0].dtype == np.float32
    assert [f.pts for f in got["pre"].frames] == [i * (1 / 30) for i in range(FRAMES)]


# -- micro-batches of torch tensors -----------------------------------------------


def test_batch_split_keeps_torch_rows_and_brings_host_copies_home():
    block = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    frame = BatchFrame(tensors=[block, HostCopy.start(block * 2), np.ones((3, 2))],
                       frames_info=[(float(i), None, {"i": i}) for i in range(3)])
    rows = frame.split()
    assert [f.pts for f in rows] == [0.0, 1.0, 2.0] and [f.meta for f in rows] == \
        [{"i": 0}, {"i": 1}, {"i": 2}]
    for b, f in enumerate(rows):
        assert isinstance(f.tensors[0], torch.Tensor) and torch.equal(f.tensors[0], block[b])
        assert f.tensors[0].data_ptr() == block[b].data_ptr()  # a view, not a copy
        assert type(f.tensors[1]) is np.ndarray and type(f.tensors[2]) is np.ndarray
        np.testing.assert_array_equal(f.tensors[1], block[b].numpy() * 2)
    assert all(type(t) is np.ndarray for f in frame.to_host().split() for t in f.tensors)


def test_pushed_torch_block_reaches_per_frame_elements_as_torch_rows():
    block = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (6, 4, 4, 3),
                                                               dtype=np.uint8))
    pipe = torch_parse(
        "appsrc name=src ! tee name=t  t. ! tensor_transform mode=typecast option=float32 ! "
        "tensor_sink name=rows to-host=false  t. ! tensor_sink name=kept to-host=false  "
        "t. ! tensor_sink name=host")
    pipe.start()
    try:
        pipe["src"].push_block(block, pts=[float(i) for i in range(6)])
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
    finally:
        pipe.stop()
    for sink in ("rows", "kept", "host"):
        assert [f.pts for f in pipe[sink].frames] == [float(i) for i in range(6)]
    assert pipe["rows"].frames[0].tensors[0].dtype == torch.float32
    for i in range(6):
        assert isinstance(pipe["kept"].frames[i].tensors[0], torch.Tensor)
        assert torch.equal(pipe["kept"].frames[i].tensors[0], block[i])
        assert torch.equal(pipe["rows"].frames[i].tensors[0], block[i].to(torch.float32))
        np.testing.assert_array_equal(pipe["host"].frames[i].tensors[0], block[i].numpy())


def test_path_e2_graph_keeps_torch_tensors_where_they_live():
    """chip_smoke's phase e2 graph at 32x32, a float32 MobileNet of width
    0.35 on the CPU: frames pushed as torch tensors reach every sink as
    torch tensors, the filter's micro-batches too (whole at one sink, split
    into rows for a tensor_transform and by a sink), and every sink but the
    filter's equals the run fed numpy frames (``stand`` within rtol and
    atol 1e-5, the rest exactly)."""
    import chip_smoke

    text = chip_smoke.composed_e2_text(
        "arch:mobilenet_v2,dtype:float32,size:32,width:0.35,classes:10", SEED, 32)
    assert text.count("batch-through=true") == 1
    text = text.replace("batch-through=true", "batch-through=true accelerator=cpu")
    rng = np.random.default_rng(SEED)
    n = 20
    frames = [x // 2 if i % 2 == 0 else x
              for i, x in enumerate(rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8))]
    regions = np.array(chip_smoke.CROP_REGIONS, np.int32)

    def go(as_torch):
        pipe = torch_parse(text)
        pipe.start()
        try:
            for i, x in enumerate(frames):
                pipe["src"].push(torch.from_numpy(x) if as_torch else x, pts=float(i))
                pipe["regions"].push(regions, pts=float(i))
            pipe["src"].end_of_stream()
            pipe["regions"].end_of_stream()
            pipe.wait(timeout=120)
            return {s: pipe[s].frames for s in chip_smoke.COMPOSED_E2_SINKS}
        finally:
            pipe.stop()

    tor, host = go(True), go(False)
    for sink, got in tor.items():
        assert got and all(isinstance(t, torch.Tensor) for f in got for t in f.tensors), sink
    for run_ in (tor, host):
        rows = torch.cat([f.tensors[0] for f in run_["filter"]])
        assert len(rows) == len(run_["rows"]) == len(run_["logits"]) == n
        assert torch.equal(torch.stack([f.tensors[0] for f in run_["rows"]]), rows)
        assert torch.equal(torch.stack([f.tensors[0] for f in run_["logits"]]), rows * 2)
    for sink in chip_smoke.COMPOSED_E2_SINKS:
        if sink in ("filter", "rows", "logits"):
            continue
        assert len(tor[sink]) == len(host[sink]), sink
        for a, b in zip(tor[sink], host[sink]):
            for x, y in zip(a.tensors, b.tensors):
                x = x.numpy()
                assert (x.dtype, x.shape) == (y.dtype, y.shape), sink
                if sink == "stand":
                    np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)
                else:
                    np.testing.assert_array_equal(x, y, err_msg=sink)
    assert [bool((f.tensors[0] == 7).all()) for f in tor["if"]] == \
        [i % 2 == 0 for i in range(n)]


# -- Flush ------------------------------------------------------------------------


def _gate_cls(base, event_cls):
    class Gate(base):
        """Holds its first frame until released; records the events it
        sees, in order."""

        BATCH_AWARE = True

        def __init__(self, name=None):
            super().__init__(name)
            self.entered, self.release, self.events = threading.Event(), threading.Event(), []

        def transform(self, frame):
            self.entered.set()
            assert self.release.wait(30)
            return frame

        def handle_event(self, pad, event):
            self.events.append(getattr(event, "tag", type(event).__name__))
            return super().handle_event(pad, event)

    class Mark(event_cls):
        def __init__(self, tag):
            self.tag = tag

    return Gate, Mark


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_flush_drops_queued_frames_and_keeps_events_in_order(pkg):
    """A queue head's mailbox holds Flush, f1, A, f2, f3, B while its thread
    is busy with f0: the Flush drops f1, f2 and f3; A and B survive in
    order, and so does the EOS behind them."""
    if pkg == "jax":
        pipe_cls, make, transform, event, flush = (JaxPipeline, jax_make, JaxTransform,
                                                   JaxEvent, JaxFlush)
    else:
        pipe_cls, make, transform, event, flush = Pipeline, make_element, TransformElement, \
            Event, Flush
    gate_cls, mark = _gate_cls(transform, event)
    pipe = pipe_cls("flush")
    src, q, gate, sink = (make("appsrc", name="src"), make("queue", name="q"),
                          gate_cls("gate"), make("tensor_sink", name="out"))
    pipe.chain(src, q, gate, sink)
    pipe.start()
    try:
        src.push(np.int32([0]), pts=0.0)
        assert gate.entered.wait(10)
        src.push_event(flush())
        src.push(np.int32([1]), pts=1.0)
        src.push_event(mark("A"))
        src.push(np.int32([2]), pts=2.0)
        src.push(np.int32([3]), pts=3.0)
        src.push_event(mark("B"))
        end = time.monotonic() + 10
        while q._mailbox.qsize() < 6:
            assert time.monotonic() < end, "the queue's mailbox never filled"
            time.sleep(0.01)
        gate.release.set()
        while "B" not in gate.events:
            assert time.monotonic() < end + 10, "the events behind the flush never arrived"
            time.sleep(0.01)
        src.push(np.int32([4]), pts=4.0)  # after the flush: delivered
        src.end_of_stream()
        pipe.wait(timeout=30)
    finally:
        gate.release.set()
        pipe.stop()
    assert [int(f.tensors[0][0]) for f in sink.frames] == [0, 4]
    assert gate.events == ["Flush", "A", "B"]
