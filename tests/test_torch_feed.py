"""The port's asynchronous device feed: ``core/feed.py`` and the filter's
``dispatch-depth`` / ``ingest-lane``.

Holds on the port the contracts of ``tests/test_feed.py`` (the window's
FIFO completion and error placement, Flush/close, ``dispatch_waits``, the
lane's pooled stacking, discard, staging errors, loud close) and of
``tests/test_filter_element.py`` ``TestDispatchDepth`` / ``TestIngestLane``
(through the port's ``async-sim`` backend and the torch-cuda backend on
the CPU), plus two aliasing checks of the CPU placement: staged tensors
and emitted frames never share the pooled staging memory.
"""

import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.backends.base import FilterBackend, register_backend
from nnstreamer_tpu_torch.backends.torch_cuda import (
    TorchCuda,
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.core import registry
from nnstreamer_tpu_torch.core.buffer import (
    DeviceBufferPool,
    Event,
    Flush,
    HostCopy,
    TensorFrame,
    materialize,
    start_host_copies,
)
from nnstreamer_tpu_torch.core.feed import CompletionWindow, HostStagingLane
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.pipeline import ElementError, parse_pipeline

torch.set_num_threads(2)


class GateMaterializer:
    """materialize() blocks until the test releases that entry; entries
    release in any order the test chooses (the window must still emit
    FIFO).  A payload of Exception type raises instead."""

    def __init__(self):
        self.events = {}
        self.lock = threading.Lock()

    def _event(self, token):
        with self.lock:
            return self.events.setdefault(token, threading.Event())

    def release(self, token):
        self._event(token).set()

    def __call__(self, out_b):
        token = out_b[0]
        self._event(token).wait(timeout=10)
        if isinstance(token, type) and issubclass(token, BaseException):
            raise token("materialization failed")
        return [np.float32([token])]


class TestCompletionWindow:
    def test_pop_ready_is_fifo_and_nonblocking(self):
        gate = GateMaterializer()
        win = CompletionWindow("t", materialize=gate)
        try:
            for i in range(3):
                win.park([i], payload=i)
            assert win.pop_ready() == []  # nothing completed: no block
            gate.release(1)  # out-of-order completion...
            time.sleep(0.05)
            assert win.pop_ready() == []  # ...must NOT emit 1 before 0
            gate.release(0)
            deadline = time.monotonic() + 5
            got = []
            while len(got) < 2 and time.monotonic() < deadline:
                got += win.pop_ready()
            assert [p for _, p in got] == [0, 1]
            assert [float(m[0][0]) for m, _ in got] == [0.0, 1.0]
            gate.release(2)
            assert win.wait_oldest(timeout=5)
            assert [p for _, p in win.pop_ready()] == [2]
            assert win.dwell.count == 3
        finally:
            win.close()

    def test_error_entry_raises_after_good_prefix(self):
        gate = GateMaterializer()
        win = CompletionWindow("t", materialize=gate)
        try:
            win.park([7], payload="ok")
            win.park([RuntimeError], payload="bad")
            gate.release(7)
            gate.release(RuntimeError)
            deadline = time.monotonic() + 5
            while win.reaped < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert [p for _, p in win.pop_ready()] == ["ok"]
            with pytest.raises(RuntimeError, match="materialization"):
                win.pop_ready()
            assert len(win) == 0
        finally:
            win.close()

    def test_clear_discards_and_reaper_survives(self):
        gate = GateMaterializer()
        win = CompletionWindow("t", materialize=gate)
        try:
            win.park([0], payload="a")
            win.park([1], payload="b")
            assert win.clear() == ["a", "b"]
            assert len(win) == 0
            gate.release(0)
            gate.release(1)
            win.park([2], payload="c")
            gate.release(2)
            assert win.wait_oldest(timeout=5)
            assert [p for _, p in win.pop_ready()] == ["c"]
        finally:
            win.close()

    def test_close_stops_reaper_and_park_reopens(self):
        win = CompletionWindow("t", materialize=lambda o: [np.float32(o)])
        win.park([1.0], payload="x")
        deadline = time.monotonic() + 5
        while not win.oldest_ready() and time.monotonic() < deadline:
            time.sleep(0.01)
        reaper = win._reaper
        win.close()
        assert reaper is not None and not reaper.is_alive()
        win.park([2.0], payload="y")
        assert win.wait_oldest(timeout=5)
        assert [p for _, p in win.pop_ready()] == ["y"]
        win.close()

    def test_wait_oldest_counts_backpressure(self):
        gate = GateMaterializer()
        win = CompletionWindow("t", materialize=gate)
        try:
            win.park([0], payload="a")
            assert not win.wait_oldest(timeout=0.05)
            assert win.dispatch_waits == 1
            gate.release(0)
            assert win.wait_oldest(timeout=5)
        finally:
            win.close()


class TestHostStagingLane:
    def test_stacks_and_places_through_pool(self):
        pool = DeviceBufferPool(max_per_key=4)
        lane = HostStagingLane(lambda arrs: [np.array(a) for a in arrs], pool=pool, name="t")
        try:
            frames = [[np.full((2,), i, np.float32)] for i in range(4)]
            dev = lane.submit(frames).result()
            assert len(dev) == 1 and dev[0].shape == (4, 2)
            np.testing.assert_array_equal(
                dev[0], np.repeat([[0.0], [1.0], [2.0], [3.0]], 2, axis=1))
            lane.submit(frames).result()  # reuses the released buffer
            assert pool.reused >= 1 and pool.allocated <= 2
            assert lane.staged == 2 and lane.stack_s > 0
        finally:
            lane.close()

    def test_discard_drops_device_refs(self):
        lane = HostStagingLane(lambda arrs: [np.array(a) for a in arrs], name="t")
        try:
            job = lane.submit([[np.zeros((2,), np.float32)]])
            job.discard()
            assert job.wait(timeout=5)
            assert job._dev is None
        finally:
            lane.close()

    def test_staging_error_reaches_collector(self):
        def bad(arrs):
            raise ValueError("no device")

        lane = HostStagingLane(bad, name="t")
        try:
            job = lane.submit([[np.zeros((2,), np.float32)]])
            assert job.wait(timeout=5)
            with pytest.raises(ValueError, match="no device"):
                job.result()
        finally:
            lane.close()

    def test_close_abandons_queued_jobs_loudly(self):
        release = threading.Event()

        def slow(arrs):
            release.wait(timeout=10)
            return [np.array(a) for a in arrs]

        lane = HostStagingLane(slow, name="t")
        first = lane.submit([[np.zeros((2,), np.float32)]])
        queued = lane.submit([[np.zeros((2,), np.float32)]])
        lane.close()
        assert queued.wait(timeout=5)
        with pytest.raises(RuntimeError, match="closed"):
            queued.result()
        release.set()
        assert first.wait(timeout=5)


class TestBufferPool:
    def test_placement_keys_rings_and_lru_bound(self):
        pool = DeviceBufferPool(max_per_key=2)
        a = pool.acquire((2, 3), np.uint8, placement=("dev", "cpu", None))
        assert type(a) is np.ndarray and a.shape == (2, 3)  # CPU placement: plain numpy
        pool.release(a, placement=("dev", "cpu", None))
        b = pool.acquire((2, 3), np.uint8, placement=("dev", "other", 1))
        assert b is not a  # another placement never gets this ring's buffer
        assert pool.acquire((2, 3), np.uint8, placement=("dev", "cpu", None)) is a
        assert pool.reuse_rate == pytest.approx(1 / 3)
        for k in range(DeviceBufferPool.MAX_KEYS + 3):
            pool.release(np.empty((k + 1,), np.float32))
        assert pool.rings_evicted >= 3

    def test_concurrent_acquire_never_hands_one_buffer_to_two_holders(self):
        """16 threads acquire, stamp, check and release one ring with a
        shortened switch interval: a buffer handed out twice would show
        another thread's stamp, and a lost counter update a wrong total."""
        import sys

        pool = DeviceBufferPool(max_per_key=4)
        errors, rounds, workers = [], 200, 16

        def work(tag):
            for _ in range(rounds):
                buf = pool.acquire((64,), np.int64)
                buf[:] = tag
                if not (buf == tag).all():
                    errors.append(tag)
                pool.release(buf)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(t,)) for t in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert pool.allocated + pool.reused == workers * rounds

    def test_host_copies_of_cpu_tensors_are_complete(self):
        t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        fake = np.float32([1.0])
        started = start_host_copies([t, fake])
        assert isinstance(started[0], HostCopy) and started[0].event is None
        assert started[1] is fake
        got = materialize(started)
        np.testing.assert_array_equal(got[0], t.numpy())
        np.testing.assert_array_equal(got[1], fake)


# -- the filter -------------------------------------------------------------
class _HostScaler(FilterBackend):
    """A host backend (numpy out, no staging): y = 2x."""

    NAME = "torch-feed-host-scaler"

    def set_input_info(self, in_spec):
        return in_spec

    def invoke(self, inputs):
        return [np.asarray(a) * 2 for a in inputs]

    def invoke_batch(self, inputs):
        return [np.asarray(a) * 2 for a in inputs]


class _Marker(Event):
    """An application event travelling in-band behind frames."""


class _Affine(torch.nn.Module):
    def forward(self, x):
        return x * 2.0 + 1.0


class _Identity(torch.nn.Module):
    def forward(self, x):
        return x


@pytest.fixture(scope="module", autouse=True)
def _models():
    register_backend(_HostScaler)
    register_torch_model("feed_affine", _Affine())
    register_torch_model("feed_identity", _Identity())
    yield
    registry.unregister(registry.KIND_FILTER, _HostScaler.NAME)
    unregister_torch_model("feed_affine")
    unregister_torch_model("feed_identity")


def _filter(framework, **props):
    el = TensorFilter("f")
    el.set_property("framework", framework)
    for k, v in props.items():
        el.set_property(k.replace("_", "-"), v)
    return el


def _batch(i0, n=4):
    return [TensorFrame([np.float32([i])]) for i in range(i0, i0 + n)]


def _vals(outs):
    return [float(np.asarray(f.tensors[0])[0]) for _, f in outs]


class TestDispatchDepth:
    def _run(self, n, extra=""):
        pipe = parse_pipeline(
            "appsrc name=src ! tensor_filter name=f model=feed_affine accelerator=cpu "
            f"max-batch=4 {extra} ! tensor_sink name=out")
        pipe.start()
        for i in range(n):
            pipe["src"].push(np.float32([i]), pts=i * 0.01)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
        frames = pipe["out"].frames
        pipe.stop()
        return frames

    def test_order_and_completeness_at_default_depth(self):
        frames = self._run(50)
        assert [float(f.tensors[0][0]) for f in frames] == [2.0 * i + 1.0 for i in range(50)]
        assert [f.pts for f in frames] == pytest.approx([i * 0.01 for i in range(50)])

    @pytest.mark.parametrize("extra", ["dispatch-depth=1", "dispatch-depth=64"])
    def test_sync_and_deep_windows_are_equivalent(self, extra):
        # depth 1 is synchronous; depth 64 holds everything until EOS drains it
        frames = self._run(30, extra)
        assert [float(f.tensors[0][0]) for f in frames] == [2.0 * i + 1.0 for i in range(30)]

    def test_window_bookkeeping_unit(self):
        """Parking never blocks, emission is FIFO and completion-gated
        (manual-completion fake device), EOS drains, Flush discards; the
        lane is off, so this pins the WINDOW alone."""
        el = _filter("async-sim", custom="manual:1", ingest_lane="off", max_batch=4,
                     dispatch_depth=3)
        el.start()
        try:
            be = el.backend
            assert el.handle_frame_batch(0, _batch(0)) == [] and len(el._inflight) == 1
            assert el.handle_frame_batch(0, _batch(4)) == [] and len(el._inflight) == 2
            assert el.pending_frames() == 8
            be.release_one()
            out3 = el.handle_frame_batch(0, _batch(8))
            assert _vals(out3) == [1.0, 3.0, 5.0, 7.0] and len(el._inflight) == 2
            be.release_all()
            drained = el.handle_eos(0)
            assert _vals(drained) == [2.0 * i + 1.0 for i in range(4, 12)]
            assert not len(el._inflight)
            el.handle_frame_batch(0, _batch(12))
            assert len(el._inflight) == 1
            el.handle_event(0, Flush())
            assert not len(el._inflight) and el.pending_frames() == 0
        finally:
            el.stop()

    def test_idle_drains_parked_window_without_eos(self):
        pipe = parse_pipeline(
            "appsrc name=src ! tensor_filter name=f model=feed_affine accelerator=cpu "
            "max-batch=4 dispatch-depth=64 ! tensor_sink name=out")
        pipe.start()
        seen = []
        pipe["out"].connect_new_data(lambda f: seen.append(float(f.tensors[0][0])))
        for i in range(12):
            pipe["src"].push(np.float32([i]))
        deadline = time.monotonic() + 10
        while len(seen) < 12 and time.monotonic() < deadline:
            time.sleep(0.02)
        try:
            assert seen == [2.0 * i + 1.0 for i in range(12)]
        finally:
            pipe["src"].end_of_stream()
            pipe.wait(timeout=10)
            pipe.stop()

    def test_event_does_not_overtake_parked_frames(self):
        # a batch in service for 200 ms is still parked when the event comes
        el = _filter("async-sim", custom="compute_ms:200", max_batch=4, dispatch_depth=8,
                     ingest_lane="off")
        el.start()
        try:
            assert el.handle_frame_batch(0, _batch(0)) == []
            outs = el.handle_event(0, _Marker())
            assert [type(o).__name__ for _, o in outs] == ["TensorFrame"] * 4 + ["_Marker"]
            assert not len(el._inflight)
        finally:
            el.stop()

    def test_sync_degrade_latches_capability_once(self, caplog):
        import logging

        el = _filter(_HostScaler.NAME, max_batch=4, dispatch_depth=4)
        el.start()
        try:
            assert el._lane is None and el._win_async is None
            with caplog.at_level(logging.INFO):
                for k in range(3):
                    outs = el.handle_frame_batch(0, _batch(4 * k))
                    assert len(outs) == 4 and not len(el._inflight)  # synchronous
            assert el._win_async is False
            assert sum("degrades to the synchronous path" in r.message
                       for r in caplog.records) == 1
        finally:
            el.stop()

    def test_torch_outputs_park_and_reap(self):
        el = _filter("torch-cuda", model="feed_affine", accelerator="cpu", max_batch=4,
                     dispatch_depth=4, ingest_lane="off")
        el.start()
        try:
            out = el.handle_frame_batch(0, _batch(0)) + el.handle_eos(0)
            assert _vals(out) == [1.0, 3.0, 5.0, 7.0]
            assert el._win_async is True and el._inflight.reaped == 1
        finally:
            el.stop()


class TestIngestLane:
    def test_lane_defers_dispatch_by_one_batch_fifo(self):
        el = _filter("async-sim", ingest_lane="on", max_batch=4, dispatch_depth=1)
        el.start()
        try:
            assert el._lane is not None
            assert el.handle_frame_batch(0, _batch(0)) == []  # staged, not dispatched
            assert el.pending_frames() == 4
            assert _vals(el.handle_frame_batch(0, _batch(4))) == [1.0, 3.0, 5.0, 7.0]
            drained = el.handle_eos(0)  # flushes the staged batch 1
            assert _vals(drained) == [2.0 * i + 1.0 for i in range(4, 8)]
            assert el.pending_frames() == 0 and el._lane.staged == 2
        finally:
            el.stop()

    def test_lane_flush_discards_staged_batch(self):
        el = _filter("async-sim", ingest_lane="on", max_batch=4)
        el.start()
        try:
            el.handle_frame_batch(0, _batch(0))
            assert el.pending_frames() == 4
            el.handle_event(0, Flush())
            assert el.pending_frames() == 0
            assert el.handle_eos(0) == []
        finally:
            el.stop()

    @pytest.mark.parametrize("framework,props,match", [
        (_HostScaler.NAME, {"max_batch": 4}, "staged"),
        ("async-sim", {"max_batch": 1}, "max-batch>1"),
        ("async-sim", {"max_batch": 4, "ingest_lane": "sideways"}, "auto|on|off"),
    ])
    def test_lane_on_refusals(self, framework, props, match):
        el = _filter(framework, **{"ingest_lane": "on", **props})
        with pytest.raises(ElementError, match=match):
            el.start()
        assert el.backend is None  # nothing left open

    def test_lane_auto_stays_off_without_batching_or_staging(self):
        for framework, mb in ((_HostScaler.NAME, 4), ("async-sim", 1)):
            el = _filter(framework, max_batch=mb)
            el.start()
            try:
                assert el._lane is None
            finally:
                el.stop()

    def test_lane_staging_error_attributed_on_dispatch(self):
        el = _filter("async-sim", ingest_lane="on", max_batch=4)
        el.start()
        try:
            el.handle_frame_batch(0, [TensorFrame([np.zeros((2,), np.float32)]),
                                      TensorFrame([np.zeros((3,), np.float32)])])
            with pytest.raises(ValueError):
                el.handle_eos(0)
        finally:
            el.stop()

    def test_lane_error_stops_pipeline_and_wait_reraises(self):
        pipe = parse_pipeline(
            "appsrc name=src ! tensor_filter name=f framework=async-sim max-batch=4 "
            "batch-timeout=500 ! tensor_sink name=out")
        pipe.start()
        pipe["src"].push(np.zeros((2,), np.float32))
        pipe["src"].push(np.zeros((3,), np.float32))  # ragged: cannot stack
        pipe["src"].end_of_stream()
        with pytest.raises(ValueError):
            pipe.wait(timeout=30)
        pipe.stop()


class TestCpuAliasing:
    def test_staged_batch_keeps_its_values_after_the_next_one(self):
        """Stage batch A, then B through one pooled ring: A's staged tensors
        still hold A's values (``torch.from_numpy`` alone would alias the
        staging buffer B is stacked into)."""
        be = TorchCuda()
        be.open("feed_identity", {"accelerators": ["cpu"]})
        pool = DeviceBufferPool(max_per_key=1)
        lane = HostStagingLane(be.to_device, pool=pool, name="alias",
                               placement=be.staging_placement())
        try:
            a = lane.submit([[np.full((3,), i, np.float32)] for i in range(4)]).result()
            b = lane.submit([[np.full((3,), 10 + i, np.float32)] for i in range(4)]).result()
            assert pool.reused == 1  # B was stacked into A's buffer
            np.testing.assert_array_equal(a[0].numpy()[:, 0], [0, 1, 2, 3])
            np.testing.assert_array_equal(b[0].numpy()[:, 0], [10, 11, 12, 13])
        finally:
            lane.close()
            be.close()

    def test_sink_holding_frames_across_the_ring_sees_them_unchanged(self):
        """An identity model returns its (staged) input: frames a sink keeps
        across more batches than the ring holds must keep their values."""
        n = 4 * 12  # 12 micro-batches, more than the ring's 8 buffers
        pipe = parse_pipeline(
            "appsrc name=src ! tensor_filter name=f model=feed_identity accelerator=cpu "
            "max-batch=4 batch-timeout=500 ingest-lane=on dispatch-depth=4 "
            "! tensor_sink name=out")
        pipe.start()
        for i in range(n):
            pipe["src"].push(np.full((3,), i, np.float32))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
        staged = pipe["f"]._lane.staged
        pipe.stop()
        assert staged == 12
        got = [np.asarray(f.tensors[0]) for f in pipe["out"].frames]
        assert [g.tolist() for g in got] == [[float(i)] * 3 for i in range(n)]
