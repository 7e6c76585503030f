"""The port's native C++ core (``nnstreamer_tpu_torch/native``) against the
JAX package's: every case of ``tests/test_native_core.py`` runs on both
packages' ``NativeMailbox``, ``BufferPool`` and ``SampleReader``
(parametrised by package).  The port's scheduler and ``appsrc`` keep
``queue.Queue`` (on the card path a ran slower on native mailboxes); with
``NativeMailbox`` swapped in, as ``chip_smoke.py`` p5 does to measure it,
an expired drain and the watchdog count the same as on ``queue.Queue``
and in the JAX package.

Tolerance: exact (FIFO order, values, reference counts, byte contents,
frame counts); the one timing bound is the JAX test's own (a parked
``get`` wakes within 0.1 s of the ``put``).  Cases skip with a reason
where ``g++`` cannot build the core.
"""

import queue
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nnstreamer_tpu.native import runtime as jax_runtime
from nnstreamer_tpu_torch.elements import basic as port_basic
from nnstreamer_tpu_torch.native import runtime as port_runtime
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from nnstreamer_tpu_torch.pipeline import pipeline as port_pipeline
from torch_parity import assert_frames_equal, run

torch.set_num_threads(2)


def _built(mod) -> bool:
    """Build (or load) a package's core; the JAX runtime builds in the
    background unless asked to block."""
    return mod.available() if mod is port_runtime else mod.available(block=True)


@pytest.fixture(params=["port", "jax"])
def rt(request):
    mod = port_runtime if request.param == "port" else jax_runtime
    if not _built(mod):
        pytest.skip(f"the {request.param} native core cannot be built here (no g++)")
    return mod


# -- NativeMailbox ------------------------------------------------------------------------

def test_fifo_roundtrip(rt):
    mb = rt.NativeMailbox(8)
    items = [(i, np.arange(i + 1)) for i in range(5)]
    for it in items:
        mb.put(it, timeout=1)
    assert mb.qsize() == 5
    out = [mb.get(timeout=1) for _ in range(5)]
    assert [o[0] for o in out] == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(out[3][1], np.arange(4))
    mb.close()


def test_full_and_empty(rt):
    mb = rt.NativeMailbox(2)
    mb.put_nowait("a")
    mb.put_nowait("b")
    with pytest.raises(queue.Full):
        mb.put("c", timeout=0.05)
    assert mb.get_nowait() == "a"
    assert mb.get_nowait() == "b"
    with pytest.raises(queue.Empty):
        mb.get(timeout=0.05)
    mb.close()


def test_refcounts_balanced(rt):
    mb = rt.NativeMailbox(4)
    obj = object()
    base = sys.getrefcount(obj)
    for _ in range(10):
        mb.put(obj, timeout=1)
        got = mb.get(timeout=1)
        assert got is obj
    del got
    assert sys.getrefcount(obj) == base
    mb.put(obj, timeout=1)  # leftover items are released by close()
    assert sys.getrefcount(obj) == base + 1
    mb.close()
    assert sys.getrefcount(obj) == base


def test_get_many_bulk_and_refcounts(rt):
    mb = rt.NativeMailbox(32)
    obj = object()
    base = sys.getrefcount(obj)
    for i in range(10):
        mb.put((i, obj), timeout=1)
    first = mb.get_many(4, timeout=1)
    assert [p[0] for p in first] == [0, 1, 2, 3]
    rest = mb.get_many(32, timeout=1)  # drains without waiting
    assert [p[0] for p in rest] == [4, 5, 6, 7, 8, 9]
    with pytest.raises(queue.Empty):
        mb.get_many(4, timeout=0.05)
    del first, rest
    assert sys.getrefcount(obj) == base  # one DecRef per popped item
    mb.close()


def test_put_many_consumes_what_fits_and_releases_the_rest(rt):
    mb = rt.NativeMailbox(3)
    obj = object()
    base = sys.getrefcount(obj)
    assert mb.put_many([(i, obj) for i in range(5)], timeout=0.05) == 3
    assert sys.getrefcount(obj) == base + 3  # the tail's references were released
    assert [p[0] for p in mb.get_many(8, timeout=1)] == [0, 1, 2]
    assert sys.getrefcount(obj) == base
    mb.close()


def test_get_many_wakes_blocked_producer(rt):
    # a bulk pop frees several slots at once; every blocked producer wakes
    mb = rt.NativeMailbox(2)
    mb.put_nowait(1)
    mb.put_nowait(2)
    done = []

    def producer(v):
        mb.put(v, timeout=5)
        done.append(v)

    threads = [threading.Thread(target=producer, args=(v,)) for v in (3, 4)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    assert mb.get_many(2, timeout=1) == [1, 2]
    for t in threads:
        t.join(timeout=5)
    assert sorted(done) == [3, 4]
    assert sorted(mb.get_many(2, timeout=1)) == [3, 4]
    mb.close()


@pytest.mark.parametrize("capacity", [1, 4])
def test_blocking_handoff_across_threads(rt, capacity):
    mb = rt.NativeMailbox(capacity)
    got = []

    def consumer():
        for _ in range(20):
            got.append(mb.get(timeout=5))

    t = threading.Thread(target=consumer)
    t.start()
    for i in range(20):
        mb.put(i, timeout=5)
    t.join(timeout=10)
    assert got == list(range(20))
    mb.close()


def test_wakeup_latency_beats_poll_loop(rt):
    # a blocked get() wakes on put() at once, not at the next poll tick
    mb = rt.NativeMailbox(1)
    dt = []

    def consumer():
        t0 = time.perf_counter()
        mb.get(timeout=5)
        dt.append(time.perf_counter() - t0)

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.2)  # the consumer is parked in the native wait
    mb.put("x", timeout=1)
    t.join(timeout=5)
    assert 0.2 <= dt[0] < 0.3
    mb.close()


def test_use_after_close_raises_not_crashes(rt):
    mb = rt.NativeMailbox(2)
    mb.put("x")
    mb.close()
    with pytest.raises(queue.Full):
        mb.put("y")
    with pytest.raises(queue.Empty):
        mb.get(timeout=0.0)
    assert mb.qsize() == 0
    mb.close()  # idempotent


def test_close_while_waiter_parked(rt):
    mb = rt.NativeMailbox(1)
    errs = []

    def consumer():
        try:
            mb.get(timeout=5)
        except queue.Empty:
            errs.append("empty")

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.1)  # the consumer is parked in the native wait
    mb.close()       # wakes it without freeing memory under it
    t.join(timeout=5)
    assert errs == ["empty"]


# -- BufferPool ---------------------------------------------------------------------------

def test_pool_acquire_release_recycles(rt):
    pool = rt.BufferPool(1024, prealloc=2, alignment=64)
    ptr1, mv1 = pool.acquire()
    assert ptr1 % 64 == 0
    mv1[:4] = b"abcd"
    assert pool.outstanding == 1
    del mv1  # the memoryview goes before the block is reused
    pool.release(ptr1)
    assert pool.outstanding == 0
    ptr2, mv2 = pool.acquire()
    del mv2
    pool.release(ptr2)
    pool.destroy()


def test_pool_bad_alignment_and_double_release_rejected(rt):
    with pytest.raises(ValueError):
        rt.BufferPool(128, alignment=48)
    pool = rt.BufferPool(64, prealloc=1)
    ptr, mv = pool.acquire()
    del mv
    pool.release(ptr)
    with pytest.raises(ValueError):
        pool.release(ptr)
    pool.destroy()


# -- SampleReader -------------------------------------------------------------------------

def test_sample_reader_reads_match_the_file(rt, tmp_path):
    data = np.random.default_rng(0).integers(0, 255, (10, 64), np.uint8)
    path = tmp_path / "samples.bin"
    path.write_bytes(data.tobytes())
    r = rt.SampleReader(str(path), 64)
    assert r.total == 10
    for i in (0, 3, 9):
        np.testing.assert_array_equal(r.read(i), data[i])
    r.prefetch(5)  # advisory; must not fail
    with pytest.raises(IndexError):
        r.read(10)
    with pytest.raises(IndexError):
        r.read(-1)  # would wrap to 2^64-1 through ctypes
    r.prefetch(-1)  # clamped, must not crash
    r.close()
    with pytest.raises(OSError):
        rt.SampleReader(str(tmp_path / "missing.bin"), 8)


def test_both_cores_read_the_same_bytes(tmp_path):
    """The two packages' readers give the same samples of one file."""
    for mod in (port_runtime, jax_runtime):
        if not _built(mod):
            pytest.skip("a native core cannot be built here (no g++)")
    data = np.random.default_rng(1).integers(0, 255, (7, 24), np.uint8)
    path = tmp_path / "s.bin"
    path.write_bytes(data.tobytes())
    a, b = port_runtime.SampleReader(str(path), 24), jax_runtime.SampleReader(str(path), 24)
    for i in range(7):
        np.testing.assert_array_equal(a.read(i), b.read(i))
    a.close()
    b.close()


# -- the port's pipeline and the native mailbox -------------------------------------------

@pytest.fixture
def port_native():
    if not port_runtime.available():
        pytest.skip("the port's native core cannot be built here (no g++)")


def _native_mailboxes(monkeypatch):
    """Swap ``NativeMailbox`` in where the scheduler and ``appsrc`` take
    ``queue.Queue`` (``chip_smoke.py`` p5's switch)."""
    native = SimpleNamespace(Queue=port_runtime.NativeMailbox, Empty=queue.Empty,
                             Full=queue.Full)
    monkeypatch.setattr(port_pipeline, "queue", native)
    monkeypatch.setattr(port_basic, "_queue", native)


def test_pipeline_keeps_queue_queue_with_the_core_built(port_native):
    """The core loads, yet the scheduler's mailboxes and appsrc's queue stay
    ``queue.Queue``; the stream runs whole."""
    pipe = parse_pipeline("appsrc name=src ! tensor_transform mode=arithmetic option=mul:2 ! "
                          "tensor_sink name=out", fuse=False)
    pipe.start()
    assert type(pipe["out"]._mailbox) is queue.Queue
    assert type(pipe["src"]._q) is queue.Queue
    for i in range(16):
        pipe["src"].push(np.float32([i]))
    pipe["src"].end_of_stream()
    pipe.wait(timeout=30)
    pipe.stop()
    out = pipe["out"].frames
    assert len(out) == 16 and float(out[5].tensors[0][0]) == 10.0


def test_native_mailboxes_swapped_in_carry_the_stream(port_native, monkeypatch):
    """With ``NativeMailbox`` swapped in, every non-leaky mailbox is native,
    a leaky queue stays Python, and the frames equal the ``queue.Queue``
    run's."""
    text = ("appsrc name=src ! tensor_transform mode=arithmetic option=mul:2 ! "
            "queue leaky=downstream max-buffers=64 ! tensor_sink name=out")
    frames = [(np.float32([i]), float(i)) for i in range(16)]
    want = run(parse_pipeline, text, frames)["out"].frames
    _native_mailboxes(monkeypatch)
    pipe = parse_pipeline(text, fuse=False)
    pipe.start()
    try:
        kinds = {el.name: type(el._mailbox).__name__ for el in pipe.elements.values()
                 if el._mailbox is not None}
        assert type(pipe["src"]._q) is port_runtime.NativeMailbox
        for f, pts in frames:
            pipe["src"].push(f, pts=pts)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
    finally:
        pipe.stop()
    leaky = {el.name for el in pipe.elements.values() if getattr(el, "leaky_policy", "")}
    assert leaky and {kinds[n] for n in leaky} == {"_LeakyMailbox"}
    assert {k for n, k in kinds.items() if n not in leaky} == {"NativeMailbox"}
    assert_frames_equal(pipe["out"].frames, want)


def _gated_run(parse, register, unregister):
    """Ten frames into a filter whose callable blocks until the halt of an
    expiring drain releases it: nine wait in its mailbox, one is in the
    call.  Returns the mailbox types, whether the watchdog read the
    mailbox's depth, whether it flagged the stall, and dropped + delivered
    (every frame counted once)."""
    go = threading.Event()
    register("gate", lambda xs: (go.wait(10), [x * 2 for x in xs])[1])
    try:
        pipe = parse("appsrc name=src max-buffers=16 ! tensor_filter name=f "
                     "framework=custom-easy model=gate stall-timeout=0.1 ! "
                     "tensor_sink name=out", fuse=False)
        pipe.start()
        kinds = {type(pipe["f"]._mailbox).__name__, type(pipe["out"]._mailbox).__name__}
        for i in range(10):
            pipe["src"].push(np.float32([i]))
        end = time.monotonic() + 10
        while pipe["f"]._mailbox.qsize() < 9 and time.monotonic() < end:
            time.sleep(0.01)
        watched = pipe._watches["f"].qsize() == pipe["f"]._mailbox.qsize() == 9
        time.sleep(0.3)  # the watchdog sees the filter stalled
        halt = pipe._halt_workers

        def halt_then_release():
            pipe._stop_flag.set()
            go.set()  # the call returns after the halt: its output is refused
            halt()

        pipe._halt_workers = halt_then_release
        r = pipe.drain(timeout=0.2)
        stalls = pipe.health()["f"]["stalls"]
        delivered = len(pipe["out"].frames)
        pipe.stop()
    finally:
        go.set()
        unregister("gate")
    return kinds, watched, stalls >= 1, r["dropped"] + delivered


def test_drain_and_watchdog_count_alike_on_either_mailbox(monkeypatch):
    """The accounting of an expired drain is the same on ``queue.Queue``,
    on native mailboxes swapped in and in the JAX package: every frame
    counted once, the one whose output the halt refused included."""
    from nnstreamer_tpu.backends import register_custom_easy as jax_register
    from nnstreamer_tpu.backends import unregister_custom_easy as jax_unregister
    from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
    from nnstreamer_tpu_torch.backends import register_custom_easy, unregister_custom_easy

    if not port_runtime.available():
        pytest.skip("the port's native core cannot be built here (no g++)")
    port = (parse_pipeline, register_custom_easy, unregister_custom_easy)
    python = _gated_run(*port)
    jax = _gated_run(jax_parse, jax_register, jax_unregister)
    _native_mailboxes(monkeypatch)
    native = _gated_run(*port)
    assert native[0] == {"NativeMailbox"} and python[0] == {"Queue"}
    assert native[1:] == python[1:] == jax[1:] == (True, True, 10)


def test_no_native_env_disables_the_core(monkeypatch):
    """``NNS_TPU_NO_NATIVE`` before the first load (the reference's
    switch): the core is not loaded and a native class refuses to start."""
    monkeypatch.setattr(port_runtime, "_lib", None)
    monkeypatch.setenv("NNS_TPU_NO_NATIVE", "1")
    assert not port_runtime.available()
    with pytest.raises(RuntimeError, match="native core unavailable"):
        port_runtime.NativeMailbox(4)
