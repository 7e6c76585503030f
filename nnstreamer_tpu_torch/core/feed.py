"""Asynchronous device feed: the completion-driven dispatch window and the
double-buffered host-to-device staging lane.

Port of ``nnstreamer_tpu/core/feed.py``.  Both pieces keep the filter's
dispatch thread out of device I/O:

* :class:`CompletionWindow` parks dispatched micro-batches FIFO and hands
  the blocking device-to-host wait to a **reaper thread** per window.  On
  CUDA the copy itself was queued at park time, on the compute stream
  right behind the batch's launches, into pinned memory
  (``core.buffer.start_host_copies``); the reaper only waits on its event.
  The dispatch thread polls completed entries off the front; when the
  window is full it waits on a completion condition, never on the device.
* :class:`HostStagingLane` runs host-side batch stacking and the backend's
  ``to_device`` on a lane thread, through pooled staging buffers
  (:class:`~.buffer.DeviceBufferPool`, pinned for a CUDA placement): while
  batch k computes, batch k+1 is stacked and copied on a side stream.  The
  filter defers dispatch by exactly one batch.

Emission order stays strictly FIFO through both; the filter's
``pending_frames`` sums the window's payloads and the staged batch.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from .buffer import DeviceBufferPool
from .buffer import materialize as _materialize
from .liveness import ThreadBeat
from .telemetry import Log2Histogram


def _stack_into(rows: List[np.ndarray], out: np.ndarray) -> None:
    """``np.stack(rows, out=out)``, as ONE ``torch.stack`` call where the
    rows allow it: that releases the interpreter lock once for the whole
    copy, where numpy releases and re-takes it once per row, and every
    re-take waits behind the dispatch thread's Python.  Rows that do not
    match ``out`` in shape and dtype, or that torch cannot view, go through
    numpy (which raises for a ragged batch)."""
    shape, dtype = out.shape[1:], out.dtype
    if all(r.shape == shape and r.dtype == dtype and r.flags.writeable for r in rows):
        import torch

        try:
            src = [torch.from_numpy(r) for r in rows]
            dst = torch.from_numpy(out)
        except (TypeError, ValueError):  # a dtype torch lacks, negative strides
            pass
        else:
            torch.stack(src, out=dst)
            return
    np.stack(rows, out=out)


class _WindowEntry:
    __slots__ = ("out_b", "payload", "mats", "error", "done", "claimed", "t_park")

    def __init__(self, out_b, payload):
        self.out_b = out_b
        self.payload = payload
        self.mats: Optional[List[np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.done = False
        self.claimed = False
        self.t_park = time.perf_counter()


class CompletionWindow:
    """FIFO window of in-flight micro-batches, drained by completion.

    ``park()`` appends a dispatched batch's outputs (host copies already
    started); a lazy **reaper thread** materializes entries strictly in
    park order, so the blocking wait happens there.  ``pop_ready()``
    returns the completed prefix without blocking; ``wait_oldest()`` is
    the bounded backpressure wait for a full window.

    A materialization error is stored on its entry and re-raised from
    ``pop_ready()`` on the dispatch thread, once the completed entries
    ahead of it have been handed out, so it is the owning element's error
    exactly as a synchronous invoke error would be.

    ``clear()`` discards all entries (Flush); a reaper mid-wait on a
    cleared entry finishes harmlessly into the discarded carcass.
    ``close()`` also stops the reaper thread; a later ``park()`` reopens.
    """

    __slots__ = ("name", "_materialize", "_dq", "_cv", "_reaper", "_closed",
                 "reaped", "dispatch_waits", "dwell", "heartbeat")

    def __init__(self, name: str = "window", materialize: Optional[Callable] = None):
        self.name = name
        self._materialize = materialize or _materialize
        self._dq: "deque[_WindowEntry]" = deque()
        self._cv = threading.Condition()
        self._reaper: Optional[threading.Thread] = None
        self._closed = False
        # a reaper with parked entries and a stale beat is wedged inside a
        # device wait
        self.heartbeat = ThreadBeat(f"{name}-reaper")
        self.reaped = 0
        self.dispatch_waits = 0
        # park -> pop_ready dwell (single writer: the dispatch thread pops)
        self.dwell = Log2Histogram()

    def __len__(self) -> int:
        return len(self._dq)

    def park(self, out_b: Sequence[Any], payload: Any) -> None:
        with self._cv:
            self._closed = False
            self._dq.append(_WindowEntry(out_b, payload))
            if self._reaper is None or not self._reaper.is_alive():
                self._reaper = threading.Thread(
                    target=self._reap_loop, name=f"{self.name}-reaper", daemon=True)
                self.heartbeat.beat()
                self._reaper.start()
            self._cv.notify_all()

    def _reap_loop(self) -> None:
        while True:
            self.heartbeat.beat()
            with self._cv:
                entry = None
                while entry is None:
                    if self._closed:
                        return
                    for cand in self._dq:
                        if not cand.claimed:
                            entry = cand
                            break
                    if entry is None:
                        self._cv.wait()
                entry.claimed = True
            # beat after claiming, before the blocking wait: a healthy first
            # job after a long idle must not look wedged
            self.heartbeat.beat()
            try:
                mats = self._materialize(entry.out_b)
                err = None
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — crosses threads
                mats, err = None, e
            with self._cv:
                entry.mats, entry.error, entry.done = mats, err, True
                entry.out_b = None  # device/pinned refs released once synced
                self.reaped += 1
                self._cv.notify_all()

    def pop_ready(self) -> List[Tuple[Optional[List[np.ndarray]], Any]]:
        """(materialized outputs, payload) for every completed entry at the
        FRONT of the window, in order; never blocks.  An errored entry at
        the front raises (after the completed entries ahead of it were
        returned by the previous call)."""
        popped: List[_WindowEntry] = []
        err: Optional[BaseException] = None
        with self._cv:
            while self._dq and self._dq[0].done:
                if self._dq[0].error is not None:
                    if popped:
                        break  # deliver the good prefix first
                    err = self._dq.popleft().error
                    break
                popped.append(self._dq.popleft())
        if err is not None:
            raise err
        if popped:
            now = time.perf_counter()
            for e in popped:
                self.dwell.record(now - e.t_park)
        return [(e.mats, e.payload) for e in popped]

    def oldest_ready(self) -> bool:
        with self._cv:
            return not self._dq or self._dq[0].done

    def wait_oldest(self, timeout: float = 0.1) -> bool:
        """Bounded wait for the oldest entry's completion (the
        backpressure path for a full window).  True when the front is
        ready (or the window emptied)."""
        with self._cv:
            if self._dq and not self._dq[0].done:
                self.dispatch_waits += 1
            return self._cv.wait_for(lambda: not self._dq or self._dq[0].done, timeout=timeout)

    def payloads(self) -> List[Any]:
        """Snapshot of parked payloads, oldest first."""
        with self._cv:
            return [e.payload for e in self._dq]

    def clear(self) -> List[Any]:
        """Discard every parked entry (Flush); returns their payloads."""
        with self._cv:
            dropped = [e.payload for e in self._dq]
            self._dq.clear()
            self._cv.notify_all()
        return dropped

    def close(self) -> None:
        """Drop all entries and stop the reaper thread (element stop)."""
        with self._cv:
            self._dq.clear()
            self._closed = True
            self._cv.notify_all()
            reaper, self._reaper = self._reaper, None
        if reaper is not None and reaper.is_alive():
            reaper.join(timeout=2.0)


class StagedBatch:
    """Handle for one in-flight staging job: the lane thread stacks the
    frames into pooled staging buffers, runs ``to_device`` (which returns
    only once the buffers' contents are copied off), releases the buffers
    to the pool and publishes the device tensors here.  The dispatch thread
    collects them with :meth:`wait` / :meth:`result`; ``discard()`` drops
    the result of a job whose batch will never be dispatched."""

    __slots__ = ("_cv", "_dev", "_err", "_done", "_discarded")

    def __init__(self):
        self._cv = threading.Condition()
        self._dev: Optional[List[Any]] = None
        self._err: Optional[BaseException] = None
        self._done = False
        self._discarded = False

    def _finish(self, dev, err) -> None:
        with self._cv:
            self._dev = None if self._discarded else dev
            self._err = err
            self._done = True
            self._cv.notify_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: self._done, timeout=timeout)

    def result(self) -> List[Any]:
        """The staged device tensors; raises the staging error if any."""
        with self._cv:
            self._cv.wait_for(lambda: self._done)
            if self._err is not None:
                raise self._err
            return self._dev

    def discard(self) -> None:
        """The job's batch will never be dispatched (Flush/stop): drop the
        device references as soon as they exist."""
        with self._cv:
            self._discarded = True
            self._dev = None


class HostStagingLane:
    """Double-buffered host-to-device staging on a dedicated lane thread.

    ``submit(per_frame_tensors)`` enqueues one micro-batch: the lane thread
    stacks each tensor index into a pooled staging buffer
    (:func:`_stack_into`, no per-batch allocation once warm) and
    calls ``to_device`` (the backend's placement hook) on the stacked
    buffers.  Jobs run one at a time, in order.

    Aliasing rule: ``to_device`` must return only once the buffers'
    contents are copied off (torch-cuda waits on the copy stream's event
    ON THE LANE THREAD; that wait is the overlapped transfer).  The lane
    releases each buffer to the pool the moment ``to_device`` returns.

    ``stack_s`` sums the seconds spent stacking."""

    __slots__ = ("name", "_to_device", "pool", "_placement", "_q", "_cv",
                 "_worker", "_closed", "staged", "stack_s", "heartbeat")

    def __init__(self, to_device: Callable[[List[np.ndarray]], List[Any]],
                 pool=None, name: str = "lane", placement=None):
        self.name = name
        self._to_device = to_device
        # the lane's own pool, freed with the lane (tests pass their own)
        self.pool = pool if pool is not None else DeviceBufferPool()
        # placement-domain token (FilterBackend.staging_placement): the pool
        # keys its rings on it
        self._placement = placement
        self._q: "deque[Tuple[StagedBatch, List[List[np.ndarray]]]]" = deque()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self.staged = 0
        self.stack_s = 0.0
        # a lane with work and a stale beat is wedged inside to_device
        self.heartbeat = ThreadBeat(f"{name}-stage")

    def submit(self, per_frame: List[List[np.ndarray]]) -> StagedBatch:
        """Stage one micro-batch: ``per_frame`` is a list of per-frame
        tensor lists (host arrays of uniform shapes and dtypes)."""
        job = StagedBatch()
        with self._cv:
            self._closed = False
            self._q.append((job, per_frame))
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run, name=f"{self.name}-stage", daemon=True)
                self.heartbeat.beat()
                self._worker.start()
            self._cv.notify_all()
        return job

    def _run(self) -> None:
        while True:
            self.heartbeat.beat()
            with self._cv:
                while not self._q:
                    if self._closed:
                        return
                    self._cv.wait()
                job, per_frame = self._q.popleft()
            self.heartbeat.beat()
            bufs: List[np.ndarray] = []
            try:
                t0 = time.perf_counter()
                n = len(per_frame)
                for t in range(len(per_frame[0])):
                    rows = [np.asarray(pf[t]) for pf in per_frame]
                    buf = self.pool.acquire(
                        (n,) + rows[0].shape, rows[0].dtype, placement=self._placement)
                    bufs.append(buf)
                    _stack_into(rows, buf)
                self.stack_s += time.perf_counter() - t0
                dev = self._to_device(bufs)
                self.staged += 1
                job._finish(list(dev), None)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — crosses threads
                job._finish(None, e)
            finally:
                # to_device returned (or failed): nothing reads the staging
                # buffers any more
                for b in bufs:
                    self.pool.release(b, placement=self._placement)

    def close(self) -> None:
        """Stop the worker; queued jobs resolve with an error, never
        stranding a waiter."""
        with self._cv:
            abandoned = [job for job, _ in self._q]
            self._q.clear()
            self._closed = True
            self._cv.notify_all()
            worker, self._worker = self._worker, None
        for job in abandoned:
            job._finish(None, RuntimeError("staging lane closed"))
        if worker is not None and worker.is_alive():
            worker.join(timeout=2.0)
