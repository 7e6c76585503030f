"""Pipeline-wide tracing: the GstShark-analog observability layer.

Port of ``nnstreamer_tpu/core/tracer.py``.  The scheduler calls
``frame_begin``/``frame_out`` around every element's processing when a
tracer is attached (one ``is not None`` test per frame when it is not).

Measurements per element:
  * **proctime**: wall time inside the element's handler (µs; avg/p50/p99
    over a bounded ring, plus a full-history log2 histogram).  On the card
    this is the host's time around the call: with the filter's dispatch
    window, launch time, not model time.
  * **framerate**: logical frames/sec out of the element (micro-batches
    count as their batch size).
  * **interlatency**: source-to-here latency from the stamp the tracer put
    on the frame when it left its source.
  * **queuelevel**: mailbox depth sampled at dequeue, and the mailbox wait
    of every frame.
  * **bitrate**: payload bytes/sec through the element
    (:func:`frame_nbytes`, read from tensor metadata: no card tensor is
    touched).

``report()`` returns plain dicts; ``summary_lines()`` renders the
gst-shark-style table; ``export_chrome_trace`` writes a Chrome trace that
sits beside ``torch.profiler``'s (``core/profiler.py``, the filter's
``trace`` property).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from .telemetry import TRACE_ID_META, Log2Histogram, new_trace_id

META_SRC_TS = "_nns_trace_src_ts"  # wall stamp set when a frame leaves a source


class _ElementStats:
    __slots__ = (
        "frames", "calls", "proc_ring", "t_first", "t_last",
        "inter_sum", "inter_max", "inter_n", "bytes", "q_sum", "q_max",
        "q_n", "q_cap", "sched_ring", "t_prev_in", "lat_hist",
    )

    def __init__(self) -> None:
        self.frames = 0
        self.calls = 0
        self.proc_ring: deque = deque(maxlen=1024)  # seconds per call
        # every observation, in fixed memory (the ring keeps the last 1024);
        # lock-free: frame_out is single-writer per element
        self.lat_hist = Log2Histogram()
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.inter_sum = 0.0
        self.inter_max = 0.0
        self.inter_n = 0
        self.bytes = 0
        self.q_sum = 0
        self.q_max = 0
        self.q_n = 0
        self.q_cap = 0
        # scheduletime: gap between consecutive call starts
        self.sched_ring: deque = deque(maxlen=1024)
        self.t_prev_in: Optional[float] = None


class PipelineTracer:
    """Attach via ``pipeline.enable_tracing()``; read ``report()`` any time
    (thread-safe, also while the pipeline runs).

    A :class:`~.telemetry.FlightRecorder` may ride along (``recorder``,
    set by ``Pipeline.enable_flight_recorder``): the scheduler's single
    ``tracer is not None`` branch then also feeds the incident ring."""

    def __init__(self, detail: bool = False, recorder=None) -> None:
        self._stats: Dict[str, _ElementStats] = {}
        # mailbox queue-wait distributions, one per consuming element
        # (single writer: each mailbox has one consumer thread)
        self._qwait: Dict[str, Log2Histogram] = {}
        self._lock = threading.Lock()
        self.t_started = time.perf_counter()
        # cpuusage: process CPU time vs wall time over the traced window
        self._cpu_started = time.process_time()
        # detail mode keeps per-call spans (bounded) for export_chrome_trace
        self._detail = detail
        self._spans: deque = deque(maxlen=200_000)
        self.recorder = recorder

    # -- hot-path hooks (called from element worker threads) ---------------
    def stamp_source(self, frame) -> None:
        """Stamp a frame leaving a source element (interlatency origin);
        with a flight recorder attached, also mint its trace id."""
        frame.meta.setdefault(META_SRC_TS, time.perf_counter())
        if self.recorder is not None:
            frame.meta.setdefault(TRACE_ID_META, new_trace_id())

    def frame_begin(self, name: str, frame) -> None:
        """A frame ENTERS an element's handler: an open span for the flight
        recorder (a frame stuck in a hung element); else a no-op."""
        if self.recorder is not None:
            self.recorder.begin(name, frame)

    def queue_wait(self, name: str, wait_s: float) -> None:
        """One frame's mailbox wait (from the producer's handoff attempt,
        so time blocked on a full mailbox counts), recorded by the
        consuming thread."""
        h = self._qwait.get(name)
        if h is None:
            with self._lock:
                h = self._qwait.setdefault(name, Log2Histogram())
        h.record(wait_s)

    def queue_level(self, name: str, depth: int, cap: int) -> None:
        st = self._get(name)
        st.q_sum += depth
        st.q_n += 1
        st.q_cap = cap
        if depth > st.q_max:
            st.q_max = depth

    def frame_out(self, name: str, t_in: float, t_out: float, nframes: int, nbytes: int,
                  src_ts: Optional[float], frame=None) -> None:
        if self._detail:
            self._spans.append((name, t_in, t_out, nframes))
        if self.recorder is not None:
            self.recorder.end(name, frame, t_in, t_out, nframes)
        st = self._get(name)
        st.calls += 1
        st.frames += nframes
        st.proc_ring.append(t_out - t_in)
        st.lat_hist.record(t_out - t_in)
        if st.t_prev_in is not None:
            st.sched_ring.append(t_in - st.t_prev_in)
        st.t_prev_in = t_in
        if st.t_first is None:
            st.t_first = t_out
        st.t_last = t_out
        st.bytes += nbytes
        if src_ts is not None:
            lat = t_out - src_ts
            st.inter_sum += lat
            st.inter_n += 1
            if lat > st.inter_max:
                st.inter_max = lat

    def _get(self, name: str) -> _ElementStats:
        st = self._stats.get(name)
        if st is None:
            with self._lock:
                st = self._stats.setdefault(name, _ElementStats())
        return st

    # -- reporting ----------------------------------------------------------
    def latency_histograms(self):
        """``[(element, metric_name, Log2Histogram)]``: per-element handle
        latency (``nns.element.handle_seconds``) and mailbox queue-wait
        (``nns.element.queue_wait_seconds``)."""
        with self._lock:
            stats = list(self._stats.items())
            qwait = list(self._qwait.items())
        out = [(name, "nns.element.handle_seconds", st.lat_hist) for name, st in stats]
        out.extend((name, "nns.element.queue_wait_seconds", h) for name, h in qwait)
        return out

    def cpu_usage(self) -> float:
        """Process CPU seconds per wall second since tracing began."""
        wall = time.perf_counter() - self.t_started
        if wall <= 0:
            return 0.0
        return (time.process_time() - self._cpu_started) / wall

    @staticmethod
    def _snap(dq: deque) -> list:
        """Copy a ring that worker threads append to without locks (a full
        ring's append also evicts, which makes a concurrent list(deque)
        raise): retry, then settle for empty."""
        for _ in range(4):
            try:
                return list(dq)
            except RuntimeError:
                continue
        return []

    def report(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            items = list(self._stats.items())
        for name, st in items:
            ring = self._snap(st.proc_ring)
            span = ((st.t_last - st.t_first)
                    if st.t_first is not None and st.t_last != st.t_first else 0.0)
            proc = np.asarray(ring) if ring else np.zeros(1)
            sched = self._snap(st.sched_ring)
            out[name] = {
                "frames": st.frames,
                "calls": st.calls,
                "proctime_us_avg": float(proc.mean()) * 1e6,
                "proctime_us_p50": float(np.percentile(proc, 50)) * 1e6,
                "proctime_us_p99": float(np.percentile(proc, 99)) * 1e6,
                "scheduletime_us_avg": float(np.mean(sched)) * 1e6 if sched else None,
                "framerate_fps": (st.frames / span) if span else 0.0,
                "interlatency_ms_avg": st.inter_sum / st.inter_n * 1e3 if st.inter_n else None,
                "interlatency_ms_max": st.inter_max * 1e3 if st.inter_n else None,
                "bitrate_mbps": (st.bytes * 8 / 1e6 / span) if span else 0.0,
                "queuelevel_avg": (st.q_sum / st.q_n) if st.q_n else 0.0,
                "queuelevel_max": st.q_max,
                "queue_capacity": st.q_cap,
            }
        return out

    def summary_lines(self) -> List[str]:
        rows = self.report()
        lines = [
            f"{'element':<20} {'frames':>8} {'fps':>9} {'proc µs':>9} "
            f"{'p99 µs':>9} {'inter ms':>9} {'Mb/s':>8} {'queue':>7}"
        ]
        for name, r in rows.items():
            inter = (f"{r['interlatency_ms_avg']:.2f}"
                     if r["interlatency_ms_avg"] is not None else "-")
            lines.append(
                f"{name:<20} {r['frames']:>8} {r['framerate_fps']:>9.1f} "
                f"{r['proctime_us_avg']:>9.1f} {r['proctime_us_p99']:>9.1f} "
                f"{inter:>9} {r['bitrate_mbps']:>8.2f} "
                f"{r['queuelevel_avg']:>4.1f}/{r['queue_capacity']}")
        lines.append(f"cpu usage: {self.cpu_usage():.2f} cores")
        return lines

    def export_chrome_trace(self, path: str) -> None:
        """Write a Chrome-trace JSON (``chrome://tracing`` / Perfetto), so
        pipeline timing sits next to ``torch.profiler``'s device traces.
        With ``detail=True`` every element call becomes a timeline span
        (one lane per element); otherwise one summary span per element plus
        fps counters."""
        t0 = self.t_started
        with self._lock:
            names = list(self._stats)
        lanes = {name: i for i, name in enumerate(names)}
        events = [{"name": "process_name", "ph": "M", "pid": 0,
                   "args": {"name": "nnstreamer_tpu pipeline"}}] + [
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid, "args": {"name": name}}
            for name, tid in lanes.items()]
        if self._detail and self._spans:
            for name, t_in, t_out, nframes in list(self._spans):
                events.append({
                    "name": name, "ph": "X", "pid": 0, "tid": lanes.get(name, 0),
                    "ts": (t_in - t0) * 1e6, "dur": max(0.1, (t_out - t_in) * 1e6),
                    "args": {"frames": nframes},
                })
        for name, r in self.report().items():
            if not (self._detail and self._spans):
                events.append({
                    "name": name, "ph": "X", "pid": 0, "tid": lanes.get(name, 0), "ts": 0,
                    "dur": max(1, int(r["proctime_us_avg"] * r["calls"])),
                    "args": {k: v for k, v in r.items() if v is not None},
                })
            events.append({"name": f"{name}/fps", "ph": "C", "pid": 0, "ts": 0,
                           "args": {"fps": round(r["framerate_fps"], 1)}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


def frame_nbytes(item) -> int:
    """Payload size of a frame (host or card tensors), from each tensor's
    ``nbytes``: metadata only, so a card tensor is never synchronized or
    copied."""
    try:
        return sum(int(getattr(t, "nbytes", 0)) for t in item.tensors)
    except Exception:
        return 0
