"""Profilers: the ``torch.profiler`` trace session and the incident-time
thread sampler.

Port of ``nnstreamer_tpu/core/profiler.py``.

**torch.profiler session.**  The JAX package drives ``jax.profiler``; here
one process-wide ``torch.profiler`` session (Kineto allows one at a time)
records host activity and, when a card is present, its kernels and copies
(``ProfilerActivity.CUDA``).  Elements call :func:`trace_start` /
:func:`trace_stop` (the filter's ``trace`` / ``trace-dir`` properties) and
a reference count keeps the session alive while any element wants it; the
last :func:`trace_stop` writes a Chrome trace (``chrome://tracing`` /
Perfetto) into the trace directory.  A session that cannot start (another
profiler holds the process, the tracer fails) makes :func:`trace_start`
warn and return False.

**Incident-time thread profiler.**  A sampling wall-clock profiler over
the NAMED framework threads: segment workers (named after their head
element), the dispatch window's ``-reaper``, the ingest lane's ``-stage``,
the slot engine's ``-slots`` pump and the ``-watchdog`` sweeper.
:func:`profile_threads` samples ``sys._current_frames()`` for a bounded
window and returns collapsed top stacks per thread; the flight recorder
attaches one to every incident dump.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import Counter
from typing import Dict, Optional, Tuple

from .log import get_logger

log = get_logger("profiler")

_lock = threading.Lock()
_refs = 0
_dir: Optional[str] = None
_session = None  # the live torch.profiler.profile


def _new_session():
    """A ``torch.profiler.profile`` over the host and, when a card is
    present, the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _profiler_enabled() -> bool:
    """True while some ``torch.profiler`` / autograd profiler session is
    active in this process (this module's or anyone else's)."""
    import torch

    return bool(torch._C._autograd._profiler_enabled())


def trace_start(trace_dir: str) -> bool:
    """Begin (or join) the process's profiler session; True if tracing."""
    global _refs, _dir, _session
    with _lock:
        if _refs == 0:
            prof = None
            try:
                if _profiler_enabled():
                    # someone else's session: stopping it would kill their
                    # trace mid-run, so it is left alone
                    raise RuntimeError("a profiler session is already active")
                prof = _new_session()
                prof.start()
            except Exception as e:
                log.warning("profiler trace unavailable: %s", e)
                # a failed start can leave the session half-armed: reset it,
                # except when the failure says one is already active (that
                # one belongs to someone else)
                if prof is not None and "already" not in str(e).lower():
                    try:
                        prof.stop()
                    except Exception:  # allow-silent: best-effort reset
                        pass           # of a never-started session
                _dir = None
                _session = None
                return False
            _dir = trace_dir
            _session = prof
        elif trace_dir != _dir:
            log.warning("profiler already tracing to %s; ignoring %s", _dir, trace_dir)
        _refs += 1
        return True


def trace_stop() -> Optional[str]:
    """Drop one trace reference; the session ends at zero and writes its
    Chrome trace into the trace directory.  Returns that file's path when
    this call ended the session and wrote it, else None."""
    global _refs, _dir, _session
    with _lock:
        if _refs == 0:
            return None
        _refs -= 1
        if _refs:
            return None
        prof, trace_dir = _session, _dir
        _session, _dir = None, None
        path = None
        try:
            prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(
                trace_dir, f"nns_trace_{os.getpid()}_{int(time.time() * 1000)}.json")
            prof.export_chrome_trace(path)
            log.info("profiler trace written to %s", path)
        except Exception as e:
            log.warning("profiler stop failed: %s", e)
            path = None
        return path


def trace_active() -> bool:
    """True while any element holds the process's trace session open."""
    return _refs > 0


def annotate(name: str):
    """Context manager labeling a region in the trace."""
    from torch.profiler import record_function

    return record_function(name)


# ---------------------------------------------------------------------------
# Incident-time thread profiler (sampling, wall-clock, host-side)
# ---------------------------------------------------------------------------
#: thread-name prefixes that are NOT framework threads (library pools,
#: pytest/debugger internals): every framework thread is explicitly named
THREAD_IGNORE: Tuple[str, ...] = (
    "MainThread", "Thread-", "ThreadPool", "Dummy", "asyncio", "pydevd",
    "raylet",
)


def framework_thread_names() -> Dict[int, str]:
    """{ident: name} for live framework threads (named, not ignored)."""
    return {
        t.ident: t.name
        for t in threading.enumerate()
        if t.ident is not None and t.is_alive()
        and not t.name.startswith(THREAD_IGNORE)
    }


def _collapse(frame, max_depth: int) -> str:
    """One thread's current stack as a collapsed ``a;b;c`` string,
    outermost first (flamegraph convention), frames as file:func."""
    parts = []
    f = frame
    while f is not None and len(parts) < max_depth:
        code = f.f_code
        parts.append(f"{os.path.basename(code.co_filename)}:{code.co_name}")
        f = f.f_back
    parts.reverse()
    return ";".join(parts)


def profile_threads(duration_s: float = 0.25, hz: float = 50.0,
                    top: int = 5, max_depth: int = 48,
                    include=None) -> Dict:
    """Sample the named framework threads for ``duration_s`` at ``hz``.

    Pure-Python wall-clock sampling via ``sys._current_frames()``: no
    tracing hooks are installed, the profiled threads pay nothing, and a
    thread BLOCKED in a C call (a wedged device wait, a socket read) is
    still visible, its Python stack parked on the blocking call.  The
    CALLING thread blocks for the window.

    Returns ``{duration_s, hz, samples, threads: {name: {samples,
    top_stacks: [{stack, count}, ...]}}}``; ``include`` restricts to
    thread names containing any of the given substrings.
    """
    hz = max(1.0, float(hz))
    n = max(1, int(float(duration_s) * hz))
    period = 1.0 / hz
    me = threading.get_ident()
    agg: Dict[str, Counter] = {}
    taken = 0
    t0 = time.perf_counter()
    for i in range(n):
        names = framework_thread_names()
        # two pipelines in one process can both own a thread named e.g.
        # "f": duplicates become "name#<ident>"
        seen: Counter = Counter(names.values())
        frames = sys._current_frames()
        try:
            for ident, name in names.items():
                if ident == me:
                    continue
                if include is not None and not any(s in name for s in include):
                    continue
                frame = frames.get(ident)
                if frame is None:
                    continue
                key = name if seen[name] == 1 else f"{name}#{ident}"
                agg.setdefault(key, Counter())[_collapse(frame, max_depth)] += 1
        finally:
            del frames  # frame objects pin their locals; release now
        taken += 1
        if i + 1 < n:
            time.sleep(period)
    return {
        "duration_s": round(time.perf_counter() - t0, 4),
        "hz": hz,
        "samples": taken,
        "threads": {
            name: {
                "samples": sum(ctr.values()),
                "top_stacks": [{"stack": s, "count": c} for s, c in ctr.most_common(top)],
            }
            for name, ctr in sorted(agg.items())
        },
    }
