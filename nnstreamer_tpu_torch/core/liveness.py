"""Liveness primitives: per-request QoS meta and background-thread heartbeats.

Port of ``nnstreamer_tpu/core/liveness.py``, reduced to what the slot
engine and ``tensor_generator`` read: the tenant, priority and deadline
meta keys, :func:`clamp_priority`, and :class:`ThreadBeat` (the slot
pump's heartbeat).  The watchdog, admission control and the deadline
helpers wait for the scheduler's liveness layer (ROADMAP A4).
"""

from __future__ import annotations

import time
from typing import Callable

#: frame.meta key carrying the requesting tenant's name
TENANT_META = "_nns_tenant"
#: frame.meta key carrying the request's priority class, 0..3 (3 =
#: highest); requests without it are priority 3
PRIORITY_META = "_nns_priority"
#: priority classes (inclusive bounds)
PRIORITY_MIN, PRIORITY_MAX = 0, 3
#: frame.meta key holding the request's absolute expiry instant on the
#: local ``time.monotonic`` clock
DEADLINE_META = "deadline_ts"


def clamp_priority(p) -> int:
    try:
        p = int(p)
    except (TypeError, ValueError):
        return PRIORITY_MAX
    return max(PRIORITY_MIN, min(PRIORITY_MAX, p))


class ThreadBeat:
    """Watchdog heartbeat for one named background thread (the slot
    engine's pump).

    The owning thread calls :meth:`beat` once per loop iteration; the
    element asks :meth:`check_stall` ``(busy=...)`` from its dispatch
    thread: a thread that has work but has not beaten for
    ``stall_after_s`` is wedged (stuck inside a device call), which a
    sticky error never surfaces because the thread never returns.
    ``check_stall`` is edge-triggered: one True per stall episode."""

    __slots__ = ("name", "stall_after_s", "_clock", "_last", "_flagged")

    def __init__(self, name: str, stall_after_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.stall_after_s = float(stall_after_s)
        self._clock = clock
        self._last = clock()
        self._flagged = False

    def beat(self) -> None:
        self._last = self._clock()

    def age_s(self) -> float:
        return max(0.0, self._clock() - self._last)

    def check_stall(self, busy: bool) -> bool:
        """True ONCE per stall episode: the thread has pending work but
        has not beaten within ``stall_after_s``.  An idle thread (or a
        beat arriving again) re-arms the edge."""
        if not busy or self.age_s() < self.stall_after_s:
            self._flagged = False
            return False
        if self._flagged:
            return False
        self._flagged = True
        return True
