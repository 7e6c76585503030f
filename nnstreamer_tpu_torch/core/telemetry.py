"""Hot-path-safe latency histogram.

Port of ``nnstreamer_tpu/core/telemetry.py``, reduced to
:class:`Log2Histogram`, the dispatch window's dwell histogram.  The
metrics registry, tracer spans, flight recorder and SLO trackers wait for
the observability slice (ROADMAP A4.4).
"""

from __future__ import annotations

from typing import Dict, Optional

#: log2 bucket layout shared by every Log2Histogram: boundary i is
#: 2**(LOG2_E_MIN + i) seconds — 2^-20 s (~1 µs) up to 2^4 s (16 s),
#: plus one overflow bucket
LOG2_E_MIN = -20
LOG2_NBUCKETS = 25  # boundaries 2^-20 .. 2^4
_LOG2_SCALE = float(2 ** -LOG2_E_MIN)
LOG2_BOUNDS = tuple(2.0 ** (LOG2_E_MIN + i) for i in range(LOG2_NBUCKETS))


class Log2Histogram:
    """Fixed-bucket log2-scale latency histogram.

    The record path is one float multiply, one ``int.bit_length`` and one
    list increment: no lock and no allocation.  The contract is
    SINGLE-WRITER per instrument (the dispatch window's ``pop_ready`` runs
    on one thread); readers may see a snapshot off by the observation in
    flight.  Quantiles are log-linear interpolations within a bucket, so
    they carry about 2x resolution."""

    __slots__ = ("_counts",)

    def __init__(self):
        self._counts = [0] * (LOG2_NBUCKETS + 1)  # +1: overflow tail

    def record(self, seconds: float) -> None:
        # bucket i collects v in [2^(i-1), 2^i) * 2^LOG2_E_MIN seconds
        idx = int(seconds * _LOG2_SCALE).bit_length()
        if idx > LOG2_NBUCKETS:
            idx = LOG2_NBUCKETS
        self._counts[idx] += 1

    @property
    def count(self) -> int:
        return sum(self._counts)

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile in seconds (None when empty)."""
        counts = list(self._counts)
        total = sum(counts)
        if total == 0:
            return None
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c and cum + c >= target:
                lo = 0.0 if i == 0 else 2.0 ** (LOG2_E_MIN + i - 1)
                hi = 2.0 ** (LOG2_E_MIN + min(i, LOG2_NBUCKETS))
                return lo + (hi - lo) * (target - cum) / c
            cum += c
        return 2.0 ** (LOG2_E_MIN + LOG2_NBUCKETS)

    def percentiles_us(self) -> Dict[str, float]:
        """{p50, p95, p99} in microseconds (empty dict when empty)."""
        out: Dict[str, float] = {}
        for tag, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            v = self.quantile(q)
            if v is None:
                return {}
            out[tag] = v * 1e6
        return out
