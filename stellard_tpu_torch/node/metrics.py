"""Latency histogram shared by the device planes.

Only the fixed-bucket ``LatencyHist`` of the node's metrics plane is
needed by the verify plane; the collectors and exporters are not part
of this package.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["LatencyHist"]


class LatencyHist:
    """Fixed-bucket latency histogram (ms): tiny, lock-free enough for a
    single-writer stage, read-mostly for metrics.

    Quantiles report the upper bound of the bucket holding the target
    rank (0 when empty). `bounds` tunes resolution per instrument.
    """

    BOUNDS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 250.0, 500.0,
              1000.0, 5000.0)

    def __init__(self, bounds: Optional[tuple] = None):
        self.bounds = tuple(bounds) if bounds is not None else self.BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0

    def record(self, ms: float) -> None:
        i = 0
        for i, b in enumerate(self.bounds):  # noqa: B007
            if ms <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.count += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)

    def quantile(self, q: float) -> float:
        """Upper bucket bound holding the q-quantile (0 when empty)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return (self.bounds[i] if i < len(self.bounds)
                        else self.bounds[-1] * 2)
        return self.bounds[-1] * 2

    def get_json(self) -> dict:
        return {
            "count": self.count,
            "mean_ms": round(self.total_ms / self.count, 3) if self.count else 0.0,
            "p50_ms": self.quantile(0.5),
            "p90_ms": self.quantile(0.9),
            "p99_ms": self.quantile(0.99),
            "max_ms": round(self.max_ms, 3),
        }
