"""Instruments shared by the close path and the device planes.

``AtomicCounters`` (a named-counter bundle under one lock, fed by the
close path and the seal drainer from their own threads) and the
fixed-bucket ``LatencyHist`` (the close stages, the close pipeline's
stage timers and the verify plane's batch latencies share it) of the
node's metrics plane. Its collectors, statsd export and history ring
come with the standalone node.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["AtomicCounters", "LatencyHist"]


class AtomicCounters:
    """A named-counter bundle under ONE lock.

    The close-info counters (spliced/fallback/invalidated) and the
    parallel-speculation counters are incremented from several threads —
    the close path, the TxQ's deferred promotion job, and the executor's
    commit thread — so per-dict `+=` on a plain dict would lose updates.
    One shared lock for the whole bundle keeps multi-key updates (e.g. a
    commit bumping committed AND retries) atomic as a group, which a
    per-counter lock could not."""

    __slots__ = ("_lock", "_vals")

    def __init__(self, *names, **initial):
        self._lock = threading.Lock()
        self._vals: dict = {name: 0 for name in names}
        self._vals.update(initial)

    def add(self, name: str, n=1) -> None:
        with self._lock:
            self._vals[name] = self._vals.get(name, 0) + n

    def add_many(self, **deltas) -> None:
        """Atomically apply several deltas (one lock hold)."""
        with self._lock:
            for name, n in deltas.items():
                self._vals[name] = self._vals.get(name, 0) + n

    def set(self, name: str, value) -> None:
        with self._lock:
            self._vals[name] = value

    def get(self, name: str):
        with self._lock:
            return self._vals.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._vals)

    def __getitem__(self, name: str):
        return self.get(name)

    def keys(self):
        """Mapping protocol (with __getitem__): ``dict(counters)`` and
        ``**counters`` both work, so an AtomicCounters can drop in where
        a plain stats dict used to live."""
        with self._lock:
            return list(self._vals)


class LatencyHist:
    """Fixed-bucket latency histogram (ms): tiny, lock-free enough for a
    single-writer stage, read-mostly for metrics. The ONE percentile
    implementation for the whole node — the close pipeline's stage
    timers, the ledger master's close stages, the verify plane's batch
    latencies, and the tracer's span-derived stage histograms all share
    it (they used to carry three divergent ad-hoc copies).

    Quantiles report the upper bound of the bucket holding the target
    rank (0 when empty); `interpolate=True` refines that to a linear
    estimate inside the holding bucket (used where the value feeds
    round-over-round comparisons — bench provenance, close stages —
    so a drifting p50 moves continuously instead of jumping a whole
    bucket). `bounds` tunes resolution per instrument; the default
    decade ladder matches the original close-pipeline buckets.
    """

    BOUNDS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 250.0, 500.0,
              1000.0, 5000.0)

    def __init__(self, bounds: Optional[tuple] = None,
                 interpolate: bool = False):
        self.bounds = tuple(bounds) if bounds is not None else self.BOUNDS
        self.interpolate = interpolate
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
        """Upper bucket bound holding the q-quantile (0 when empty);
        with `interpolate`, the linear estimate inside that bucket."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1] * 2)
                if not self.interpolate or not c:
                    return hi
                lo = self.bounds[i - 1] if i > 0 else 0.0
                frac = (target - (seen - c)) / c
                return round(lo + frac * (hi - lo), 3)
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
