"""Metrics plane: insight-style instruments + statsd export + history.

Role parity with the reference's beast::insight + CollectorManager
(src/ripple_app/main/CollectorManager.cpp:22-60,
beast insight {Counter,Gauge,Event,Meter,Hook}): subsystems register
named instruments against a collector; the `[insight]` config selects a
NullCollector (default) or a StatsDCollector that ships deltas over UDP.

Hooks are pull-gauges: a callable sampled at flush time, which is how
the JobQueue per-type gauges and the verify plane's rates export without
the hot paths touching the collector.

Beyond the reference: a Monarch-style embedded history (MetricsHistory —
bounded ring of periodic instrument snapshots, queryable in-process via
the `metrics_history` admin RPC) and a Prometheus text-exposition
renderer (text format 0.0.4, the `GET /metrics` door). Snapshots feed
the SLO health watchdog (node/health.py) through the manager's on_sample
callbacks.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque
from typing import Callable, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Meter",
    "LatencyHist",
    "AtomicCounters",
    "CollectorManager",
    "MetricsHistory",
    "NullCollector",
    "StatsDCollector",
    "prometheus_escape_help",
    "prometheus_escape_label",
    "prometheus_name",
]


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


class Counter:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Meter:
    """Events per flush interval (plus a never-reset cumulative total so
    history snapshots and Prometheus exposition stay monotone across the
    statsd flusher's drains)."""

    __slots__ = ("name", "count", "total", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self.count += n
            self.total += n

    def drain(self) -> int:
        with self._lock:
            n = self.count
            self.count = 0
            return n


class MetricsHistory:
    """Bounded ring of periodic instrument snapshots (Monarch's core
    move: keep queryable metric history INSIDE the monitored system).

    One snapshot per `interval` seconds, kept for `window` seconds —
    capacity is fixed at construction, so memory is bounded no matter
    how long the node runs. Snapshots are immutable once appended;
    reads copy the row list under the lock (copy-on-read), so a reader
    holding a result is never affected by concurrent appends."""

    def __init__(self, interval: float = 5.0, window: float = 300.0):
        self.interval = max(0.1, float(interval))
        self.window = max(self.interval, float(window))
        self.capacity = max(2, int(round(self.window / self.interval)))
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self.appended = 0  # lifetime count (evictions = appended - len)

    def append(self, snap: dict) -> None:
        with self._lock:
            self._ring.append(snap)
            self.appended += 1

    def rows(self, since: float = 0.0, limit: int = 0) -> list[dict]:
        """Chronological snapshots (copy-on-read). `since` filters by
        snapshot timestamp; `limit` keeps only the newest N."""
        with self._lock:
            out = list(self._ring)
        if since:
            out = [r for r in out if r.get("ts", 0.0) >= since]
        if limit and len(out) > limit:
            out = out[-limit:]
        return out

    def last(self) -> Optional[dict]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def get_json(self) -> dict:
        with self._lock:
            n = len(self._ring)
        return {
            "interval": self.interval,
            "window": self.window,
            "capacity": self.capacity,
            "rows": n,
            "appended": self.appended,
        }


# -- Prometheus text exposition (format 0.0.4) ------------------------------


def prometheus_name(name: str) -> str:
    """Map an insight instrument name to a legal Prometheus metric name:
    [a-zA-Z_:][a-zA-Z0-9_:]* — dots and dashes become underscores."""
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() or ch in "_:":
            out.append(ch)
        else:
            out.append("_")
        if i == 0 and ch.isdigit():
            out[0] = "_"
    return "".join(out) or "_"


def prometheus_escape_help(text: str) -> str:
    """HELP line escaping: backslash and newline only (format 0.0.4)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def prometheus_escape_label(value: str) -> str:
    """Label value escaping: backslash, newline, and double quote."""
    return (
        value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
    )


def _prom_num(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class NullCollector:
    """Discards everything (the default when [insight] is unset)."""

    def flush(self, lines: list[str]) -> None:  # pragma: no cover - trivial
        pass

    def close(self) -> None:  # pragma: no cover - trivial
        pass


class StatsDCollector:
    """Ships statsd datagrams over UDP (reference StatsDCollector)."""

    def __init__(self, host: str, port: int, prefix: str = "stellard"):
        self.addr = (host, port)
        self.prefix = prefix
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sent = 0

    def flush(self, lines: list[str]) -> None:
        # batch into ~1400-byte datagrams (statsd multi-metric packets)
        buf = b""
        for line in lines:
            data = f"{self.prefix}.{line}\n".encode()
            if buf and len(buf) + len(data) > 1400:
                self._send(buf)
                buf = b""
            buf += data
        if buf:
            self._send(buf)

    def _send(self, buf: bytes) -> None:
        try:
            self.sock.sendto(buf, self.addr)
            self.sent += 1
        except OSError:
            pass

    def close(self) -> None:
        self.sock.close()


class CollectorManager:
    """Instrument registry + periodic flusher (CollectorManager role)."""

    def __init__(self, collector=None, flush_interval: float = 1.0):
        self.collector = collector or NullCollector()
        self.flush_interval = flush_interval
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._meters: dict[str, Meter] = {}
        self._hooks: dict[str, Callable[[], dict]] = {}
        self._hists: dict[str, LatencyHist] = {}
        self._last_counter_vals: dict[str, int] = {}
        # embedded history ([insight] history_interval/history_window):
        # None disables sampling entirely (the kill switch)
        self.history: Optional[MetricsHistory] = None
        self._last_sample = 0.0
        # observers of each history snapshot (the health watchdog seam);
        # called OFF the registry lock with the immutable snapshot dict
        self._on_sample: list[Callable[[dict], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_config(cls, insight: str) -> "CollectorManager":
        """[insight] value: '' / 'null' -> null; 'statsd:host:port[:prefix]'
        -> statsd (reference CollectorManager.cpp config parse)."""
        if insight.startswith("statsd:"):
            parts = insight.split(":")
            try:
                host, port = parts[1], int(parts[2])
            except (IndexError, ValueError):
                return cls(NullCollector())  # malformed: metrics off
            prefix = parts[3] if len(parts) > 3 else "stellard"
            return cls(StatsDCollector(host, port, prefix))
        return cls(NullCollector())

    # -- registry ----------------------------------------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge(name))

    def meter(self, name: str) -> Meter:
        with self._lock:
            return self._meters.setdefault(name, Meter(name))

    def hook(self, name: str, fn: Callable[[], dict]) -> None:
        """fn() -> {metric_suffix: value} sampled at flush time (the
        insight::Hook shape; how JobQueue gauges export pull-style)."""
        with self._lock:
            self._hooks[name] = fn

    def register_hist(self, name: str, hist: LatencyHist) -> None:
        """Expose a subsystem's LatencyHist through history snapshots
        and the /metrics histogram exposition (pull-style — the owner
        keeps recording into it; we only read)."""
        with self._lock:
            self._hists[name] = hist

    def on_sample(self, fn: Callable[[dict], None]) -> None:
        """Subscribe to history snapshots (the health watchdog seam)."""
        self._on_sample.append(fn)

    # -- history ------------------------------------------------------------

    def enable_history(self, interval: float, window: float) -> MetricsHistory:
        self.history = MetricsHistory(interval, window)
        return self.history

    def instruments_snapshot(self) -> dict:
        """Point-in-time view of every registered instrument: cumulative
        counter/meter values (monotone across flushes — flush drains a
        meter's interval count, never its total), gauge values, hook
        samples, and histogram quantiles."""
        with self._lock:
            counters = {c.name: c.value for c in self._counters.values()}
            for m in self._meters.values():
                counters.setdefault(m.name, m.total)
            gauges = {g.name: g.value for g in self._gauges.values()}
            hooks = list(self._hooks.items())
            hists = list(self._hists.items())
        hook_vals: dict[str, float] = {}
        for name, fn in hooks:
            try:
                for suffix, value in fn().items():
                    hook_vals[f"{name}.{suffix}"] = value
            except Exception:  # noqa: BLE001 — a hook must not kill sampling
                pass
        hist_vals: dict[str, dict] = {}
        for name, h in hists:
            hist_vals[name] = {
                "count": h.count,
                "mean_ms": round(h.total_ms / h.count, 3) if h.count else 0.0,
                "p50_ms": h.quantile(0.5),
                "p99_ms": h.quantile(0.99),
                "max_ms": round(h.max_ms, 3),
            }
        return {
            "counters": counters,
            "gauges": gauges,
            "hooks": hook_vals,
            "hists": hist_vals,
        }

    def sample_history(self, now: Optional[float] = None) -> Optional[dict]:
        """Take one history snapshot and notify on_sample observers.
        Driven by the flusher thread at history cadence; tests and the
        scenario runner call it directly with a virtual clock."""
        if self.history is None:
            return None
        snap = self.instruments_snapshot()
        snap["ts"] = time.time() if now is None else float(now)
        self.history.append(snap)
        for fn in list(self._on_sample):
            try:
                fn(snap)
            except Exception:  # noqa: BLE001 — observers never kill sampling
                pass
        return snap

    # -- flushing ----------------------------------------------------------

    def flush_once(self) -> list[str]:
        lines: list[str] = []
        with self._lock:
            gauges = list(self._gauges.values())
            meters = list(self._meters.values())
            hooks = list(self._hooks.items())
            # counter deltas (and the last-seen map they depend on) are
            # computed UNDER the registry lock: two concurrent flushes
            # racing _last_counter_vals could double-report a delta
            for c in list(self._counters.values()):
                prev = self._last_counter_vals.get(c.name, 0)
                delta = c.value - prev
                self._last_counter_vals[c.name] = c.value
                if delta:
                    lines.append(f"{c.name}:{delta}|c")
        for g in gauges:
            lines.append(f"{g.name}:{g.value:g}|g")
        for m in meters:
            n = m.drain()
            if n:
                # meters drain per-interval event counts; statsd has no
                # "|m" type (real daemons drop unknown types on the
                # floor), so they ship as counters — same delta
                # semantics, a type the server actually aggregates
                lines.append(f"{m.name}:{n}|c")
        for name, fn in hooks:
            try:
                for suffix, value in fn().items():
                    lines.append(f"{name}.{suffix}:{value:g}|g")
            except Exception:  # noqa: BLE001 — a hook must not kill the flusher
                pass
        self.collector.flush(lines)
        return lines

    def start(self) -> "CollectorManager":
        self._thread = threading.Thread(
            target=self._run, name="insight", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.flush_interval):
            self.flush_once()
            if self.history is not None:
                mono = time.monotonic()
                if mono - self._last_sample >= self.history.interval:
                    self._last_sample = mono
                    self.sample_history()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.collector.close()

    # -- Prometheus exposition ----------------------------------------------

    def prometheus_text(self, prefix: str = "stellard",
                        extra_gauges: Optional[dict] = None) -> str:
        """Text exposition format 0.0.4 (the `GET /metrics` door):
        counters/meters as `counter`, gauges and hook samples as `gauge`,
        registered LatencyHists as `histogram` with CUMULATIVE `le`
        buckets, a `+Inf` bucket, and `_count`/`_sum` series.
        `extra_gauges` lets the serving layer fold in computed values
        (health status, ledger seq) without registering instruments."""
        snap = self.instruments_snapshot()
        with self._lock:
            hists = list(self._hists.items())
        out: list[str] = []

        def emit(name: str, mtype: str, value, help_text: str = "") -> None:
            pname = prometheus_name(f"{prefix}_{name}")
            if help_text:
                out.append(f"# HELP {pname} {prometheus_escape_help(help_text)}")
            out.append(f"# TYPE {pname} {mtype}")
            out.append(f"{pname} {_prom_num(value)}")

        for name in sorted(snap["counters"]):
            emit(name, "counter", snap["counters"][name])
        for name in sorted(snap["gauges"]):
            emit(name, "gauge", snap["gauges"][name])
        for name in sorted(snap["hooks"]):
            emit(name, "gauge", snap["hooks"][name])
        for name, value in sorted((extra_gauges or {}).items()):
            emit(name, "gauge", value)
        for name, h in sorted(hists):
            pname = prometheus_name(f"{prefix}_{name}")
            out.append(f"# TYPE {pname} histogram")
            # snapshot the bucket counts once: the owner thread keeps
            # recording, and Prometheus requires cumulative monotone
            # buckets within one scrape
            counts = list(h.counts)
            cum = 0
            for i, b in enumerate(h.bounds):
                cum += counts[i]
                out.append(
                    f'{pname}_bucket{{le="{_prom_num(float(b))}"}} {cum}'
                )
            cum += counts[len(h.bounds)]
            out.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
            out.append(f"{pname}_count {cum}")
            out.append(f"{pname}_sum {_prom_num(round(h.total_ms, 3))}")
        return "\n".join(out) + "\n"

    def history_json(self, since: float = 0.0, limit: int = 0) -> dict:
        """`metrics_history` admin RPC payload."""
        if self.history is None:
            return {"enabled": False, "rows": []}
        return {
            "enabled": True,
            **self.history.get_json(),
            "series": self.history.rows(since=since, limit=limit),
        }
