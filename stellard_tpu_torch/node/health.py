"""SLO health watchdog + flight recorder (the judgment layer of the
observability plane).

The tracer answers "what happened", the metrics history answers "what
were the numbers" — this module answers "is the node healthy RIGHT NOW,
and if not, why", continuously, in-process, with the evidence preserved:

- HealthWatchdog: EWMA/threshold rules over the metrics history ring
  (node/metrics.py MetricsHistory) plus two direct feeds (close events,
  closed/validated seqs). Emits ok/warn/critical with machine-readable
  reasons, `health.*` tracer instants on every status transition, and a
  `health` block for server_state/get_counts. Deterministic: status is a
  pure function of the fed observations and the clock values handed in,
  so a test can drive it with virtual time and get the same verdicts.

- FlightRecorder: an always-on bounded black box — recent spans (fed by
  the tracer), health transitions, counter-snapshot deltas — dumped
  ATOMICALLY to disk (tmp + rename) on crash, degradation to TRACKING,
  or a worsening health transition, so the moments before a failure
  survive the failure.

The node (node/node.py) always builds the recorder and, with ``[health]
enabled`` (the default), the watchdog on the metrics history's samples.
Nothing here touches the card.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

__all__ = ["HealthWatchdog", "FlightRecorder", "HEALTH_OK", "HEALTH_WARN",
           "HEALTH_CRITICAL"]

HEALTH_OK = "ok"
HEALTH_WARN = "warn"
HEALTH_CRITICAL = "critical"

_RANK = {HEALTH_OK: 0, HEALTH_WARN: 1, HEALTH_CRITICAL: 2}


class FlightRecorder:
    """Bounded black box: the newest N spans / health transitions /
    counter snapshots, whatever the sampling rate. deque(maxlen=) keeps
    every append O(1) and the memory ceiling fixed; appends are GIL-
    atomic so the tracer's record path takes no extra lock."""

    def __init__(self, directory: str = "", spans_cap: int = 2048,
                 events_cap: int = 256):
        self.directory = directory or "."
        self._spans: deque = deque(maxlen=max(16, int(spans_cap)))
        self._transitions: deque = deque(maxlen=max(4, int(events_cap)))
        self._counters: deque = deque(maxlen=max(4, int(events_cap)))
        self._dump_lock = threading.Lock()
        self._dump_n = 0
        self.dumps: list[str] = []  # paths written this process

    # -- feeds (hot-ish paths: deque.append only) --------------------------

    def note_span(self, ph: str, name: str, cat: str, trace, ms: float) -> None:
        self._spans.append((round(time.time(), 3), ph, name, cat, trace, ms))

    def note_transition(self, status: str, reasons: list, ts: float) -> None:
        self._transitions.append((round(ts, 3), status, list(reasons)))

    def note_counters(self, snap: dict) -> None:
        """One history snapshot's counters (the watchdog feeds these so
        the dump shows the numeric trajectory into the failure)."""
        self._counters.append(
            {"ts": snap.get("ts"), "counters": dict(snap.get("counters", {}))}
        )

    # -- dump --------------------------------------------------------------

    def payload(self, reason: str) -> dict:
        return {
            "reason": reason,
            "wall_time": time.time(),
            "pid": os.getpid(),
            "spans": list(self._spans),
            "health_transitions": list(self._transitions),
            "counter_snapshots": list(self._counters),
        }

    def dump(self, reason: str, directory: Optional[str] = None) -> Optional[str]:
        """Write the black box atomically (tmp + os.replace): a crash
        mid-dump leaves either the previous dump or a complete new one,
        never a torn file. Returns the path, or None on I/O failure —
        the recorder must never turn a failure into a worse failure."""
        with self._dump_lock:
            self._dump_n += 1
            n = self._dump_n
        d = directory or self.directory
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in reason)
        path = os.path.join(d, f"flight-{safe[:64]}-{os.getpid()}-{n}.json")
        tmp = path + ".tmp"
        try:
            os.makedirs(d, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.payload(reason), f, default=repr)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        self.dumps.append(path)
        return path

    def get_json(self) -> dict:
        return {
            "spans": len(self._spans),
            "transitions": len(self._transitions),
            "dumps": list(self.dumps),
        }


class HealthWatchdog:
    """Six SLO rules, each with a warn and (where meaningful) a critical
    line; overall status is the worst tripped rule:

    1. close cadence: no close for > stall_warn_s (stall_crit_s) OR the
       EWMA of close gaps drifted past drift_factor x the target cadence
    2. validation lag: closed_seq - validated_seq beyond lag_warn
       (lag_crit) ledgers — quorum is slipping
    3. fanout delivery: the subscription fanout lag p99 (registered
       LatencyHist) above fanout_p99_warn_ms
    4. routing flips: measured-cost verify/hash arm routing flipped more
       than flips_warn times within one history window — thrashing
    5. cache collapse: any `*.hit_rate` gauge/hook under cache_hit_warn
    6. persist backlog: any `*queue_depth`/`*persist_depth` gauge/hook
       above persist_depth_warn

    Rules with no data report nothing (a node without subscribers is not
    "unhealthy", it is silent).
    """

    def __init__(
        self,
        target_close_s: float = 3.0,
        stall_warn_s: float = 12.0,
        stall_crit_s: float = 45.0,
        drift_factor: float = 2.5,
        lag_warn: int = 4,
        lag_crit: int = 16,
        fanout_p99_warn_ms: float = 250.0,
        flips_warn: int = 8,
        cache_hit_warn: float = 0.10,
        persist_depth_warn: float = 512.0,
        ewma_alpha: float = 0.25,
        tracer=None,
        flight: Optional[FlightRecorder] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.target_close_s = float(target_close_s)
        self.stall_warn_s = float(stall_warn_s)
        self.stall_crit_s = float(stall_crit_s)
        self.drift_factor = float(drift_factor)
        self.lag_warn = int(lag_warn)
        self.lag_crit = int(lag_crit)
        self.fanout_p99_warn_ms = float(fanout_p99_warn_ms)
        self.flips_warn = int(flips_warn)
        self.cache_hit_warn = float(cache_hit_warn)
        self.persist_depth_warn = float(persist_depth_warn)
        self.ewma_alpha = float(ewma_alpha)
        self.tracer = tracer
        self.flight = flight
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        # feeds
        self._last_close_ts: Optional[float] = None
        self._ewma_gap: Optional[float] = None
        self._closed_seq = 0
        self._validated_seq = 0
        self._flip_counts: dict[str, int] = {}  # counter name -> last seen
        self._flips_window: deque = deque(maxlen=64)  # (ts, delta)
        # state
        self.status = HEALTH_OK
        self.reasons: list[str] = []
        self.transitions = 0
        self.evaluations = 0
        # observers of (old_status, new_status, reasons) — node.py wires
        # the flight-recorder dump here
        self.on_transition: list[Callable[[str, str, list], None]] = []

    # -- feeds -------------------------------------------------------------

    def note_close(self, seq: int, ts: Optional[float] = None) -> None:
        """One ledger close (consensus OR follower adoption)."""
        now = self.clock() if ts is None else float(ts)
        with self._lock:
            if self._last_close_ts is not None:
                gap = max(0.0, now - self._last_close_ts)
                a = self.ewma_alpha
                self._ewma_gap = (
                    gap if self._ewma_gap is None
                    else a * gap + (1.0 - a) * self._ewma_gap
                )
            self._last_close_ts = now
            if seq > self._closed_seq:
                self._closed_seq = seq

    def note_seqs(self, closed: int, validated: int) -> None:
        with self._lock:
            self._closed_seq = int(closed)
            self._validated_seq = int(validated)

    def note_validated(self, seq: int) -> None:
        """Quorum-validated tip advanced (LedgerMaster.on_validated)."""
        with self._lock:
            self._validated_seq = max(self._validated_seq, int(seq))
            # a validated ledger was necessarily closed — keep the pair
            # ordered so the lag rule never reads a negative lag
            if self._closed_seq < self._validated_seq:
                self._closed_seq = self._validated_seq

    def on_snapshot(self, snap: dict) -> None:
        """MetricsHistory on_sample observer: ingest counter deltas for
        the flip rule, forward the snapshot to the flight recorder, then
        re-evaluate at the snapshot's timestamp."""
        counters = dict(snap.get("counters", {}))
        # flip telemetry may ride a pull-hook (node.serve's
        # verify_routing.flips) rather than a pushed counter
        for name, val in snap.get("hooks", {}).items():
            if "routing_flip" in name or name.endswith(".flips"):
                counters[name] = val
        ts = snap.get("ts")
        with self._lock:
            for name, val in counters.items():
                if "routing_flip" in name or name.endswith(".flips"):
                    prev = self._flip_counts.get(name)
                    if prev is not None and val > prev:
                        self._flips_window.append((ts, val - prev))
                    self._flip_counts[name] = val
        if self.flight is not None:
            self.flight.note_counters(snap)
        self.evaluate(snap=snap, now=self.clock())

    # -- evaluation --------------------------------------------------------

    def _rules(self, snap: Optional[dict], now: float) -> list[tuple[str, str]]:
        """(severity, reason) for every tripped rule."""
        out: list[tuple[str, str]] = []
        with self._lock:
            last_close = self._last_close_ts
            ewma = self._ewma_gap
            closed, validated = self._closed_seq, self._validated_seq
            flips = sum(d for _t, d in self._flips_window)
        # 1. close cadence
        if last_close is not None:
            idle = now - last_close
            if idle > self.stall_crit_s:
                out.append((HEALTH_CRITICAL,
                            f"close_stall:{idle:.1f}s>{self.stall_crit_s:g}s"))
            elif idle > self.stall_warn_s:
                out.append((HEALTH_WARN,
                            f"close_stall:{idle:.1f}s>{self.stall_warn_s:g}s"))
            if (
                ewma is not None
                and ewma > self.drift_factor * self.target_close_s
            ):
                out.append((HEALTH_WARN,
                            f"close_drift:ewma={ewma:.1f}s"
                            f">{self.drift_factor:g}x{self.target_close_s:g}s"))
        # 2. validation lag
        lag = closed - validated
        if validated and lag >= self.lag_crit:
            out.append((HEALTH_CRITICAL, f"validation_lag:{lag}"))
        elif validated and lag >= self.lag_warn:
            out.append((HEALTH_WARN, f"validation_lag:{lag}"))
        if snap:
            hists = snap.get("hists", {})
            # 3. fanout delivery p99
            for name, h in hists.items():
                if "fanout" in name or "subs" in name:
                    p99 = h.get("p99_ms", 0.0)
                    if h.get("count") and p99 > self.fanout_p99_warn_ms:
                        out.append((HEALTH_WARN,
                                    f"fanout_p99:{name}={p99:g}ms"))
            vals = dict(snap.get("gauges", {}))
            vals.update(snap.get("hooks", {}))
            for name, v in vals.items():
                # 5. cache hit collapse — only with real traffic: a
                # fresh/idle cache reports hit_rate=0 and is not sick
                if name.endswith("hit_rate") and v < self.cache_hit_warn:
                    stem = name[: -len("hit_rate")]
                    volume = sum(
                        vals.get(stem + s, 0) or 0
                        for s in ("hits", "misses", "lookups")
                    )
                    if volume >= 100:
                        out.append((HEALTH_WARN,
                                    f"cache_collapse:{name}={v:g}"))
                # 6. persist backlog
                if (
                    name.endswith(("queue_depth", "persist_depth"))
                    and v > self.persist_depth_warn
                ):
                    out.append((HEALTH_WARN, f"persist_backlog:{name}={v:g}"))
        # 4. routing flips
        if flips > self.flips_warn:
            out.append((HEALTH_WARN, f"routing_flips:{flips}"))
        return out

    def evaluate(self, snap: Optional[dict] = None,
                 now: Optional[float] = None) -> str:
        now = self.clock() if now is None else float(now)
        tripped = self._rules(snap, now)
        status = HEALTH_OK
        reasons: list[str] = []
        for sev, reason in tripped:
            reasons.append(reason)
            if _RANK[sev] > _RANK[status]:
                status = sev
        with self._lock:
            self.evaluations += 1
            old = self.status
            self.status = status
            self.reasons = reasons
        if status != old:
            self.transitions += 1
            if self.tracer is not None:
                self.tracer.instant(
                    f"health.{status}", "health",
                    prev=old, reasons=";".join(reasons) or None,
                )
            if self.flight is not None:
                self.flight.note_transition(status, reasons, now)
            for fn in list(self.on_transition):
                try:
                    fn(old, status, reasons)
                except Exception:  # noqa: BLE001 — observers never break
                    pass           # the watchdog
        return status

    # -- export ------------------------------------------------------------

    def get_json(self) -> dict:
        with self._lock:
            return {
                "status": self.status,
                "reasons": list(self.reasons),
                "transitions": self.transitions,
                "evaluations": self.evaluations,
                "ewma_close_gap_s": (
                    round(self._ewma_gap, 3)
                    if self._ewma_gap is not None else None
                ),
                "closed_seq": self._closed_seq,
                "validated_seq": self._validated_seq,
            }
