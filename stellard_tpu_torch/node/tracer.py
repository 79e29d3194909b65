"""Tracing plane: transaction-lifecycle spans in a bounded ring buffer.

The last two perf PRs (pipelined close, delta replay) each justified
themselves with hand-instrumented stage timers, and each subsystem grew
a private latency tracker. This module is the shared substrate those
timers collapse into: a Dapper-style causal trace (Sigelman et al.,
2010) threaded per TRANSACTION (trace id = txid) and per LEDGER (trace
id = "ledger-<seq>") through submit → verify batch → open apply /
speculation → consensus round → close splice/fallback → persist.

Design constraints, in order:

- the hot paths must not notice it: one short lock around a ring-slot
  write, no allocation before the enabled/sampling gates, and the
  subsystems that already measure intervals (JobQueue, VerifyPlane,
  ClosePipeline) hand their existing timestamps to ``complete()``
  instead of timing twice;
- bounded memory: a fixed ring of ``capacity`` records — wraparound
  overwrites the oldest, and ``dropped`` counts what scrolled away;
- deterministic sampling: the record/skip decision for a transaction is
  a pure function of (txid, sample rate), so every subsystem a tx
  passes through makes the SAME decision and a sampled tx always gets
  its whole tree. Ledger-scoped spans (a handful per close) are always
  recorded;
- three exports: Chrome trace-event JSON (``chrome_trace`` — loadable
  in Perfetto / chrome://tracing, served by the ``trace_dump`` admin
  RPC), span-derived per-stage latency histograms (``stage_hist``,
  pushed through CollectorManager hooks to statsd), and a compact
  recent consensus/close timeline for ``server_state``/``get_counts``.

Cross-thread spans use the explicit ``begin()``/``end()`` token pair
(the verify plane completes futures on its flusher thread; the close
pipeline persists on its drain worker). Same-thread nesting uses the
``span()`` context manager, which maintains a thread-local parent
stack so child spans link without any caller bookkeeping.

Cross-NODE propagation (``[trace] propagate``): overlay frames carry a
compact trace context — trace id + parent span id + sampled bit — in an
optional high-numbered wire extension (overlay/wire.py TraceContext).
Span ids are node-unique (a per-tracer 32-bit tag in the high bits), so
spans recorded on different nodes never collide and a merged dump
(tools/traceview.py --merge) resolves parent links across processes.
The deterministic per-txid sampling means every node makes the SAME
record/skip decision, so a sampled transaction's causal tree is
complete fleet-wide. ``wire_context()`` exports the sender side;
``adopt_context()`` registers the foreign parent on the receiver, and
any span recorded for that trace with no local parent links under it
(marked ``remote`` in the dump — a single-node validation must not
demand the foreign parent resolve locally).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from typing import Optional

from .metrics import LatencyHist

__all__ = ["Tracer", "SpanToken", "get_tracer"]

# bound on the per-trace foreign-parent / last-span maps the propagation
# plane keeps (FIFO eviction; a trace is a txid or "ledger-<seq>")
_CTX_CAP = 4096

# categories whose events feed the server_state consensus/close timeline
_TIMELINE_CATS = frozenset({"close", "consensus", "persist"})

# finer-than-default bounds for span stages: close/persist stages live
# in the 1-500 ms band where the default decade buckets are too coarse
STAGE_BOUNDS = (
    0.1, 0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0, 12.0, 20.0, 30.0, 50.0,
    80.0, 120.0, 200.0, 300.0, 500.0, 800.0, 1200.0, 2000.0, 5000.0,
)


class SpanToken:
    """Handle for an in-flight span; pass it across threads and hand it
    back to ``end()`` (or as ``parent=`` of a child span)."""

    __slots__ = ("name", "cat", "trace", "span_id", "parent", "t0",
                 "tid", "attrs")

    def __init__(self, name, cat, trace, span_id, parent, t0, tid, attrs):
        self.name = name
        self.cat = cat
        self.trace = trace
        self.span_id = span_id
        self.parent = parent
        self.t0 = t0
        self.tid = tid
        self.attrs = attrs


class _NullSpan:
    """Context manager returned when tracing is off / the tx unsampled."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *_exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCM:
    """Context-manager wrapper that maintains the thread-local parent
    stack (so nested ``span()`` calls link parent→child) and ends the
    span on exit."""

    __slots__ = ("_tracer", "token")

    def __init__(self, tracer: "Tracer", token: SpanToken):
        self._tracer = tracer
        self.token = token

    def __enter__(self) -> SpanToken:
        stack = self._tracer._stack()
        stack.append(self.token)
        return self.token

    def __exit__(self, *_exc):
        stack = self._tracer._stack()
        if stack and stack[-1] is self.token:
            stack.pop()
        self._tracer.end(self.token)
        return False


def _trace_id(txid, seq) -> Optional[str]:
    """Normalize the two causal keys: a tx trace is the txid hex, a
    ledger trace is "ledger-<seq>"."""
    if txid is not None:
        return txid.hex() if isinstance(txid, (bytes, bytearray)) else str(txid)
    if seq is not None:
        return f"ledger-{seq}"
    return None


class Tracer:
    """Lock-light bounded ring-buffer span recorder."""

    def __init__(self, capacity: int = 16384, enabled: bool = True,
                 sample: float = 0.125, propagate: bool = False,
                 node_tag: Optional[int] = None):
        self.enabled = bool(enabled)
        self.capacity = max(16, int(capacity))
        self.sample = min(1.0, max(0.0, float(sample)))
        self.propagate = bool(propagate)
        # sampling threshold in basis points of 10000, precomputed so the
        # per-tx gate is one crc32 + one compare
        self._sample_bp = int(round(self.sample * 10000))
        self._lock = threading.Lock()
        self._ring: list = [None] * self.capacity
        self._n = 0  # total records ever pushed
        self._ids = itertools.count(1)
        # node-unique span-id prefix: spans from different tracers
        # (nodes / processes) occupy disjoint id ranges, so a merged
        # multi-node dump resolves cross-node parent links directly
        if node_tag is None:
            node_tag = int.from_bytes(os.urandom(4), "big") or 1
        self.node_tag = node_tag & 0xFFFFFFFF
        self._tag = self.node_tag << 32
        self._epoch = time.perf_counter()
        self._tls = threading.local()
        # span-derived per-stage latency histograms (name -> hist)
        self.stage_hist: dict[str, LatencyHist] = {}
        # propagation state: trace -> foreign parent span id (adopted
        # from the wire) and trace -> last locally recorded span id
        # (exported as the parent of outbound frames). Bounded FIFO.
        self._foreign: dict[str, int] = {}
        self._last: dict[str, int] = {}
        # optional flight-recorder feed (node/health.py FlightRecorder):
        # every recorded span/instant also lands in its black box
        self.flight = None

    @classmethod
    def from_config(cls, cfg) -> "Tracer":
        """Build from a node Config's [trace] knobs."""
        return cls(
            capacity=cfg.trace_capacity,
            enabled=cfg.trace_enabled,
            sample=cfg.trace_sample,
            propagate=getattr(cfg, "trace_propagate", False),
        )

    # -- sampling ----------------------------------------------------------

    def sampled(self, txid) -> bool:
        """Deterministic per-transaction record/skip decision: a pure
        function of (txid, rate) so every pipeline stage agrees and a
        sampled tx gets its complete span tree."""
        if not self.enabled:
            return False
        bp = self._sample_bp
        if bp >= 10000:
            return True
        if bp <= 0:
            return False
        key = txid if isinstance(txid, (bytes, bytearray)) else str(txid).encode()
        return (zlib.crc32(key) & 0xFFFFFFFF) % 10000 < bp

    def _admit(self, txid) -> bool:
        """Gate shared by every record path: enabled, and — when the
        event is tx-scoped — the tx is sampled. Ledger/subsystem-scoped
        events (txid None) are always admitted when enabled: there are
        only a handful per close."""
        if not self.enabled:
            return False
        if txid is None:
            return True
        return self.sampled(txid)

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _now_us(self) -> int:
        return int((time.perf_counter() - self._epoch) * 1e6)

    def _push(self, rec: tuple) -> None:
        with self._lock:
            self._ring[self._n % self.capacity] = rec
            self._n += 1

    def _parent_id(self, parent) -> Optional[int]:
        if parent is not None:
            return parent.span_id if isinstance(parent, SpanToken) else int(parent)
        stack = self._stack()
        return stack[-1].span_id if stack else None

    def _next_id(self) -> int:
        return self._tag | (next(self._ids) & 0xFFFFFFFF)

    def _resolve_parent(self, parent, trace, attrs):
        """Parent resolution order: explicit > thread-local stack >
        foreign parent adopted from the wire for this trace. A foreign
        parent marks the record ``remote`` so single-node validation
        knows the link resolves on another node's dump."""
        parent_id = self._parent_id(parent)
        if parent_id is None and trace is not None and self._foreign:
            parent_id = self._foreign.get(trace)
            if parent_id is not None:
                attrs = {**(attrs or {}), "remote": 1}
        return parent_id, attrs

    def begin(self, name: str, cat: str, txid=None, seq=None, parent=None,
              **attrs) -> Optional[SpanToken]:
        """Open a span; returns a token to ``end()`` (possibly from
        another thread), or None when tracing is off / the tx unsampled.
        Without an explicit ``parent``, the opening thread's innermost
        ``span()`` context is the parent."""
        if not self._admit(txid):
            return None
        trace = _trace_id(txid, seq)
        parent_id, attrs = self._resolve_parent(parent, trace, attrs)
        return SpanToken(
            name, cat, trace, self._next_id(),
            parent_id, time.perf_counter(),
            threading.get_ident(), attrs or None,
        )

    def end(self, token: Optional[SpanToken], **attrs) -> None:
        """Close a span opened with ``begin()``. None tokens are
        accepted so callers never branch on the sampling decision."""
        if token is None:
            return
        t1 = time.perf_counter()
        ms = (t1 - token.t0) * 1000.0
        if attrs:
            token.attrs = {**(token.attrs or {}), **attrs}
        self._record_complete(token, t1, ms)

    def span(self, name: str, cat: str, txid=None, seq=None, parent=None,
             **attrs):
        """``with tracer.span(...):`` — same-thread span with automatic
        parent linkage through the thread-local stack."""
        token = self.begin(name, cat, txid=txid, seq=seq, parent=parent,
                           **attrs)
        if token is None:
            return _NULL_SPAN
        return _SpanCM(self, token)

    def complete(self, name: str, cat: str, t0: float, t1: float,
                 txid=None, seq=None, parent=None, **attrs) -> None:
        """Record an already-measured interval (perf_counter pair) as a
        span — the zero-extra-timing path for subsystems that already
        clock their stages (JobQueue, VerifyPlane, ClosePipeline)."""
        if not self._admit(txid):
            return
        trace = _trace_id(txid, seq)
        parent_id, attrs = self._resolve_parent(parent, trace, attrs)
        token = SpanToken(
            name, cat, trace, self._next_id(),
            parent_id, t0, threading.get_ident(),
            attrs or None,
        )
        self._record_complete(token, t1, (t1 - t0) * 1000.0)

    def _record_complete(self, token: SpanToken, t1: float, ms: float) -> None:
        with self._lock:
            hist = self.stage_hist.get(token.name)
            if hist is None:
                hist = self.stage_hist[token.name] = LatencyHist(
                    bounds=STAGE_BOUNDS, interpolate=True
                )
            hist.record(ms)
            self._ring[self._n % self.capacity] = (
                "X", token.name, token.cat, token.trace, token.span_id,
                token.parent,
                int((token.t0 - self._epoch) * 1e6),
                max(0, int((t1 - token.t0) * 1e6)),
                token.tid, token.attrs,
            )
            self._n += 1
            if self.propagate and token.trace is not None:
                self._note_last_locked(token.trace, token.span_id)
        fl = self.flight
        if fl is not None:
            fl.note_span("X", token.name, token.cat, token.trace, ms)

    def instant(self, name: str, cat: str, txid=None, seq=None, parent=None,
                **attrs) -> None:
        """Point event (consensus round events, splice/fallback marks)."""
        if not self._admit(txid):
            return
        trace = _trace_id(txid, seq)
        parent_id, attrs = self._resolve_parent(parent, trace, attrs)
        span_id = self._next_id()
        self._push((
            "i", name, cat, trace, span_id, parent_id,
            self._now_us(), 0, threading.get_ident(), attrs or None,
        ))
        if self.propagate and trace is not None:
            with self._lock:
                self._note_last_locked(trace, span_id)
        fl = self.flight
        if fl is not None:
            fl.note_span("i", name, cat, trace, 0.0)

    # -- cross-node propagation --------------------------------------------

    def _note_last_locked(self, trace: str, span_id: int) -> None:
        last = self._last
        if trace not in last and len(last) >= _CTX_CAP:
            last.pop(next(iter(last)))
        last[trace] = span_id

    def adopt_context(self, trace: Optional[str], parent: int) -> None:
        """Register a foreign parent span id for a trace (decoded from
        an inbound frame's TraceContext): every span this node records
        for that trace with no local parent links under it, joining the
        sender's tree. No-op when propagation is off."""
        if not (self.enabled and self.propagate) or not trace or not parent:
            return
        with self._lock:
            fg = self._foreign
            if trace not in fg and len(fg) >= _CTX_CAP:
                fg.pop(next(iter(fg)))
            fg[trace] = parent

    def wire_context(self, txid=None, seq=None):
        """Sender side of cross-node propagation: (trace_bytes, parent
        span id, sampled) for an outbound frame, or None when there is
        nothing to join (propagation off, tx unsampled, or no span
        recorded for the trace yet). trace_bytes is the raw 32-byte
        txid for tx traces, the UTF-8 trace id otherwise."""
        if not (self.enabled and self.propagate):
            return None
        if txid is not None and not self.sampled(txid):
            return None
        trace = _trace_id(txid, seq)
        if trace is None:
            return None
        with self._lock:
            parent = self._last.get(trace) or self._foreign.get(trace)
        if parent is None:
            return None
        if isinstance(txid, (bytes, bytearray)) and len(txid) == 32:
            trace_bytes = bytes(txid)
        else:
            trace_bytes = trace.encode()
        return trace_bytes, parent, True

    @staticmethod
    def trace_key(trace_bytes: bytes) -> Optional[str]:
        """Receiver-side inverse of wire_context's trace encoding."""
        if not trace_bytes:
            return None
        if len(trace_bytes) == 32:
            return trace_bytes.hex()
        try:
            return trace_bytes.decode()
        except UnicodeDecodeError:
            return None

    # -- export ------------------------------------------------------------

    def _snapshot_locked(self) -> list[tuple]:
        """Chronological ring contents; caller holds self._lock."""
        n = self._n
        if n <= self.capacity:
            return self._ring[:n]
        i = n % self.capacity
        return self._ring[i:] + self._ring[:i]

    def _snapshot(self) -> list[tuple]:
        with self._lock:
            return list(self._snapshot_locked())

    def chrome_trace(self, reset: bool = False) -> dict:
        """Chrome trace-event JSON (the `trace_dump` payload): complete
        ("X") and instant ("i") events over one pid, tid = recording
        thread, args carrying the causal ids (trace/span/parent) plus
        the span attrs. Loads directly in Perfetto / chrome://tracing.

        `reset=True` drains ATOMICALLY — snapshot and ring clear under
        one lock hold, so a span recorded concurrently lands in exactly
        one window, never between two (stage histograms survive a
        window reset; `reset()` clears those too)."""
        with self._lock:
            recorded = self._n
            snap = list(self._snapshot_locked())
            if reset:
                self._ring = [None] * self.capacity
                self._n = 0
        events = []
        for rec in snap:
            ph, name, cat, trace, span_id, parent, ts, dur, tid, attrs = rec
            args = dict(attrs) if attrs else {}
            if trace is not None:
                args["trace"] = trace
            args["span"] = span_id
            if parent is not None:
                args["parent"] = parent
            ev = {
                "name": name,
                "cat": cat,
                "ph": ph,
                "ts": ts,
                "pid": 1,
                "tid": tid,
                "args": args,
            }
            if ph == "X":
                ev["dur"] = dur
            else:
                ev["s"] = "t"  # instant scope: thread
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "recorded": recorded,
                "dropped": max(0, recorded - self.capacity),
                "sample": self.sample,
            },
        }

    def timeline(self, limit: int = 64) -> list[dict]:
        """Recent consensus/close/persist events, oldest first — the
        compact status timeline block (full detail lives in
        `trace_dump`). Scans the ring BACKWARDS with an early stop so
        a monitoring poll never copies the whole capacity-sized ring
        under the hot-path lock."""
        picked: list[tuple] = []
        with self._lock:
            n = self._n
            ring = self._ring
            start = n - 1
            stop = max(0, n - self.capacity)
            for j in range(start, stop - 1, -1):
                rec = ring[j % self.capacity]
                if rec[2] in _TIMELINE_CATS:
                    picked.append(rec)
                    if len(picked) >= limit:
                        break
        out = []
        for rec in reversed(picked):
            ph, name, cat, trace, _sid, _par, ts, dur, _tid, attrs = rec
            ev = {"name": name, "cat": cat, "ts_ms": round(ts / 1000.0, 3)}
            if trace is not None:
                ev["trace"] = trace
            if ph == "X":
                ev["dur_ms"] = round(dur / 1000.0, 3)
            if attrs:
                ev.update(attrs)
            out.append(ev)
        return out

    # -- introspection / metrics -------------------------------------------

    def get_json(self) -> dict:
        """`trace_status` payload: knobs + ring occupancy + span-derived
        per-stage latency quantiles."""
        with self._lock:
            n = self._n
            stages = {name: h.get_json() for name, h in self.stage_hist.items()}
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "sample": self.sample,
            "propagate": self.propagate,
            "recorded": n,
            "buffered": min(n, self.capacity),
            "dropped": max(0, n - self.capacity),
            "stages": stages,
        }

    def status_json(self, timeline: bool = True) -> dict:
        """One-call status block for the RPC surfaces: get_json plus —
        for ADMIN surfaces — the recent consensus/close timeline (it
        carries txids and peer key prefixes, so GUEST replies must pass
        timeline=False)."""
        out = self.get_json()
        if timeline:
            out["timeline"] = self.timeline()
        return out

    def statsd_hook(self) -> dict:
        """CollectorManager hook: span-derived p50/p90/p99 per stage as
        pull-gauges (`trace.<stage>.p50_ms: v|g` on the wire)."""
        out = {}
        with self._lock:
            hists = list(self.stage_hist.items())
        for name, h in hists:
            if not h.count:
                continue
            out[f"{name}.p50_ms"] = h.quantile(0.5)
            out[f"{name}.p90_ms"] = h.quantile(0.9)
            out[f"{name}.p99_ms"] = h.quantile(0.99)
        return out

    def reset(self) -> None:
        """Drop buffered events and stage histograms (admin
        `trace_dump` with reset=true; test isolation)."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._n = 0
            self.stage_hist = {}
            self._foreign = {}
            self._last = {}


# module-level default: subsystems constructed outside a Node (unit
# tests, embedders) still trace into a shared, bounded recorder; a Node
# builds its own Tracer from [trace] and installs it on the subsystems
# it owns, so two nodes in one process don't interleave rings
_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    return _DEFAULT
