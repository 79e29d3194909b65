"""Span recorder seam of the verify plane and the ledger chain.

The verify plane reports each batch as an already-measured interval
through ``complete()``; ``LedgerMaster`` also opens ``span()`` contexts
and drops ``instant()`` marks for the transactions ``sampled()`` picks.
The causal tracing plane (ring buffer, sampling, Chrome trace export) is
not part of this package, so the default recorder is disabled and drops
everything; a caller that wants spans passes its own object with the
same methods.
"""

from __future__ import annotations

from contextlib import nullcontext

__all__ = ["Tracer", "get_tracer", "STAGE_BOUNDS"]

_NULL_SPAN = nullcontext()

# finer-than-default bounds for span stages: close/persist stages live
# in the 1-500 ms band where the default decade buckets are too coarse
STAGE_BOUNDS = (
    0.1, 0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0, 12.0, 20.0, 30.0, 50.0,
    80.0, 120.0, 200.0, 300.0, 500.0, 800.0, 1200.0, 2000.0, 5000.0,
)


class Tracer:
    enabled = False

    def complete(self, name: str, cat: str, t0: float, t1: float,
                 **attrs) -> None:
        """Record the interval [t0, t1] (perf_counter seconds); a no-op
        while disabled."""

    def span(self, name: str, cat: str, **attrs):
        """``with tracer.span(...):`` — a span around the block; a no-op
        context while disabled."""
        return _NULL_SPAN

    def instant(self, name: str, cat: str, **attrs) -> None:
        """A point event; a no-op while disabled."""

    def sampled(self, txid) -> bool:
        """Whether this transaction's spans are recorded; never while
        disabled."""
        return False


_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    return _DEFAULT
