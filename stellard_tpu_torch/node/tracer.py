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

__all__ = ["Tracer", "get_tracer"]

_NULL_SPAN = nullcontext()


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
