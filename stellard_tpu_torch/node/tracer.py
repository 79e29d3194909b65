"""Span recorder seam of the verify plane.

The plane reports each batch as an already-measured interval through
``complete()``. The causal tracing plane (ring buffer, sampling, Chrome
trace export) is not part of this package, so the default recorder is
disabled and drops every span; a caller that wants spans passes its own
object with the same ``complete`` method.
"""

from __future__ import annotations

__all__ = ["Tracer", "get_tracer"]


class Tracer:
    enabled = False

    def complete(self, name: str, cat: str, t0: float, t1: float,
                 **attrs) -> None:
        """Record the interval [t0, t1] (perf_counter seconds); a no-op
        while disabled."""


_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    return _DEFAULT
