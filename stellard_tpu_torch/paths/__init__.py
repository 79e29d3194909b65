"""Payment paths: multi-hop cross-currency execution and path search.

Reference: src/ripple_app/paths/ — RippleCalc.cpp (path execution,
2863 LoC), Pathfinder.cpp (path search, 937 LoC), PathState.cpp.

This package replaces the reference's entangled per-node
calcNodeRev/Fwd state machine with a strand model: a path is compiled
into a list of hops (trust-line hops and order-book hops), executed
forward over a sandboxed LedgerEntrySet with exact output targets, and
multi-path payments repeatedly take the best-quality strand — same
semantics, separable pieces.
"""

from .flow import PathError, flow, plan_strand
from .orderbook import Book, LiveBookIndex, OrderBookDB
from .pathfinder import find_paths

__all__ = [
    "Book",
    "LiveBookIndex",
    "OrderBookDB",
    "PathError",
    "find_paths",
    "flow",
    "plan_strand",
]
