"""The cyclic garbage collector's policy for a process that holds a
node's state.

A node keeps millions of long-lived objects: a resumed state tree, its
ledger history, the trees a catch-up replay loads. CPython's default
thresholds (700, 10, 10) then run a full collection, a scan of every
tracked object, every few hundred thousand allocations, and each scans
the whole state again though none of it is garbage. So while a node
serves, or a replay runs, the process takes ``THRESHOLDS``; a serving
node also freezes the heap it started with (``gc.freeze``), which the
collector then no longer scans. The last holder to let go restores the
thresholds it found and unfreezes the heap.

Only when the collector runs changes: no result does. (The JAX package
leaves the collector at its defaults.)
"""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager

# a young generation of 50,000 objects makes full collections rare
THRESHOLDS = (50_000, 20, 20)

_lock = threading.Lock()
_holders = 0
_saved = (700, 10, 10)


def hold(freeze: bool = False) -> None:
    """Take THRESHOLDS for the process; with ``freeze``, collect once and
    freeze every object alive now."""
    global _holders, _saved
    with _lock:
        if _holders == 0:
            _saved = gc.get_threshold()
            gc.set_threshold(*THRESHOLDS)
        _holders += 1
        if freeze:
            gc.collect()
            gc.freeze()


def release() -> None:
    """Let go of one hold; the last restores the thresholds found and
    unfreezes the heap."""
    global _holders
    with _lock:
        _holders -= 1
        if _holders == 0:
            gc.set_threshold(*_saved)
            gc.unfreeze()


@contextmanager
def held():
    """THRESHOLDS for the block (a replay's)."""
    hold()
    try:
        yield
    finally:
        release()
