"""HashRouter: suppression table + per-hash flags.

Reference: src/ripple_app/misc/{IHashRouter.h,HashRouter.cpp} — dedups
relays (by 256-bit hash + set of peers that already sent it) and memoizes
signature verdicts process-wide (SF_SIGGOOD/SF_BAD), which is what lets
the consensus close path skip re-verification
(LedgerConsensus.cpp:2101-2106).
"""

from __future__ import annotations

import threading
import time

__all__ = [
    "HashRouter",
    "SF_RELAYED",
    "SF_BAD",
    "SF_SIGGOOD",
    "SF_SAVED",
    "SF_RETRY",
    "SF_TRUSTED",
]

# reference: IHashRouter.h:27-33
SF_RELAYED = 0x01  # has already been relayed to peers
SF_BAD = 0x02  # signature/format known bad
SF_SIGGOOD = 0x04  # signature known good
SF_SAVED = 0x08
SF_RETRY = 0x10
SF_TRUSTED = 0x20

_HOLD_SECONDS = 300  # reference: HashRouter holdTime


class _Entry:
    __slots__ = ("flags", "peers", "touched")

    def __init__(self):
        self.flags = 0
        self.peers: set[int] = set()
        self.touched = time.monotonic()


class HashRouter:
    def __init__(self, hold_seconds: float = _HOLD_SECONDS):
        self._lock = threading.Lock()
        self._map: dict[bytes, _Entry] = {}
        self._hold = hold_seconds
        self._last_sweep = time.monotonic()

    def _get(self, h: bytes) -> _Entry:
        e = self._map.get(h)
        if e is None:
            e = self._map[h] = _Entry()
        e.touched = time.monotonic()
        if e.touched - self._last_sweep > self._hold:
            self._sweep(e.touched)
        return e

    def _sweep(self, now: float) -> None:
        self._last_sweep = now
        dead = [h for h, e in self._map.items() if now - e.touched > self._hold]
        for h in dead:
            del self._map[h]

    # -- suppression (reference: addSuppressionPeer) ----------------------

    def add_suppression_peer(self, h: bytes, peer: int) -> bool:
        """Record that `peer` sent `h`; True if this hash is NEW
        (i.e. should be processed, not a duplicate)."""
        return self.note_peer(h, peer)[0]

    def note_peer(self, h: bytes, peer: int) -> tuple[bool, bool]:
        """Suppression with re-send attribution: (is_new, same_peer_dup).
        ``same_peer_dup`` is True when THIS peer already sent this hash —
        an honest relay mesh delivers each hash once per neighbor, so a
        same-peer re-send is the flooder signature the resource plane
        charges (cross-peer duplicates stay free)."""
        with self._lock:
            known = h in self._map
            e = self._get(h)
            resend = peer in e.peers
            e.peers.add(peer)
            return not known, known and resend

    def get_flags(self, h: bytes) -> int:
        with self._lock:
            e = self._map.get(h)
            return e.flags if e else 0

    def set_flag(self, h: bytes, flag: int) -> bool:
        """OR a flag in; True if the flag was newly set."""
        with self._lock:
            e = self._get(h)
            was = e.flags & flag
            e.flags |= flag
            return not was

    def swap_set(self, h: bytes, peers: set[int], flag: int) -> tuple[set[int], bool]:
        """Atomically take the peer set (for relay fan-out exclusion) and
        set a flag (reference: swapSet used on SF_RELAYED before
        broadcast). Returns (previous peers, flag newly set)."""
        with self._lock:
            e = self._get(h)
            prev = e.peers
            e.peers = set()
            was = e.flags & flag
            e.flags |= flag
            return prev, not was

    def size(self) -> int:
        with self._lock:
            return len(self._map)
