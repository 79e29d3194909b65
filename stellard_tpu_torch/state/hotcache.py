"""HotNodeCache: the bounded hot-set for faulted SHAMap nodes.

The out-of-core state plane (doc/storage.md) keeps a ledger's tree on
disk and faults nodes into memory on first touch. This cache IS the
resident set: stubs in lazy trees hold nothing but a hash, so once a
faulted node ages out of here (and out of any live mutation path) the
garbage collector reclaims it and the next touch re-faults from the
NodeStore. That inversion — the cache owns residency, the tree owns
only identity — is what turns state size from a RAM problem into a
disk problem.

Three properties the plain TaggedCache (utils/taggedcache.py) lacked:

- **byte-bounded, not entry-bounded** (``[tree] cache_mb``): nodes are
  admitted with a size estimate (blob length + Python object overhead)
  and eviction runs until ``resident_bytes`` fits the budget — an
  entry count says nothing useful when leaves range from 100B SLEs to
  multi-KB directory pages;
- **single-flight faulting**: concurrent faults of the same hash share
  ONE store fetch and get the SAME node object back (per-key in-flight
  latches) — two RPC threads walking the same cold subtree must not
  double-parse or double-fetch, and object identity keeps the
  ``compare``/walk fast paths (``a is b``) effective across readers;
- **epoch-aware eviction** (the readplane contract): every entry
  is stamped with the validated-seq epoch of its last touch, and
  eviction takes old-epoch entries first — the serving snapshot's
  working set (current epoch) survives a history scan that would
  otherwise flush it. Eviction is never *blocked* by an epoch: nodes
  remain in the store, so losing a cache entry costs a re-fault, never
  correctness; the epoch only orders the victims.

Counters ride ``get_counts.shamap_inner_cache``.

Two users share it: the lazy trees' ``NodeSource`` (state/shamap.py),
whose faults are byte-bounded entries, and the eager
``SHAMap.from_store``, whose whole-subtree entries ride the
``EAGER_ENTRY_CAP`` count bound instead.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

__all__ = ["HotNodeCache"]

# per-node resident-size estimate: measured-ish Python costs on CPython
# 3.10 (object header + slots + the hash bytes the node pins). An inner
# additionally pins up to 16 stub objects once traversed; leaves pin
# their item blob. Estimates, not accounting — the bound they enforce
# is approximate by design (the oocsmoke gate checks real RSS).
_INNER_COST = 1200
_LEAF_BASE_COST = 300

# separate entry cap for EAGER from_store inserts: an eagerly-resolved
# inner pins its whole materialized subtree, which the per-node byte
# estimate cannot see — so eager entries keep the bounded-entry
# semantics of the TaggedCache they replaced (4096 entries, LRU) and
# only LAZY entries (whose pinning really is per-node) ride the
# cache_mb byte budget
EAGER_ENTRY_CAP = 4096


def node_cost(node, blob_len: int = 0) -> int:
    """Resident-byte estimate for a faulted node."""
    item = getattr(node, "item", None)
    if item is not None:  # leaf
        return _LEAF_BASE_COST + len(item.data)
    return _INNER_COST + blob_len


class HotNodeCache:
    """Byte-bounded, epoch-aware, single-flight node cache."""

    def __init__(self, name: str = "shamap_inners",
                 limit_bytes: int = 64 << 20):
        self.name = name
        self.limit_bytes = int(limit_bytes)
        # optional node tracer: faults emit `cache.fault` spans so a
        # cold-walk storm is visible on the timeline (node wires it)
        self.tracer = None
        self._lock = threading.Lock()
        # key -> [node, cost, epoch, eager] (mutable lists: hits
        # restamp the epoch in place — no per-hit tuple churn on the
        # fault-descent hot path); OrderedDict tail = most recent
        self._data: "OrderedDict[bytes, list]" = OrderedDict()
        self._inflight: dict[bytes, threading.Event] = {}
        self.resident_bytes = 0
        self.epoch = 0
        self._eager_count = 0
        # entries stamped before the current epoch: eviction's first
        # pass takes them, and skips its scan when there are none
        self._old_count = 0
        # counters (get_counts.shamap_inner_cache)
        self.hits = 0
        self.misses = 0
        self.faults = 0          # loader invocations (store round-trips)
        self.fault_shared = 0    # faults answered by another thread's load
        self.evictions = 0
        self.evicted_bytes = 0
        self.epoch_first_evictions = 0  # victims taken for being old-epoch

    # -- configuration / epochs -------------------------------------------

    def set_limit(self, limit_bytes: int) -> None:
        with self._lock:
            self.limit_bytes = max(0, int(limit_bytes))
            self._evict_locked()

    def advance_epoch(self, epoch: int) -> None:
        """New validated seq published (rpc/readplane.py). Entries the
        new snapshot touches from here on are stamped with it; older
        stamps become preferred eviction victims."""
        with self._lock:
            if epoch > self.epoch:
                self.epoch = epoch
                self._old_count = len(self._data)  # every stamp is behind it

    # -- cache ops ---------------------------------------------------------

    def get(self, key: bytes):
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._restamp(entry)
            self._data.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key: bytes, node, blob_len: int = 0, *,
            cold: bool = False, eager: bool = False) -> None:
        """`cold` stamps the entry one epoch BEHIND current: faults from
        an explicitly cold walk (a historical-ledger RPC scan) become
        first-pass eviction victims, so they cannot thrash the serving
        snapshot's current-epoch working set even within one epoch —
        the mechanism behind the readplane epoch contract. A later hit
        promotes the entry to the current epoch (it proved shared).
        `eager` marks whole-subtree-pinning entries (see
        EAGER_ENTRY_CAP)."""
        cost = node_cost(node, blob_len)
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._drop(old)
            epoch = self.epoch - 1 if cold else self.epoch
            self._old_count += cold
            self._data[key] = [node, cost, epoch, eager]
            self.resident_bytes += cost
            if eager:
                self._eager_count += 1
            self._evict_locked()

    def get_or_load(self, key: bytes, loader: Callable[[bytes], tuple],
                    cold: bool = False):
        """Return the cached node for `key`, or run `loader(key)` exactly
        once across all concurrent callers. `loader` returns
        (node, blob_len); it may raise (KeyError: missing in store;
        ValueError: corrupt) — the error propagates to EVERY waiter of
        this flight and nothing is cached."""
        while True:
            ev = None
            with self._lock:
                entry = self._data.get(key)
                if entry is not None:
                    self._restamp(entry)
                    self._data.move_to_end(key)
                    self.hits += 1
                    return entry[0]
                self.misses += 1
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = ev = threading.Event()
                    mine = True
                else:
                    mine = False
            if not mine:
                # another thread is faulting this hash: wait for its
                # result, then re-check the cache (a failed load leaves
                # no entry — this caller retries the load itself, so a
                # transient error never poisons the key)
                ev.wait()
                with self._lock:
                    entry = self._data.get(key)
                    if entry is not None:
                        self.fault_shared += 1
                        # counted as a hit-by-wait, not a new fault
                        self.hits += 1
                        self.misses -= 1
                        return entry[0]
                continue
            try:
                self.faults += 1
                t0 = time.perf_counter()
                node, blob_len = loader(key)
                tr = self.tracer
                if tr is not None:
                    tr.complete("cache.fault", "state", t0,
                                time.perf_counter(), bytes=blob_len)
            except BaseException:
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()
                raise
            self.put(key, node, blob_len, cold=cold)
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()
            return node

    # -- eviction ----------------------------------------------------------

    def _restamp(self, entry: list) -> None:
        """A hit: the entry joins the current epoch."""
        if entry[2] < self.epoch:
            self._old_count -= 1
        entry[2] = self.epoch

    def _drop(self, entry: list) -> None:
        """Account for an entry leaving the cache (the caller popped it)."""
        self.resident_bytes -= entry[1]
        if entry[3]:
            self._eager_count -= 1
        if entry[2] < self.epoch:
            self._old_count -= 1

    def _evict_locked(self) -> None:
        # pass 0: bound EAGER entries by count (each pins an unaccounted
        # whole subtree — TaggedCache-parity semantics for the eager
        # from_store role): the oldest eager entries go first. The scan
        # stops at the last victim; collecting every eager key first
        # would cost O(EAGER_ENTRY_CAP) per insert, which an eager load
        # of a million-leaf tree pays once per inner node
        if self._eager_count > EAGER_ENTRY_CAP:
            excess = self._eager_count - EAGER_ENTRY_CAP
            victims = []
            for k, e in self._data.items():
                if e[3]:
                    victims.append(k)
                    if len(victims) == excess:
                        break
            for key in victims:
                entry = self._data.pop(key)
                self._drop(entry)
                self.evictions += 1
                self.evicted_bytes += entry[1]
        if self.resident_bytes <= self.limit_bytes:
            return
        # pass 1: old-epoch entries in LRU order, until the bound holds
        # (the serving snapshot's current-epoch working set survives a
        # cold history scan). The scan stops at the last victim, and is
        # skipped when no entry is old: testing every entry on every
        # insert over the bound makes a walk larger than the cache
        # quadratic
        if self._old_count:
            cur, need, victims = self.epoch, self.resident_bytes - self.limit_bytes, []
            for k, e in self._data.items():
                if e[2] < cur:
                    victims.append(k)
                    need -= e[1]
                    if need <= 0 or len(victims) == self._old_count:
                        break
            for key in victims:
                entry = self._data.pop(key)
                self._drop(entry)
                self.evictions += 1
                self.evicted_bytes += entry[1]
                self.epoch_first_evictions += 1
        # pass 2: pure LRU — current-epoch entries too, because the
        # byte bound always wins (re-faulting is cheap; OOM is not)
        while self.resident_bytes > self.limit_bytes and self._data:
            _key, entry = self._data.popitem(last=False)
            self._drop(entry)
            self.evictions += 1
            self.evicted_bytes += entry[1]

    # -- introspection -----------------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.resident_bytes = 0
            self._eager_count = 0
            self._old_count = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get_json(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "size": len(self._data),
                # entry-count "target" kept for dashboard compatibility
                # with the TaggedCache this replaced; the real bound is
                # limit_bytes
                "target": self.limit_bytes,
                "limit_bytes": self.limit_bytes,
                "resident_bytes": self.resident_bytes,
                "epoch": self.epoch,
                "hits": self.hits,
                "misses": self.misses,
                "faults": self.faults,
                "fault_shared": self.fault_shared,
                "evictions": self.evictions,
                "evicted_bytes": self.evicted_bytes,
                "epoch_first_evictions": self.epoch_first_evictions,
            }
