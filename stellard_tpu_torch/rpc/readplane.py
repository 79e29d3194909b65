"""Read plane: the serving side's view of validated state.

Two pieces, both designed so the hot read path never touches the chain
lock (reference: reporting-mode rippled's read-only ETL tier; ROADMAP
item 3):

``ReadPlane`` holds an immutable validated-snapshot pointer.
``publish_closed_ledger`` hands each newly validated ledger here after
its persistence sinks ran; read RPCs resolve ``ledger_index:
"validated"`` from this pointer with a bare attribute read — a held
chain lock can no longer block ``account_info`` against the last
validated snapshot (pinned by test).

``ResultCache`` memoizes whole RPC results keyed by
``(validated_seq, method, canonical-params)``. A validated ledger is
immutable, so an entry is immutable by construction; invalidation is
by NEW SEQ, not by write tracking — publishing seq N+1 swaps the whole
generation. One slow epoch boundary beats per-entry bookkeeping on
every read.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Optional

__all__ = ["ReadPlane", "ResultCache", "CACHEABLE_METHODS",
           "forever_slot"]

# the hot read RPCs worth a whole-result cache; everything
# else recomputes — these dominate production read traffic.
# ripple_path_find too: a path search is a pure function
# of the validated snapshot and by far the dearest entry in the fee
# schedule (FEE_PATH_FIND), so identical back-to-back queries within
# one validated epoch must not recompute.
CACHEABLE_METHODS = frozenset(
    {"account_info", "book_offers", "ledger", "account_tx",
     "ripple_path_find"}
)


class ReadPlane:
    """Latest-validated-snapshot pointer + its result cache epoch.

    ``publish`` is called from ``publish_closed_ledger`` AFTER its
    persistence sinks ran (leader close path and follower ingest path
    alike), so a cache epoch never opens before the SQL-index
    read-your-writes wait can see the ledger; ``snapshot`` is called
    from every read RPC. The pointer swap is a single attribute
    assignment — readers never block on a lock, and a reader that
    races a publish sees either snapshot, both of which are complete
    immutable closed ledgers.
    """

    def __init__(self, cache: Optional["ResultCache"] = None):
        self._snap = None  # latest validated Ledger (closed, immutable)
        self._lock = threading.Lock()  # serializes publishers only
        self.cache = cache
        self.published = 0
        # the two floors the snapshot must stay behind: the persisted
        # tip (publish_closed_ledger, post-sinks) and the quorum-
        # validated tip (LedgerMaster.on_validated). The snapshot is
        # min(persisted, validated) — never an unvalidated solo close,
        # never a validated-but-not-yet-persisted ledger (a cache epoch
        # must not open before _await_history can see its ledger).
        self._persisted = None
        self._validated_tip = None
        # archive mode (doc/archive.md): the verified floor — the
        # contiguous sealed-shard coverage hi. 0 = not an archive (or
        # nothing verified yet); > 0 arms the forever cache tier for
        # results whose window closes at or below it.
        self.archive_floor = 0

    def set_archive_floor(self, floor: int) -> None:
        """Publish the archive's verified floor. Monotonic: verified
        history never un-verifies, so the floor only rises."""
        with self._lock:
            self.archive_floor = max(self.archive_floor, int(floor))

    def note_persisted(self, ledger) -> None:
        """A closed ledger finished its persistence sinks."""
        with self._lock:
            if ledger is None or not getattr(ledger, "closed", False):
                return
            cur = self._persisted
            if cur is None or ledger.seq > cur.seq:
                self._persisted = ledger
            self._refresh_locked()

    def note_validated(self, ledger) -> None:
        """The chain's validated tip advanced (quorum landed). On a
        quorum net validations usually land AFTER the close persisted —
        this is the call that opens the epoch; without it the snapshot
        would lag a full round behind forever."""
        with self._lock:
            if ledger is None:
                return
            cur = self._validated_tip
            if cur is None or ledger.seq > cur.seq:
                self._validated_tip = ledger
            self._refresh_locked()

    def _refresh_locked(self) -> None:
        p, v = self._persisted, self._validated_tip
        if p is None or v is None:
            return
        cand = p if p.seq <= v.seq else v
        self._publish_locked(cand)

    def publish(self, ledger) -> None:
        """Adopt `ledger` as the serving snapshot if it advances the
        tip. Monotonic by seq: a late-persisting historical repair must
        never regress what reads see."""
        with self._lock:
            self._publish_locked(ledger)

    def _publish_locked(self, ledger) -> None:
        if ledger is None or not getattr(ledger, "closed", False):
            return
        cur = self._snap
        if cur is not None and ledger.seq <= cur.seq:
            return
        self._snap = ledger
        self.published += 1
        if self.cache is not None:
            self.cache.on_new_seq(ledger.seq)
        # out-of-core epoch contract: stamp the hot-node cache with the
        # new validated seq — nodes the serving snapshot touches from
        # here carry this epoch, and eviction takes older-epoch entries
        # first, so a history scan cannot thrash the snapshot's working
        # set out from under in-flight reads (state/hotcache.py)
        from ..state.shamap import inner_node_cache

        inner_node_cache().advance_epoch(ledger.seq)

    def snapshot(self):
        return self._snap

    def get_json(self) -> dict:
        snap = self._snap
        return {
            "published": self.published,
            "snapshot_seq": snap.seq if snap is not None else 0,
            "archive_floor": self.archive_floor,
        }


class ResultCache:
    """Validated-seq-keyed whole-result cache for the hot read RPCs.

    get/put carry the seq the caller resolved; only the CURRENT epoch's
    seq hits, so an entry can never serve stale state — a new validated
    seq invalidates everything older in O(1) (generation swap). Bounded:
    past `capacity` entries the current generation stops admitting (a
    hostile key-churn workload must not grow memory; legitimate hot keys
    land early in the epoch)."""

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._seq = -1
        self._gen: dict[tuple, dict] = {}
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.overflow = 0
        self.invalidated = 0
        # the forever tier (archive mode, doc/archive.md): results of
        # IMMUTABLE windows — closed at or below the archive's verified
        # floor — keyed by (method, params) alone. The epoch swap in
        # on_new_seq never touches it: sealed history cannot change, so
        # re-deriving these per epoch would be pure waste. Bounded by
        # the same capacity as a generation.
        self._forever: dict[tuple, dict] = {}
        self.forever_hits = 0
        self.forever_inserts = 0
        self.forever_overflow = 0

    def on_new_seq(self, seq: int) -> None:
        with self._lock:
            if seq == self._seq:
                return
            self.invalidated += len(self._gen)
            self._seq = seq
            self._gen = {}
            # self._forever survives by design — immutable-seq results
            # outlive every epoch (doc/archive.md)

    def get(self, seq: int, method: str, key: str) -> Optional[dict]:
        with self._lock:
            if seq != self._seq:
                self.misses += 1
                return None
            hit = self._gen.get((method, key))
            if hit is None:
                self.misses += 1
                return None
            self.hits += 1
        # shallow copy: the doors annotate results in place ("status")
        return dict(hit)

    def put(self, seq: int, method: str, key: str, result: dict) -> None:
        with self._lock:
            if seq != self._seq:
                return  # computed against a superseded epoch
            if len(self._gen) >= self.capacity:
                self.overflow += 1
                return
            self._gen[(method, key)] = result
            self.inserts += 1

    def get_forever(self, method: str, key: str) -> Optional[dict]:
        """Forever-tier lookup: no seq — the key IS the whole identity
        of an immutable-window result."""
        with self._lock:
            hit = self._forever.get((method, key))
            if hit is None:
                return None
            self.forever_hits += 1
        return dict(hit)

    def put_forever(self, method: str, key: str, result: dict) -> None:
        with self._lock:
            if len(self._forever) >= self.capacity:
                self.forever_overflow += 1
                return
            self._forever[(method, key)] = result
            self.forever_inserts += 1

    def get_json(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "seq": self._seq,
                "entries": len(self._gen),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
                "inserts": self.inserts,
                "overflow": self.overflow,
                "invalidated": self.invalidated,
                "forever_entries": len(self._forever),
                "forever_hits": self.forever_hits,
                "forever_inserts": self.forever_inserts,
                "forever_overflow": self.forever_overflow,
            }


def serving_validated(node):
    """The ledger "validated" reads serve: the read plane's published
    snapshot, or the chain's validated tip when it is newer (the
    snapshot publishes post-persist, so it can lag a just-validated
    ledger by one publish — reads must never go backwards). Bare
    attribute reads only: no chain lock."""
    plane = getattr(node, "read_plane", None)
    snap = plane.snapshot() if plane is not None else None
    lv = getattr(node, "ledger_master", None)
    lv = lv.validated if lv is not None else None
    if snap is None:
        return lv
    if lv is not None and lv.seq > snap.seq:
        return lv
    return snap


def cache_slot(ctx, method: str):
    """(serving_ledger, canonical-params-key) when this request is
    servable from the validated-seq cache, else None.

    Eligible: the method is one of the hot four, a validated snapshot
    exists, and the request is a pure function of that snapshot — the
    ledger-selector methods must target VALIDATED state (an explicit
    ``ledger_index: "validated"``, or the selector-less default on a
    node that serves validated by default — follower mode);
    ``account_tx`` reads the SQL history index, which also holds
    closed-but-not-yet-validated ledgers, so it is cacheable only when
    its window is EXPLICITLY bounded at or below the serving validated
    seq (persisted history ≤ the validated floor is immutable; an
    open-ended window keeps growing within one epoch on a node whose
    closes outpace its validations)."""
    node = ctx.node
    cache = getattr(node, "read_cache", None)
    if cache is None or method not in CACHEABLE_METHODS:
        return None
    # key by the ledger the request will actually serve. When the chain
    # validated ahead of the published snapshot, this seq is ahead of
    # the cache's epoch, so get/put are refused — caching simply stays
    # off until the epoch opens (post-persist, post-validation)
    snap = serving_validated(node)
    if snap is None:
        return None
    p = ctx.params
    if method == "account_tx":
        try:
            max_l = int(p.get("ledger_index_max", -1))
        except (TypeError, ValueError):
            return None
        if max_l < 0 or max_l > snap.seq:
            return None
    else:
        if p.get("ledger_hash"):
            return None
        sel = p.get("ledger_index")
        if sel is None:
            if not getattr(node, "serve_validated_default", False):
                return None
        elif sel != "validated":
            return None
    try:
        key = json.dumps(p, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError):
        return None  # non-JSON params (embedded callers): uncacheable
    return snap, key


def forever_slot(ctx, method: str) -> Optional[str]:
    """Canonical params key when this request is IMMUTABLE — its window
    closes at or below the archive's verified floor (doc/archive.md) —
    else None.

    An immutable result is a pure function of offline-verified sealed
    history, so it survives every epoch swap: caching it per validated
    seq (the epoch tier) would re-derive the same bytes forever. Only
    two methods qualify, and only with an EXPLICITLY bounded window:

    - ``account_tx`` with ``0 <= ledger_index_max <= floor`` (an
      unbounded max keeps growing with the chain; above the floor the
      window includes un-verified — and on a validator, trimmable —
      history);
    - ``ledger`` addressed by a numeric seq at or below the floor
      ("validated"/"closed"/"current" selectors are moving targets).

    The floor itself only rises (verified history never un-verifies),
    so eligibility decided against an older floor stays correct."""
    node = ctx.node
    cache = getattr(node, "read_cache", None)
    plane = getattr(node, "read_plane", None)
    if cache is None or plane is None:
        return None
    floor = getattr(plane, "archive_floor", 0)
    if floor <= 0:
        return None
    p = ctx.params
    if method == "account_tx":
        try:
            max_l = int(p.get("ledger_index_max", -1))
        except (TypeError, ValueError):
            return None
        if max_l < 0 or max_l > floor:
            return None
    elif method == "ledger":
        if p.get("ledger_hash"):
            return None
        sel = p.get("ledger_index")
        if isinstance(sel, bool):
            return None
        try:
            seq = int(sel)
        except (TypeError, ValueError):
            return None
        if seq <= 0 or seq > floor:
            return None
    else:
        return None
    try:
        return json.dumps(p, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError):
        return None  # non-JSON params (embedded callers): uncacheable


def cached_dispatch(ctx, method: str, compute) -> dict:
    """Wrap one handler call with the validated-seq result cache.
    ``compute()`` runs the real handler; error results are never
    cached (they may reflect transient state like a draining
    pipeline). The serving ledger is PINNED into the context so the
    handler resolves exactly the ledger the cache key names — without
    the pin, a validated tip advancing between keying and compute
    would cache a newer ledger's answer under the older epoch.

    Archive mode: the forever tier is consulted FIRST — an immutable-
    window result (forever_slot) hits across epoch swaps; a computed
    one is admitted to the forever tier (and, when also epoch-
    eligible, the per-seq generation)."""
    fkey = forever_slot(ctx, method)
    cache: Optional[ResultCache] = getattr(ctx.node, "read_cache", None)
    if fkey is not None and cache is not None:
        hit = cache.get_forever(method, fkey)
        if hit is not None:
            return hit
    slot = cache_slot(ctx, method)
    if slot is None:
        result = compute()
        if (fkey is not None and cache is not None
                and isinstance(result, dict) and "error" not in result):
            cache.put_forever(method, fkey, result)
            return dict(result)
        return result
    snap, key = slot
    ctx.pinned_validated = snap
    hit = cache.get(snap.seq, method, key)
    if hit is not None:
        if fkey is not None:
            # promote an epoch-tier hit whose window is immutable: the
            # next epoch swap must not evict it
            cache.put_forever(method, fkey, hit)
        return hit
    result = compute()
    if isinstance(result, dict) and "error" not in result:
        if fkey is not None:
            cache.put_forever(method, fkey, result)
        cache.put(snap.seq, method, key, result)
        return dict(result)  # callers may annotate; keep the cached copy clean
    return result
