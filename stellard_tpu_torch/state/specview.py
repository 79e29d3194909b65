"""SpecView: a ledger facade for speculative close-mode execution.

The delta-replay close (engine/deltareplay.py) re-executes each
open-accepted transaction in CLOSE mode at submit time, against the state
the real close will start from (the open ledger's state map never mutates
during the open window, so it IS the parent snapshot the close applies
onto). This module provides the view that execution runs against:

- an overlay of the speculative writes accumulated so far this open
  ledger (so same-account sequence chains and dependent txs execute
  against post-predecessor state, exactly like the serial close), and
- read/write-set capture in the Block-STM style (Gelashvili et al.,
  2022): every entry read records (key -> last writer id), every
  order-book/directory ``state_map.succ`` walk records
  (cursor -> next key), every write records the final SLE.

Writer ids are the txids of earlier speculative transactions, or the
PARENT sentinel for state inherited from the parent ledger. At close the
replay context validates a record by comparing these against the close's
own writer map — value equality by provenance, not version arithmetic —
and the succ records against the closing ledger's real state map (phantom
protection for book walks: an entry INSERTED between cursor and the
recorded next key must invalidate, which no per-key version can see).

The parallel apply plane (engine/specexec.py) reuses this view as the
COMMITTED state of its Block-STM scheduler: worker executions capture
against a read-only alias of the overlay, and the commit step folds
validated records back in through ``apply_record`` — in speculation-index
order, by a single committer — so the overlay a later transaction reads
is byte-identical to what the serial path would have built. For process
workers the view also provides a picklable scalar snapshot
(``snapshot_scalars`` / ``from_snapshot``) and an incremental delta apply
(``apply_delta``), so a worker's local replica is a serialized parent
snapshot plus the shipped committed-writer map, never a full state copy.

The facade implements exactly the Ledger surface the close-mode engine
touches (audited in engine/, paths/flow.py, engine/offers.py); anything
else raising AttributeError is a seam audit failure, not a fallback.
"""

from __future__ import annotations

from bisect import bisect_right, insort
from typing import Optional

from ..protocol.stobject import STObject
from ..utils.hashes import HP_TXN_ID, prefix_hash
from .ledger import Ledger
from .shamap import SHAMapItem

__all__ = ["SpecView", "PARENT", "SCALARS"]

# writer-id sentinel for "inherited from the parent ledger"; never
# collides with a txid (txids are 32 bytes)
PARENT = b"\x00parent"

# the header scalars the close-mode engine/transactors read; one tuple so
# the in-process view, the picklable worker snapshot, and the capture
# alias can never drift on which fields a worker must carry
SCALARS = (
    "seq", "parent_close_time", "base_fee", "reference_fee_units",
    "reserve_base", "reserve_increment", "load_factor",
    "tot_coins", "fee_pool", "inflation_seq",
)


class _ShimItem:
    """Minimal SHAMapItem stand-in for overlay-created keys returned by
    the succ shim (callers use .tag only — offers.py / paths/flow.py)."""

    __slots__ = ("tag",)

    def __init__(self, tag: bytes):
        self.tag = tag


class _StateMapShim:
    """state_map facade: parent map merged with the overlay for the
    ``succ`` order-book walks (engine/offers.py:179, paths/flow.py:275).
    Every result is captured as a range read."""

    __slots__ = ("_view",)

    def __init__(self, view: "SpecView"):
        self._view = view

    def succ(self, key: bytes):
        v = self._view
        res = v.resolve_succ(key)
        v._succs.append((key, res.tag if res is not None else None))
        return res


class _TxMapShim:
    """tx_map facade: only ``get`` (Transactor::checkSeq's tefALREADY
    probe) is reachable in close mode; membership is the speculatively
    applied set."""

    __slots__ = ("_applied",)

    def __init__(self):
        self._applied: set[bytes] = set()

    def get(self, txid: bytes):
        return True if txid in self._applied else None

    def add(self, txid: bytes) -> None:
        self._applied.add(txid)


_MISS = object()


class SpecView:
    """Overlay view over an OPEN ledger with per-tx read/write capture.

    One instance lives for the whole open window; ``begin_tx`` /
    ``end_tx`` bracket each speculative execution. Serial callers run
    under the LedgerMaster lock; with the parallel executor, overlay
    mutation is confined to the single commit thread and worker reads
    are optimistic (any torn read is caught by commit validation)."""

    # borrowed verbatim: both read only scalar attrs this view carries
    reserve = Ledger.reserve
    scale_fee_load = Ledger.scale_fee_load

    def __init__(self, ledger: Ledger):
        self._parent = ledger
        # header scalars the close-mode engine/transactors read; the
        # close ledger is a sibling successor of the same parent, so
        # these are byte-equal to what the close view will present.
        # (tot_coins/fee_pool/inflation_seq are engine-mutated scratch —
        # fee burn, inflation header deltas — consumed per record,
        # never written back to the real ledger.)
        for name in SCALARS:
            setattr(self, name, getattr(ledger, name))
        self.parsed_metas: dict[bytes, STObject] = {}
        self.state_map = _StateMapShim(self)
        self.tx_map = _TxMapShim()
        # overlay: key -> final SLE (None = deleted); writers: key ->
        # txid of the last speculative writer
        self._overlay: dict[bytes, Optional[STObject]] = {}
        self._writers: dict[bytes, bytes] = {}
        self._created: list[bytes] = []  # sorted overlay-created keys
        self._created_set: set[bytes] = set()
        # per-tx capture
        self._reads: dict[bytes, bytes] = {}
        self._succs: list[tuple[bytes, Optional[bytes]]] = []
        self._writes: list[tuple[bytes, Optional[STObject]]] = []
        self._txid: bytes = b""

    # -- worker transport (engine/specexec.py process mode) ---------------

    def snapshot_scalars(self) -> dict:
        """Picklable header-scalar snapshot for worker transport: with a
        parent adapter (read-through to the real parent state) this is
        ALL the per-window state a worker needs up front — the overlay
        arrives incrementally as committed-writer deltas."""
        return {name: getattr(self, name) for name in SCALARS}

    @classmethod
    def from_snapshot(cls, scalars: dict, parent) -> "SpecView":
        """Rebuild a view in a worker process from ``snapshot_scalars``
        output plus a parent adapter exposing ``read_entry_pristine``
        and ``state_map.get/succ`` (the read-through IPC shim)."""
        view = cls.__new__(cls)
        view._parent = parent
        for name in SCALARS:
            setattr(view, name, scalars[name])
        view.parsed_metas = {}
        view.state_map = _StateMapShim(view)
        view.tx_map = _TxMapShim()
        view._overlay = {}
        view._writers = {}
        view._created = []
        view._created_set = set()
        view._reads = {}
        view._succs = []
        view._writes = []
        view._txid = b""
        return view

    # -- capture brackets -------------------------------------------------

    def begin_tx(self, txid: bytes) -> None:
        self._txid = txid
        self._reads = {}
        self._succs = []
        self._writes = []

    def end_tx(self):
        """-> (reads, succs, writes) captured since begin_tx."""
        return self._reads, self._succs, self._writes

    # -- Ledger read surface ----------------------------------------------

    def read_entry_pristine(self, index: bytes) -> Optional[STObject]:
        sle = self._overlay.get(index, _MISS)
        if sle is not _MISS:
            if type(sle) is SHAMapItem:
                sle = self._upgrade(index, sle)
            if index not in self._reads:
                # .get with the PARENT default (not [index]): a parallel
                # worker may observe the overlay key before the writer
                # entry lands — commit validation rejects the torn read
                self._reads[index] = self._writers.get(index, PARENT)
            return sle
        if index not in self._reads:
            self._reads[index] = PARENT
        return self._parent.read_entry_pristine(index)

    def _upgrade(self, index: bytes, item: SHAMapItem) -> STObject:
        """Parse a lazily-committed write item and promote it in place.
        Only commit-serialized readers (the committer's serial
        fallbacks, the close after end_window) may call this: the
        store-back mutates the shared overlay, and a thread-mode worker
        doing it concurrently with a commit could clobber a newer
        committed value with this stale parse."""
        sle = item.parsed
        if sle is None:
            sle = item.parsed = STObject.from_bytes(item.data)
        self._overlay[index] = sle
        return sle

    def peek(self, key: bytes):
        """(value, writer-provenance) for the MERGED view — overlay hit
        returns the committed writer's txid, parent fall-through returns
        PARENT — with NO read capture and NO overlay mutation: thread-
        mode workers call this concurrently with the committer, so the
        parse memo lands only on the item (idempotent), never as a
        store-back. Provenance is read BEFORE the value: paired with
        apply_record's value-before-writer store order, a torn read can
        only pair a NEWER value with an OLDER writer id — which commit
        validation rejects — never a stale value with the current
        writer id, which it would wrongly pass."""
        w = self._writers.get(key, PARENT)
        v = self._overlay.get(key, _MISS)
        if v is not _MISS:
            if type(v) is SHAMapItem:
                sle = v.parsed
                if sle is None:
                    sle = v.parsed = STObject.from_bytes(v.data)
                v = sle
            return v, w
        return self._parent.read_entry_pristine(key), PARENT

    def merged_has(self, key: bytes) -> bool:
        """Existence probe on the merged view (no parse, no capture) —
        the worker-view write path's spring-into-existence check."""
        v = self._overlay.get(key, _MISS)
        if v is not _MISS:
            return v is not None
        return self._parent.state_map.get(key) is not None

    def resolve_succ(self, key: bytes):
        """Overlay-merged ``state_map.succ``: the parent map's successor
        (skipping overlay-deleted keys) merged with overlay-created keys.
        Shared by the capture shim, the parallel executor's commit-time
        succ re-validation, and the serial path — one resolution, three
        callers."""
        cur = key
        while True:
            item = self._parent.state_map.succ(cur)
            if item is None or self._overlay.get(item.tag, _MISS) is not None:
                break
            cur = item.tag
        created = self._created_after(key)
        if item is not None and (created is None or item.tag < created):
            return item
        if created is not None:
            return _ShimItem(created)
        return None

    def _created_remove(self, key: bytes) -> bool:
        """Drop ``key`` from the overlay-created bookkeeping (set + the
        sorted succ-merge list). One definition for every writer — the
        serial write surface, the commit fold, worker delta application,
        and the worker replica's tentative chain/rollback — so the
        bisect boundary can never drift between copies. -> True when the
        key was tracked."""
        if key not in self._created_set:
            return False
        self._created_set.discard(key)
        i = bisect_right(self._created, key) - 1
        if 0 <= i < len(self._created) and self._created[i] == key:
            del self._created[i]
        return True

    # -- Ledger write surface (reached only via LedgerEntrySet.apply /
    # the engine's commit tail, i.e. after a successful execution) --------

    def write_entry(self, index: bytes, sle: STObject) -> None:
        prev = self._overlay.get(index, _MISS)
        if index not in self._created_set and (prev is _MISS or prev is None):
            # key springing into existence: it joins the succ-shim merge
            # list only when the parent map lacks it (existence probe on
            # the raw map — not an execution read, so not captured)
            if self._parent.state_map.get(index) is None:
                insort(self._created, index)
                self._created_set.add(index)
        self._overlay[index] = sle
        self._writers[index] = self._txid
        self._writes.append((index, sle))

    def delete_entry(self, index: bytes) -> None:
        self._created_remove(index)
        self._overlay[index] = None
        self._writers[index] = self._txid
        self._writes.append((index, None))

    def record_transaction(self, tx_blob: bytes, meta: STObject) -> bytes:
        """Engine commit-tail seam: membership for the checkSeq probe +
        the meta object for the record — the meta bytes are never needed
        here (the splice re-serializes after re-indexing anyway)."""
        txid = prefix_hash(HP_TXN_ID, tx_blob)
        self.tx_map.add(txid)
        self.parsed_metas[txid] = meta
        return txid

    # -- committed-state application (engine/specexec.py) -----------------

    def apply_record(self, txid: bytes, write_items, applied: bool):
        """Fold one validated parallel record's compacted write set into
        the overlay, exactly as the serial write surface would have —
        same spring-into-existence probe, same created-list upkeep —
        but with no capture (this is the COMMIT step, not an execution).
        Single-committer discipline: only the executor's commit thread
        calls this. Returns (created_added, created_removed) for the
        process-worker delta log."""
        added: list[bytes] = []
        removed: list[bytes] = []
        for k, item in write_items:
            if item is None:
                if self._created_remove(k):
                    removed.append(k)
                self._overlay[k] = None
            else:
                prev = self._overlay.get(k, _MISS)
                if k not in self._created_set and (prev is _MISS or prev is None):
                    if self._parent.state_map.get(k) is None:
                        insort(self._created, k)
                        self._created_set.add(k)
                        added.append(k)
                # store the item raw: the read path's _upgrade parses
                # lazily, keeping the commit thread off the per-write
                # STObject parse (wire items arrive unparsed)
                self._overlay[k] = item
            # writer AFTER the value (peek reads in the opposite order):
            # an optimistic reader can then only pair a stale PROVENANCE
            # with a newer value — a conservative validation abort — and
            # never the unsafe converse (stale value, current writer id),
            # which validation would pass
            self._writers[k] = txid
        if applied:
            self.tx_map.add(txid)
        return added, removed

    def apply_delta(self, txid: bytes, pairs, created_added,
                    created_removed, applied: bool,
                    writer=None) -> None:
        """Worker-side mirror of one committed record: raw (key, bytes)
        write pairs plus the AUTHORITATIVE created-set delta computed by
        the parent committer — so the worker replica never probes the
        parent map for existence (each probe would be an IPC round
        trip). ``writer`` overrides the provenance stored for these keys
        — the parallel executor passes an (txid, attempt) epoch so a
        read of a TENTATIVE (possibly-aborted) value can never validate
        against the txid's eventually-committed execution."""
        wid = writer if writer is not None else txid
        for k, data in pairs:
            self._writers[k] = wid
            # store the raw item and let the read path's _upgrade parse
            # it lazily: most committed writes are never read by this
            # replica, so the eager per-delta STObject parse is waste
            self._overlay[k] = (
                SHAMapItem(k, data) if data is not None else None
            )
        for k in created_removed:
            self._created_remove(k)
        for k in created_added:
            if k not in self._created_set:
                insort(self._created, k)
                self._created_set.add(k)
        if applied:
            self.tx_map.add(txid)

    # -- succ-shim helpers ------------------------------------------------

    def _created_after(self, key: bytes) -> Optional[bytes]:
        i = bisect_right(self._created, key)
        return self._created[i] if i < len(self._created) else None
