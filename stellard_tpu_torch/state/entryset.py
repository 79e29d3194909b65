"""LedgerEntrySet: transactional view over a ledger during tx application.

Reference: src/ripple_app/ledger/LedgerEntrySet.{h,cpp} (1.8k LoC) — entry
cache with CACHED/MODIFIED/DELETED/CREATED actions, directory-page
management (DIR_NODE_MAX=32, LedgerEntrySet.cpp:29,690-770 dirAdd,
:780-960 dirDelete), owner-count bookkeeping, and transaction-metadata
generation (calcRawMeta, LedgerEntrySet.cpp:1030-1160).

Because the underlying SHAMap is persistent, `apply()` simply writes the
final entries into the (cheap) current ledger — there is no undo machinery;
a failed transaction's entry set is dropped on the floor.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, Iterator, Optional

from ..protocol.formats import LedgerEntryType
from ..protocol.sfields import (
    sfAffectedNodes,
    sfCreatedNode,
    sfDeletedNode,
    sfFinalFields,
    sfIndexNext,
    sfIndexPrevious,
    sfIndexes,
    sfLedgerEntryType,
    sfLedgerIndex,
    sfModifiedNode,
    sfNewFields,
    sfOwnerCount,
    sfPreviousFields,
    sfPreviousTxnID,
    sfPreviousTxnLgrSeq,
    sfRootIndex,
    sfTransactionIndex,
    sfTransactionResult,
)
from ..protocol.stobject import STArray, STObject
from ..protocol.ter import TER
from . import indexes
from .ledger import Ledger

__all__ = ["LedgerEntrySet", "Action", "DIR_NODE_MAX"]

DIR_NODE_MAX = 32  # entries per directory page (LedgerEntrySet.cpp:29)

# Fields that always appear in metadata FinalFields/PreviousFields filters.
# The reference drives this off per-field metadata flags (SField sMD_*);
# here: everything except the entry type marker participates.
_META_SKIP = {sfLedgerEntryType}


class Action(IntEnum):
    """reference: LedgerEntryAction (LedgerEntrySet.h taaCACHED...)"""

    CACHED = 0
    MODIFIED = 1
    DELETED = 2
    CREATED = 3


class _Entry:
    __slots__ = ("sle", "action", "orig")

    def __init__(self, sle: Optional[STObject], action: Action,
                 orig: Optional[STObject]):
        self.sle = sle  # working copy (mutable)
        self.action = action
        self.orig = orig  # as read from the ledger (immutable baseline)


class LedgerEntrySet:
    def __init__(self, ledger: Ledger):
        self.ledger = ledger
        self._entries: dict[bytes, _Entry] = {}

    # -- entry cache ------------------------------------------------------

    def peek(self, index: bytes) -> Optional[STObject]:
        """Read-through cache; returns the working copy (mutate + call
        `modify` to record). reference: entryCache — a DELETED entry reads
        as absent (LedgerEntrySet.cpp getEntry taaDELETE arm)."""
        e = self._entries.get(index)
        if e is not None:
            return None if e.action == Action.DELETED else e.sle
        # orig is the SHARED pristine parse (never mutated here: it is
        # only compared/iterated for metadata deltas); the working copy
        # detaches from it
        orig = self.ledger.read_entry_pristine(index)
        if orig is None:
            return None
        work = orig.copy()
        self._entries[index] = _Entry(work, Action.CACHED, orig)
        return work

    def create(self, entry_type: LedgerEntryType, index: bytes) -> STObject:
        """reference: entryCreate (LedgerEntrySet.cpp:161-197) — create
        after delete collapses to a modify of the fresh object."""
        e = self._entries.get(index)
        sle = STObject()
        sle[sfLedgerEntryType] = int(entry_type)
        if e is not None:
            if e.action != Action.DELETED:
                raise ValueError(f"entry {index.hex()[:16]} already exists")
            e.sle = sle
            e.action = Action.MODIFIED
            return sle
        if self.ledger.read_entry_pristine(index) is not None:
            raise ValueError(f"entry {index.hex()[:16]} already in ledger")
        self._entries[index] = _Entry(sle, Action.CREATED, None)
        return sle

    def modify(self, index: bytes) -> None:
        """Mark a peeked entry dirty. reference: entryModify."""
        e = self._entries[index]
        if e.action == Action.CACHED:
            e.action = Action.MODIFIED
        elif e.action == Action.DELETED:
            raise ValueError("modify after delete")

    def erase(self, index: bytes) -> None:
        """reference: entryDelete"""
        e = self._entries.get(index)
        if e is None:
            if self.peek(index) is None:
                raise KeyError(index.hex())
            e = self._entries[index]
        if e.action == Action.CREATED:
            del self._entries[index]  # created then deleted: net nothing
        else:
            e.action = Action.DELETED

    def entries(self) -> Iterator[tuple[bytes, STObject, Action]]:
        for idx, e in self._entries.items():
            yield idx, e.sle, e.action

    # -- trial execution (reference: duplicate/swapWith, used by
    # RippleCalc to attempt a path and discard it on failure) -------------

    def duplicate(self) -> "LedgerEntrySet":
        dup = LedgerEntrySet(self.ledger)
        for idx, e in self._entries.items():
            dup._entries[idx] = _Entry(
                e.sle.copy() if e.sle is not None else None, e.action, e.orig
            )
        return dup

    def swap_with(self, other: "LedgerEntrySet") -> None:
        self._entries, other._entries = other._entries, self._entries

    # -- commit -----------------------------------------------------------

    def apply(self) -> None:
        """Write the dirty entries into the ledger (reference:
        LedgerEntrySet::apply)."""
        for idx, e in self._entries.items():
            if e.action in (Action.CREATED, Action.MODIFIED):
                self.ledger.write_entry(idx, e.sle)
            elif e.action == Action.DELETED:
                self.ledger.delete_entry(idx)

    # -- metadata ---------------------------------------------------------

    def calc_meta(self, result: TER, tx_index: int,
                  ledger_seq: int, txid: bytes) -> STObject:
        """Build TransactionMetaData (reference: calcRawMeta,
        LedgerEntrySet.cpp:1030-1160 + TransactionMeta).

        Threading: modified/deleted threaded entries get their
        PreviousTxnID/PreviousTxnLgrSeq advanced to this transaction,
        with the old values recorded in PreviousFields.
        """
        affected = STArray()
        for idx in sorted(self._entries):
            e = self._entries[idx]
            if e.action == Action.CACHED:
                continue
            if e.action == Action.MODIFIED and e.orig is not None and e.sle == e.orig:
                continue
            node = STObject()
            sle = e.sle if e.sle is not None else e.orig
            node[sfLedgerEntryType] = sle[sfLedgerEntryType]
            node[sfLedgerIndex] = idx

            if e.action == Action.CREATED:
                fields = STObject()
                for f, v in e.sle.fields():
                    if f not in _META_SKIP:
                        fields[f] = v
                if len(fields):
                    node[sfNewFields] = fields
                affected.append(sfCreatedNode, node)
            elif e.action == Action.DELETED:
                # PreviousFields: original values that were changed before
                # the delete (reference calcRawMeta DeletedNode arm)
                prevs = STObject()
                if e.orig is not None:
                    for f, v in e.orig.fields():
                        if f in _META_SKIP:
                            continue
                        if e.sle is not None and e.sle.get(f) != v:
                            prevs[f] = v
                if len(prevs):
                    node[sfPreviousFields] = prevs
                finals = STObject()
                for f, v in e.sle.fields():
                    if f not in _META_SKIP:
                        finals[f] = v
                if len(finals):
                    node[sfFinalFields] = finals
                affected.append(sfDeletedNode, node)
            else:  # MODIFIED
                # thread: advance PreviousTxnID on threaded entries
                if sfPreviousTxnID in e.sle:
                    if e.sle[sfPreviousTxnID] != txid:
                        e.sle[sfPreviousTxnID] = txid
                        e.sle[sfPreviousTxnLgrSeq] = ledger_seq
                prevs = STObject()
                if e.orig is not None:
                    for f, v in e.orig.fields():
                        if f in _META_SKIP:
                            continue
                        if e.sle.get(f) != v:
                            prevs[f] = v
                finals = STObject()
                for f, v in e.sle.fields():
                    if f not in _META_SKIP:
                        finals[f] = v
                if len(prevs):
                    node[sfPreviousFields] = prevs
                if len(finals):
                    node[sfFinalFields] = finals
                affected.append(sfModifiedNode, node)

        meta = STObject()
        meta[sfTransactionIndex] = tx_index
        meta[sfAffectedNodes] = affected
        meta[sfTransactionResult] = int(result) & 0xFF
        return meta

    # -- directories ------------------------------------------------------
    # A directory is a chain of ltDIR_NODE pages rooted at `root_index`,
    # each holding up to DIR_NODE_MAX entry indexes in sfIndexes; root
    # carries IndexPrevious = last page (reference dirAdd/dirDelete).

    def dir_add(self, root_index: bytes, entry_index: bytes,
                describe: Optional[Callable[[STObject, bool], None]] = None,
                ) -> tuple[TER, int]:
        """Append `entry_index`; returns (TER, page number)
        (reference: dirAdd, LedgerEntrySet.cpp:690-770)."""
        root = self.peek(root_index)
        if root is None:
            root = self.create(LedgerEntryType.ltDIR_NODE, root_index)
            root[sfRootIndex] = root_index
            if describe:
                describe(root, True)
            root[sfIndexes] = [entry_index]
            return TER.tesSUCCESS, 0

        page = root.get(sfIndexPrevious, 0)
        node_index = indexes.dir_node_index(root_index, page)
        node = self.peek(node_index) if page else root
        if node is None:  # corrupt chain: root points at a missing page
            return TER.tefBAD_LEDGER, 0
        idxs = list(node.get(sfIndexes, []))
        if len(idxs) < DIR_NODE_MAX:
            idxs.append(entry_index)
            node[sfIndexes] = idxs
            self.modify(node_index)
            return TER.tesSUCCESS, page

        new_page = page + 1
        if new_page >= 1 << 64:
            return TER.tecDIR_FULL, 0
        node[sfIndexNext] = new_page
        self.modify(node_index)
        root[sfIndexPrevious] = new_page
        self.modify(root_index)
        new_node = self.create(
            LedgerEntryType.ltDIR_NODE, indexes.dir_node_index(root_index, new_page)
        )
        new_node[sfRootIndex] = root_index
        if describe:
            describe(new_node, False)
        new_node[sfIndexes] = [entry_index]
        if page:
            new_node[sfIndexPrevious] = page
        return TER.tesSUCCESS, new_page

    def dir_delete(self, root_index: bytes, page: int,
                   entry_index: bytes) -> TER:
        """Remove `entry_index` from its page; unlink/delete empty pages
        (reference: dirDelete, LedgerEntrySet.cpp:780-960 — simplified:
        empty non-root pages are deleted and the chain relinked; an empty
        root with no other pages is deleted)."""
        node_index = indexes.dir_node_index(root_index, page)
        node = self.peek(node_index)
        if node is None:
            return TER.tefBAD_LEDGER
        idxs = list(node.get(sfIndexes, []))
        if entry_index not in idxs:
            return TER.tefBAD_LEDGER
        idxs.remove(entry_index)
        node[sfIndexes] = idxs
        self.modify(node_index)
        if idxs:
            return TER.tesSUCCESS

        # page is now empty
        if page == 0:
            root = node
            if not root.get(sfIndexPrevious, 0) and not root.get(sfIndexNext, 0):
                self.erase(root_index)
            return TER.tesSUCCESS

        prev_page = node.get(sfIndexPrevious, 0)
        next_page = node.get(sfIndexNext, 0)
        root = self.peek(root_index)
        prev_index = indexes.dir_node_index(root_index, prev_page)
        prev_node = self.peek(prev_index) if prev_page else root
        if prev_node is not None:
            if next_page:
                prev_node[sfIndexNext] = next_page
            else:
                prev_node.pop(sfIndexNext)
            self.modify(prev_index if prev_page else root_index)
        if next_page:
            next_index = indexes.dir_node_index(root_index, next_page)
            next_node = self.peek(next_index)
            if next_node is not None:
                if prev_page:
                    next_node[sfIndexPrevious] = prev_page
                else:
                    next_node.pop(sfIndexPrevious)
                self.modify(next_index)
        if root is not None and root.get(sfIndexPrevious, 0) == page:
            if prev_page:
                root[sfIndexPrevious] = prev_page
            else:
                root.pop(sfIndexPrevious)
            self.modify(root_index)
        self.erase(node_index)
        if (
            root is not None
            and not root.get(sfIndexes, [])
            and not root.get(sfIndexPrevious, 0)
            and not root.get(sfIndexNext, 0)
        ):
            self.erase(root_index)
        return TER.tesSUCCESS

    def dir_entries(self, root_index: bytes) -> Iterator[bytes]:
        """All entry indexes across the page chain (reference:
        dirFirst/dirNext)."""
        page = 0
        while True:
            node = self.peek(indexes.dir_node_index(root_index, page))
            if node is None:
                return
            for idx in node.get(sfIndexes, []):
                yield idx
            page = node.get(sfIndexNext, 0)
            if not page:
                return

    # -- account helpers --------------------------------------------------

    def account_root(self, account_id: bytes) -> Optional[STObject]:
        return self.peek(indexes.account_root_index(account_id))

    def adjust_owner_count(self, account_id: bytes, delta: int) -> None:
        """reference: LedgerEntrySet::incrementOwnerCount/decrement"""
        idx = indexes.account_root_index(account_id)
        sle = self.peek(idx)
        if sle is None:
            return
        sle[sfOwnerCount] = max(0, sle.get(sfOwnerCount, 0) + delta)
        self.modify(idx)
