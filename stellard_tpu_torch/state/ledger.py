"""Ledger: one version of the replicated state.

Header + two SHAMaps (transaction map, account-state map), hash-compatible
with the reference (src/ripple_app/ledger/Ledger.cpp):

- header serialization: Ledger::addRaw (Ledger.cpp:1182-1196) — seq,
  totCoins, feePool, inflationSeq, parentHash, txHash, accountHash,
  parentCloseTime, closeTime, closeResolution, closeFlags,
- ledger hash = SHA512half(HP_LEDGER_MASTER || header),
- genesis: root account funded with SYSTEM_CURRENCY_START = 10^17 stroops
  (Config.h:37-40), seq 1 (Ledger.cpp:29-66).

Closing a ledger is functional: `close()` snapshots into an immutable
closed ledger and the caller opens a successor with `open_successor()` —
the persistent SHAMap makes both O(1). ``save`` persists both trees and
the header into a NodeStore; ``load`` rebuilds a ledger from one,
eagerly or as lazy trees that fault their nodes on first touch.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..nodestore.core import Database, NodeObjectType
from ..protocol.serializer import Serializer
from ..protocol.sfields import (
    sfBalance,
    sfSequence,
)
from ..protocol.stobject import STObject
from ..utils.hashes import HP_LEDGER_MASTER, HP_TXN_ID, prefix_hash
from . import indexes
from .shamap import SHAMap, SHAMapItem, TNType

__all__ = [
    "Ledger",
    "SYSTEM_CURRENCY_START",
    "LEDGER_TIME_ACCURACY",
    "parse_header",
]


def strip_ledger_prefix(body: bytes) -> bytes:
    """Drop the HP_LEDGER_MASTER domain prefix when present — stored
    ledger-header blobs carry it (save() below), wire headers do not."""
    if len(body) >= 4 and int.from_bytes(body[:4], "big") == HP_LEDGER_MASTER:
        return body[4:]
    return body


def parse_header(blob: bytes) -> dict:
    """Decode Ledger::addRaw header bytes — the single reader for the
    layout header_bytes() writes (reference: Ledger.cpp:1182-1196)."""
    from ..protocol.serializer import BinaryParser

    p = BinaryParser(blob)
    return {
        "seq": p.read32(),
        "tot_coins": p.read64(),
        "fee_pool": p.read64(),
        "inflation_seq": p.read32(),
        "parent_hash": p.read(32),
        "tx_hash": p.read(32),
        "account_hash": p.read(32),
        "parent_close_time": p.read32(),
        "close_time": p.read32(),
        "close_resolution": p.read8(),
        "close_flags": p.read8(),
    }

# reference: Config.h:37-40
SYSTEM_CURRENCY_START = 1000 * 100_000_000 * 1_000_000
# reference: LedgerTiming.h:47
LEDGER_TIME_ACCURACY = 30

# default fee schedule (reference: Config.cpp:30-34,127-139)
DEFAULT_BASE_FEE = 10
DEFAULT_REFERENCE_FEE_UNITS = 10
DEFAULT_RESERVE_BASE = 200 * 1_000_000
DEFAULT_RESERVE_INCREMENT = 50 * 1_000_000


class Ledger:
    def __init__(
        self,
        seq: int,
        parent_hash: bytes = b"\x00" * 32,
        tot_coins: int = SYSTEM_CURRENCY_START,
        fee_pool: int = 0,
        inflation_seq: int = 1,
        close_time: int = 0,
        parent_close_time: int = 0,
        close_resolution: int = LEDGER_TIME_ACCURACY,
        close_flags: int = 0,
        tx_map: Optional[SHAMap] = None,
        state_map: Optional[SHAMap] = None,
        hash_batch: Optional[Callable] = None,
    ):
        self.seq = seq
        self.parent_hash = parent_hash
        self.tot_coins = tot_coins
        self.fee_pool = fee_pool
        self.inflation_seq = inflation_seq
        self.close_time = close_time
        self.parent_close_time = parent_close_time
        self.close_resolution = close_resolution
        self.close_flags = close_flags
        kw = {"hash_batch": hash_batch} if hash_batch else {}
        # `is None`, not `or`: an empty SHAMap is falsy (len 0), and the
        # empty tx map open_successor hands over carries the hasher
        self.tx_map = tx_map if tx_map is not None else SHAMap(TNType.TX_MD, **kw)
        self.state_map = (state_map if state_map is not None
                          else SHAMap(TNType.ACCOUNT_STATE, **kw))
        self.closed = False
        self.accepted = False
        self.validated = False
        # per-account highest open-ledger tx sequence (O(1) seq prediction
        # for Transactor::checkSeq; maintained by the engine via
        # note_open_tx)
        self.open_tx_seqs: dict[bytes, int] = {}
        # fee schedule (reference: Ledger::updateFees)
        self.base_fee = DEFAULT_BASE_FEE
        self.reference_fee_units = DEFAULT_REFERENCE_FEE_UNITS
        self.reserve_base = DEFAULT_RESERVE_BASE
        self.reserve_increment = DEFAULT_RESERVE_INCREMENT
        self.load_factor = 256  # 256 = no load escalation (LoadFeeTrack)
        # txid -> parsed SerializedTransaction memo: the close path
        # parses each tx once and persist/publish reuse the object
        # instead of re-parsing the blob per consumer (the reference
        # passes SerializedTransaction::pointer around for the same
        # reason). Seeded by close_and_advance; consulted via parse_tx.
        self.parsed_txs: dict[bytes, object] = {}
        # txid -> parsed meta STObject, seeded by the engine as it
        # builds each meta so persist/publish never re-parse meta blobs
        self.parsed_metas: dict[bytes, object] = {}

    # -- genesis ----------------------------------------------------------

    @classmethod
    def genesis(cls, root_account_id: bytes,
                start_amount: int = SYSTEM_CURRENCY_START,
                close_time: int = 0,
                hash_batch: Optional[Callable] = None) -> "Ledger":
        """First ledger: all coins in the root account
        (reference: Ledger.cpp:29-66, Application.cpp startNewLedger)."""
        led = cls(seq=1, tot_coins=start_amount, close_time=close_time,
                  hash_batch=hash_batch)
        sle = STObject()
        from ..protocol.sfields import sfAccount, sfLedgerEntryType
        from ..protocol.formats import LedgerEntryType
        from ..protocol.stamount import STAmount

        sle[sfLedgerEntryType] = int(LedgerEntryType.ltACCOUNT_ROOT)
        sle[sfAccount] = root_account_id
        sle[sfBalance] = STAmount.from_drops(start_amount)
        sle[sfSequence] = 1
        from ..protocol.sfields import sfFlags, sfOwnerCount, sfPreviousTxnID, sfPreviousTxnLgrSeq

        sle[sfFlags] = 0
        sle[sfOwnerCount] = 0
        sle[sfPreviousTxnID] = b"\x00" * 32
        sle[sfPreviousTxnLgrSeq] = 0
        led.write_entry(indexes.account_root_index(root_account_id), sle)
        return led

    # -- header / hashing -------------------------------------------------

    def header_bytes(self) -> bytes:
        """reference: Ledger::addRaw (Ledger.cpp:1182-1196)"""
        s = Serializer()
        s.add32(self.seq)
        s.add64(self.tot_coins)
        s.add64(self.fee_pool)
        s.add32(self.inflation_seq)
        s.add_raw(self.parent_hash)
        s.add_raw(self.tx_map.get_hash())
        s.add_raw(self.state_map.get_hash())
        s.add32(self.parent_close_time)
        s.add32(self.close_time)
        s.add8(self.close_resolution)
        s.add8(self.close_flags)
        return s.data()

    def hash(self) -> bytes:
        return prefix_hash(HP_LEDGER_MASTER, self.header_bytes())

    @property
    def tx_hash(self) -> bytes:
        return self.tx_map.get_hash()

    @property
    def account_hash(self) -> bytes:
        return self.state_map.get_hash()

    # -- state entries (SLEs) --------------------------------------------

    def read_entry_pristine(self, index: bytes) -> Optional[STObject]:
        """Shared parsed entry (the reference's SLE cache role): one
        parse per immutable SHAMapItem, shared across ledger versions
        that alias the item. Callers MUST NOT mutate the result."""
        item = self.state_map.get(index)
        if item is None:
            return None
        if item.parsed is None:
            item.parsed = STObject.from_bytes(item.data)
        return item.parsed

    def read_entry(self, index: bytes) -> Optional[STObject]:
        sle = self.read_entry_pristine(index)
        return None if sle is None else sle.copy()

    def write_entry(self, index: bytes, sle: STObject) -> None:
        # Pin the just-written object as the item's parsed mirror: both
        # call sites (LedgerEntrySet.apply after calc_meta's threading
        # mutations, and the genesis writer) are done mutating `sle`,
        # and the mirror equals the item bytes by construction
        # (data IS sle.serialize()). Hot accounts are re-read by the
        # very next transaction, which otherwise re-parses every
        # written entry (~2 parses/tx on the payment workloads).
        item = SHAMapItem(index, sle.serialize())
        item.parsed = sle
        self.state_map.set_item(item)

    def delete_entry(self, index: bytes) -> None:
        self.state_map.del_item(index)

    def account_root(self, account_id: bytes) -> Optional[STObject]:
        return self.read_entry(indexes.account_root_index(account_id))

    # -- fees / reserves --------------------------------------------------

    def reserve(self, owner_count: int) -> int:
        """reference: Ledger::getReserve (Ledger.h:446-451)"""
        return self.reserve_base + owner_count * self.reserve_increment

    def scale_fee_base(self, fee: int) -> int:
        """reference: Ledger::scaleFeeBase — fee units → drops. With the
        default schedule (base_fee == reference_fee_units scaling) this is
        identity; kept as the seam for fee voting."""
        return fee

    def scale_fee_load(self, fee: int, admin: bool = False) -> int:
        """reference: Ledger::scaleFeeLoad via LoadFeeTrack — the load
        multiplier hooks in here (node runtime, stage 5); admin traffic is
        never load-scaled."""
        if admin:
            return fee
        return fee * self.load_factor // 256 if self.load_factor > 256 else fee

    # -- transactions -----------------------------------------------------

    def add_open_transaction(self, tx_blob: bytes) -> tuple[bytes, bool]:
        """Record a tx (no metadata) in an OPEN ledger's tx map
        (reference: Ledger::addTransaction(txID, s) — item data is the raw
        blob, node type tnTRANSACTION_NM). Returns (txid, added) — added is
        False if already present (tefALREADY race)."""
        txid = prefix_hash(HP_TXN_ID, tx_blob)
        if self.tx_map.get(txid) is not None:
            return txid, False
        self.tx_map.set_item(SHAMapItem(txid, tx_blob), TNType.TX_NM)
        return txid, True

    def note_open_tx(self, account: bytes, sequence: int) -> None:
        """Record an accepted open-ledger tx for O(1) sequence prediction."""
        cur = self.open_tx_seqs.get(account)
        if cur is None or sequence > cur:
            self.open_tx_seqs[account] = sequence

    @staticmethod
    def tx_item_data(tx_blob: bytes, metadata: bytes) -> bytes:
        """The TX_MD item payload: VL(tx) ‖ VL(metadata) — the ONE place
        that writes this layout (tx_entries/get_transaction read it).
        Shared by add_transaction and the delta-replay splice's batched
        tx-map inserts."""
        s = Serializer()
        s.add_vl(tx_blob)
        s.add_vl(metadata)
        return s.data()

    def add_transaction(self, tx_blob: bytes, metadata: bytes) -> bytes:
        """Insert a tx + its metadata into the tx map (reference:
        Ledger::addTransaction w/ metadata — item data is
        VL(tx) || VL(metadata), tag is the tx ID)."""
        txid = prefix_hash(HP_TXN_ID, tx_blob)
        self.tx_map.set_item(
            SHAMapItem(txid, self.tx_item_data(tx_blob, metadata)),
            TNType.TX_MD,
        )
        return txid

    def record_transaction(self, tx_blob: bytes, meta) -> bytes:
        """Close-path insert of a tx + its PARSED meta: serializes the
        meta into the tx map and memoizes the object for persist/publish
        (the speculative view overrides this to skip a serialization its
        scratch map would discard)."""
        txid = self.add_transaction(tx_blob, meta.serialize())
        self.parsed_metas[txid] = meta
        return txid

    def tx_entries(self):
        """Yield (txid, tx_blob, meta_blob) for every tx in this ledger —
        the one place that knows the TX_MD item layout VL(tx) || VL(meta)
        (open-ledger TX_NM items yield meta b\"\")."""
        from ..protocol.serializer import BinaryParser

        for leaf in self.tx_map.leaves():
            blob, meta = leaf.item.data, b""
            if leaf.type == TNType.TX_MD:
                p = BinaryParser(blob)
                blob, meta = p.read_vl(), p.read_vl()
            yield leaf.item.tag, blob, meta

    def parse_tx(self, txid: bytes, blob: bytes):
        """Parsed-transaction memo over tx_entries blobs."""
        tx = self.parsed_txs.get(txid)
        if tx is None:
            from ..protocol.sttx import SerializedTransaction

            tx = SerializedTransaction.from_bytes(blob)
            self.parsed_txs[txid] = tx
        return tx

    def get_transaction(self, txid: bytes) -> Optional[tuple[bytes, bytes]]:
        """-> (tx_blob, metadata) or None. Open-ledger items (raw blob, no
        metadata) return (blob, b"")."""
        leaf = self.tx_map.get_leaf(txid)
        if leaf is None:
            return None
        if leaf.type == TNType.TX_NM:
            return leaf.item.data, b""
        from ..protocol.serializer import BinaryParser

        p = BinaryParser(leaf.item.data)
        return p.read_vl(), p.read_vl()

    # -- lifecycle --------------------------------------------------------

    @staticmethod
    def round_close_time(close_time: int, close_resolution: int) -> int:
        """Round to the NEAREST resolution step
        (reference: Ledger::roundCloseTime, Ledger.cpp:1966-1973)."""
        if close_time == 0:
            return 0
        close_time += close_resolution // 2
        return close_time - (close_time % close_resolution)

    def close(self, close_time: int, close_resolution: int,
              correct_close_time: bool = True) -> None:
        """Seal this ledger (reference: Ledger::setAccepted,
        Ledger.cpp:330-340 — rounds the close time to the ledger's
        resolution unless consensus did not agree on a close time, in
        which case sLCF_NoConsensusTime is flagged)."""
        if correct_close_time:
            self.close_time = self.round_close_time(close_time, close_resolution)
        else:
            self.close_time = close_time
        self.close_resolution = close_resolution
        self.close_flags = 0 if correct_close_time else 1
        self.closed = True

    def open_successor(self) -> "Ledger":
        """Open ledger on top of this closed one (reference:
        Ledger::Ledger(bool, Ledger&) — shares the state map snapshot,
        fresh tx map)."""
        child = Ledger(
            seq=self.seq + 1,
            parent_hash=self.hash(),
            tot_coins=self.tot_coins,
            fee_pool=self.fee_pool,
            inflation_seq=self.inflation_seq,
            parent_close_time=self.close_time,
            close_resolution=self.close_resolution,
            tx_map=SHAMap(TNType.TX_MD, hash_batch=self.tx_map.hash_batch),
            state_map=self.state_map.snapshot(),
        )
        child.base_fee = self.base_fee
        child.reference_fee_units = self.reference_fee_units
        child.reserve_base = self.reserve_base
        child.reserve_increment = self.reserve_increment
        child.load_factor = self.load_factor
        return child

    def snapshot(self) -> "Ledger":
        """O(1) copy (both maps persistent)."""
        led = Ledger(
            seq=self.seq,
            parent_hash=self.parent_hash,
            tot_coins=self.tot_coins,
            fee_pool=self.fee_pool,
            inflation_seq=self.inflation_seq,
            close_time=self.close_time,
            parent_close_time=self.parent_close_time,
            close_resolution=self.close_resolution,
            close_flags=self.close_flags,
            tx_map=self.tx_map.snapshot(),
            state_map=self.state_map.snapshot(),
        )
        led.closed = self.closed
        led.accepted = self.accepted
        led.validated = self.validated
        led.open_tx_seqs = dict(self.open_tx_seqs)
        led.base_fee = self.base_fee
        led.reference_fee_units = self.reference_fee_units
        led.reserve_base = self.reserve_base
        led.reserve_increment = self.reserve_increment
        led.load_factor = self.load_factor
        return led

    # -- persistence ------------------------------------------------------

    def save(self, db: Database) -> bytes:
        """Persist both trees + the header into the NodeStore (reference:
        consensus flushDirty + Ledger::pendSaveValidated; header stored as
        hotLEDGER under the ledger hash). Uses the store's `flushed` set so
        repeated saves only write the delta; node blobs come off the
        shared flat-buffer encoding and are handed through the packed
        door AS-IS — (hashes, buf, offsets), blob == hashed bytes — so
        a log-structured backend lands the whole delta as one segment
        append (other backends decode once inside the façade)."""
        self.state_map.flush(
            db.store_fn(NodeObjectType.ACCOUNT_NODE), db.flushed,
            store_packed=db.store_packed_fn(NodeObjectType.ACCOUNT_NODE),
        )
        self.tx_map.flush(
            db.store_fn(NodeObjectType.TRANSACTION_NODE), db.flushed,
            store_packed=db.store_packed_fn(NodeObjectType.TRANSACTION_NODE),
        )
        h = self.hash()
        # the header rides the same SYNCHRONOUS door as the trees: a
        # header blob parked in the async write-behind queue when a
        # caller commits its own records after save() returns would be
        # lost by a crash — leaving a ledger whose root never resolves
        blob = HP_LEDGER_MASTER.to_bytes(4, "big") + self.header_bytes()
        db.store_packed(NodeObjectType.LEDGER, [h], blob, [0, len(blob)])
        return h

    @classmethod
    def load(cls, db: Database, ledger_hash: bytes,
             hash_batch: Optional[Callable] = None,
             lazy: bool = False, cold: bool = False) -> "Ledger":
        """Rebuild a ledger (header + both trees) from the NodeStore —
        the checkpoint/resume path (reference: Application loadOldLedger,
        Ledger::Ledger(blob) Ledger.cpp:120-175). Every node is fetched
        and content-checked now (SHAMap.from_store), and the rebuilt
        header must hash to `ledger_hash`.

        With `lazy` (the out-of-core plane) only the header and the two
        tree ROOTS are read now; every other node is a hash-only stub
        that faults from this store through the bounded hot-node cache
        on first touch (`cold`: one epoch behind, for a history read).
        Opening a million-account ledger is O(1); the eager path's
        whole-tree hash re-verification is traded for per-node content
        verification at fault time (the same check, paid lazily)."""
        obj = db.fetch(ledger_hash)
        if obj is None:
            raise KeyError(f"missing ledger {ledger_hash.hex()}")
        f = parse_header(strip_ledger_prefix(obj.data))

        fetched: set[bytes] = set()

        def fetch(h: bytes) -> Optional[bytes]:
            o = db.fetch(h)
            if o is not None:
                fetched.add(h)
            return o.data if o else None

        kw: dict = {"hash_batch": hash_batch} if hash_batch else {}
        if lazy:
            def fetch(h: bytes) -> Optional[bytes]:  # noqa: F811
                o = db.fetch(h)
                return o.data if o else None

            # store_known=db.flushed marks the trees as backed by THIS
            # store: flushing them (or descendants sharing their
            # subtrees) back into it never faults clean cold branches
            kw.update(lazy=True, store_known=db.flushed, cold=cold)
        led = cls(
            seq=f["seq"],
            parent_hash=f["parent_hash"],
            tot_coins=f["tot_coins"],
            fee_pool=f["fee_pool"],
            inflation_seq=f["inflation_seq"],
            close_time=f["close_time"],
            parent_close_time=f["parent_close_time"],
            close_resolution=f["close_resolution"],
            close_flags=f["close_flags"],
            tx_map=SHAMap.from_store(f["tx_hash"], fetch, TNType.TX_MD, **kw),
            state_map=SHAMap.from_store(f["account_hash"], fetch,
                                        TNType.ACCOUNT_STATE, **kw),
        )
        led.closed = True
        if led.hash() != ledger_hash:
            raise ValueError(
                f"ledger hash mismatch after load: want {ledger_hash.hex()} "
                f"got {led.hash().hex()}"
            )
        if not lazy:
            # only after the full tree verified do the fetched nodes
            # count as known-good in this store (a corrupt node must
            # stay rewritable); the lazy path never claims this — each
            # node verifies at fault time instead
            db.flushed.update(fetched)
        return led
