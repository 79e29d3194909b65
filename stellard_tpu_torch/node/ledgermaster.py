"""LedgerMaster: the ledger-chain state machine, serial close path.

Reference: src/ripple_app/ledger/LedgerMaster.cpp (1469 LoC) — tracks the
current open ledger, last closed ledger and last validated ledger
(LedgerHolder triples), holds transactions that can't apply yet
(terPRE_SEQ et al.) for retry on the next ledger. Also CanonicalTXSet
(misc/CanonicalTXSet.cpp): the salted canonical application order used
when a closed ledger's tx set is applied.

This is the standalone node's serial close of the JAX package's
``node/ledgermaster.py``: every closing transaction runs the full
transactor, and both trees are sealed in the closing thread. The
delta-replay close, the admission queue (txq) and the consensus paths
(``close_with_txset``, ``switch_lcl``, ``check_accept``) are not part of
this package yet; the closed ledgers are byte-identical either way.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..engine.engine import TransactionEngine, TxParams
from ..node.hashrouter import SF_SIGGOOD
from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from ..state.ledger import Ledger
from ..state.shamap import compute_hashes
from ..utils.taggedcache import TaggedCache
from .tracer import get_tracer

__all__ = ["LedgerMaster", "CanonicalTXSet", "LEDGER_TOTAL_PASSES"]

# reference: applyTransactions retry sizing (LedgerConsensus.cpp:1935-2070)
LEDGER_TOTAL_PASSES = 4

# held-pile bounds (reference: mHeldTransactions is unbounded — a
# single-account sequence-gap flood pinned memory forever): entries
# expire after this many closes, and the pile itself is capped with
# FIFO eviction
HELD_EXPIRE_LEDGERS = 16
HELD_CAP = 1024


class CanonicalTXSet:
    """Salted canonical ordering (reference: misc/CanonicalTXSet.{h,cpp}):
    sort key = (account XOR salt, sequence, txid); the salt is the parent
    ledger hash so the order is unpredictable to submitters but identical
    on every node."""

    def __init__(self, salt: bytes):
        self.salt = salt
        self._map: dict[tuple, SerializedTransaction] = {}

    def insert(self, tx: SerializedTransaction) -> None:
        acct = int.from_bytes(tx.account, "big")
        salt = int.from_bytes(self.salt[:20], "big")
        self._map[(acct ^ salt, tx.sequence, tx.txid())] = tx

    def erase(self, key: tuple) -> None:
        self._map.pop(key, None)

    def values(self):
        return self._map.values()

    def __len__(self):
        return len(self._map)

    def items_sorted(self) -> list[tuple[tuple, SerializedTransaction]]:
        return sorted(self._map.items())


class LedgerMaster:
    """Holds the chain: validated ←closed ←current(open)."""

    def __init__(
        self, hash_batch: Optional[Callable] = None, router=None,
        tracer=None,
    ):
        self._lock = threading.RLock()
        self.hash_batch = hash_batch
        self.tracer = tracer if tracer is not None else get_tracer()
        # HashRouter: close-time re-application consults SF_SIGGOOD so
        # txs verified at submit are not host-re-verified per close
        # (reference: LedgerConsensus::applyTransaction skips checkSign
        # via SF_SIGGOOD, LedgerConsensus.cpp:2101-2106)
        self.router = router
        self.current: Optional[Ledger] = None  # open
        self.closed: Optional[Ledger] = None  # last closed (LCL)
        self.validated: Optional[Ledger] = None
        self.ledger_history: dict[int, bytes] = {}  # seq -> hash
        # closed-ledger cache: bounded + aged so a long-running node's
        # memory does not grow with chain length (reference: LedgerHistory
        # TaggedCache, tuned at Application.cpp:723-727)
        self.ledgers_by_hash: TaggedCache = TaggedCache(
            "ledger_history", target_size=512, expiration_s=600.0
        )
        # txns held for a future ledger (reference: mHeldTransactions)
        # value is (tx, expire_seq): bounded + expired by ledger seq so
        # a sequence-gap flood cannot pin memory forever
        self.held: dict[tuple[bytes, int], tuple[SerializedTransaction, int]] = {}
        self.held_stats = {"evicted": 0, "expired": 0}
        # the last close's stage times (ms) and, per tree, the seal's
        # wall ms and the number of nodes it hashed
        self.last_close: dict = {}

    # -- bootstrap --------------------------------------------------------

    def start_new_ledger(self, root_account_id: bytes, close_time: int = 0) -> None:
        """Fresh genesis chain (reference: Application::startNewLedger —
        builds the seq-1 genesis, closes it, opens seq 2 on top)."""
        with self._lock:
            genesis = Ledger.genesis(root_account_id, close_time=close_time,
                                     hash_batch=self.hash_batch)
            genesis.close(close_time, genesis.close_resolution)
            genesis.accepted = True
            self._push_closed(genesis)
            self.validated = genesis
            self.current = genesis.open_successor()

    def load_ledger(self, ledger: Ledger) -> None:
        """Resume from a stored closed ledger (reference: loadOldLedger)."""
        with self._lock:
            ledger.accepted = True
            self._push_closed(ledger)
            self.validated = ledger
            self.current = ledger.open_successor()

    def _push_closed(self, ledger: Ledger) -> None:
        self.closed = ledger
        h = ledger.hash()
        floor = self.validated.seq if self.validated is not None else 0
        if ledger.seq > floor or self.ledger_history.get(ledger.seq) is None:
            self.ledger_history[ledger.seq] = h
        if len(self.ledger_history) > 8192:
            # bound the seq index too; full history stays in txdb/nodestore
            del self.ledger_history[min(self.ledger_history)]
        self.ledgers_by_hash.put(h, ledger)

    # -- accessors --------------------------------------------------------

    def current_ledger(self) -> Ledger:
        with self._lock:
            assert self.current is not None, "LedgerMaster not started"
            return self.current

    def closed_ledger(self) -> Ledger:
        with self._lock:
            assert self.closed is not None, "LedgerMaster not started"
            return self.closed

    def get_ledger_by_seq(self, seq: int) -> Optional[Ledger]:
        with self._lock:
            h = self.ledger_history.get(seq)
            return self.ledgers_by_hash.get(h) if h else None

    def get_ledger_by_hash(self, h: bytes) -> Optional[Ledger]:
        with self._lock:
            return self.ledgers_by_hash.get(h)

    # -- held transactions (reference: addHeldTransaction) ----------------

    def add_held_transaction(self, tx: SerializedTransaction) -> None:
        with self._lock:
            now = self.closed.seq if self.closed is not None else 0
            self._hold(tx, now + HELD_EXPIRE_LEDGERS)

    def _hold(self, tx: SerializedTransaction, expire_seq: int) -> None:
        """Insert with the pile's cap: a full pile evicts its OLDEST
        entry (insertion order) rather than growing without bound."""
        key = (tx.account, tx.sequence)
        if key in self.held:
            # re-hold after a retry keeps the ORIGINAL horizon — a
            # never-applicable tx must not refresh itself forever
            expire_seq = min(expire_seq, self.held[key][1])
        elif len(self.held) >= HELD_CAP:
            self.held.pop(next(iter(self.held)))
            self.held_stats["evicted"] += 1
        self.held[key] = (tx, expire_seq)

    def _drain_held(self) -> list[tuple[SerializedTransaction, int]]:
        """Take every live (tx, expire_seq) pair, dropping expired
        entries. Caller holds the lock."""
        now = self.closed.seq if self.closed is not None else 0
        entries = list(self.held.values())
        self.held.clear()
        live = []
        for tx, expire in entries:
            if expire < now:
                self.held_stats["expired"] += 1
            else:
                live.append((tx, expire))
        return live

    def take_held_transactions(self) -> list[SerializedTransaction]:
        with self._lock:
            return [tx for tx, _expire in self._drain_held()]

    # -- apply to the open ledger (reference: doTransaction) --------------

    def do_transaction(self, tx: SerializedTransaction, params: TxParams) -> tuple[TER, bool]:
        with self._lock:
            return self._open_apply(tx, params)

    def _open_apply(self, tx: SerializedTransaction,
                    params: TxParams) -> tuple[TER, bool]:
        """Apply to the open ledger; on accept, seed the parsed-tx memo.
        Caller holds the lock."""
        open_ledger = self.current_ledger()
        engine = TransactionEngine(open_ledger)
        with self.tracer.span("open.apply", "apply", txid=tx.txid(),
                              ledger_seq=open_ledger.seq):
            ter, applied = engine.apply_transaction(tx, params)
        if applied:
            # seed the OPEN ledger's parsed-tx memo so the close path
            # reuses this exact object instead of re-parsing the blob
            # (txid is the blob's content hash); callers must never
            # mutate a submitted tx
            open_ledger.parsed_txs[tx.txid()] = tx
        return ter, applied

    # -- close ------------------------------------------------------------

    def _parse_with_verdict(self, open_ledger: Ledger, txid: bytes, blob: bytes):
        """Parse an open-ledger blob — or reuse the submit-time parsed
        object from the ledger's own memo (txid is content-addressed,
        so a hit is byte-equal) — carrying over the submit-time
        SF_SIGGOOD verdict so close/re-apply never host-re-verifies
        (reference: LedgerConsensus::applyTransaction skips checkSign
        via SF_SIGGOOD, LedgerConsensus.cpp:2101-2106)."""
        tx = open_ledger.parse_tx(txid, blob)
        if self.router is not None and (
            self.router.get_flags(txid) & SF_SIGGOOD
        ):
            tx.set_sig_verdict(True)
        return tx

    def _seal(self, new_lcl: Ledger) -> None:
        """Hash both trees of the closed ledger in this thread, the
        transaction map first, through each map's batch hasher (a
        ``CudaHasher`` seals each tree with one readback). Records each
        tree's wall ms and hashed-node count in ``last_close``."""
        for name, m in (("tx", new_lcl.tx_map), ("state", new_lcl.state_map)):
            t0 = time.perf_counter()
            n = compute_hashes(m.root, m.hash_batch)
            self.last_close[f"seal_{name}_ms"] = (time.perf_counter() - t0) * 1e3
            self.last_close[f"seal_{name}_nodes"] = n

    def close_and_advance(
        self,
        close_time: int,
        close_resolution: int,
        correct_close_time: bool = True,
        extra_txs: Optional[list[SerializedTransaction]] = None,
    ) -> tuple[Ledger, dict[bytes, TER]]:
        """Build the next closed ledger from the open ledger's tx set and
        advance the chain (reference: the standalone `ledger_accept`
        path, NetworkOPs::acceptLedger, and the tail of
        LedgerConsensus::accept :931-1127):

        1. collect the open ledger's txns (+ any extras) into a
           CanonicalTXSet salted by the parent hash,
        2. re-apply them to a successor of the LCL with retry passes
           (applyTransactions, LedgerConsensus.cpp:1935-2070),
        3. seal it, open the next ledger, re-apply held txns.

        Returns (new closed ledger, per-txid results).
        """
        with self._lock:
            t0 = time.perf_counter()
            prev = self.closed_ledger()
            open_ledger = self.current_ledger()

            txset = CanonicalTXSet(prev.hash())
            for txid, blob, _meta in open_ledger.tx_entries():
                txset.insert(self._parse_with_verdict(open_ledger, txid, blob))
            for tx in extra_txs or []:
                txset.insert(tx)

            new_lcl = prev.open_successor()
            results = self._apply_transactions(new_lcl, txset)
            t_apply = time.perf_counter()

            new_lcl.close(close_time, close_resolution, correct_close_time)
            new_lcl.accepted = True
            # seed the parsed-tx memo so later readers reuse these
            # exact objects instead of re-parsing every blob
            for tx in txset.values():
                new_lcl.parsed_txs[tx.txid()] = tx
            self._seal(new_lcl)
            t_seal = time.perf_counter()
            self._push_closed(new_lcl)
            self._open_next(new_lcl)

            # standalone trusts its own closes (reference: standalone mode
            # skips validations)
            self.validated = new_lcl

            self._note_close_stages(t0, t_apply, t_seal, new_lcl.seq)
            return new_lcl, results

    def _open_next(self, new_lcl: Ledger) -> None:
        """Open the successor ledger and re-apply the held pile to it.
        Caller holds the lock."""
        self.current = new_lcl.open_successor()
        for tx, expire in self._drain_held():
            ter, _applied = self._open_apply(
                tx, TxParams.OPEN_LEDGER | TxParams.RETRY
            )
            if ter == TER.terPRE_SEQ:
                self._hold(tx, expire)

    def _apply_transactions(
        self, ledger: Ledger, txset: CanonicalTXSet
    ) -> dict[bytes, TER]:
        """reference: LedgerConsensus::applyTransactions — passes over the
        canonical set, retrying ter* failures (which may succeed once an
        earlier tx lands), claiming fees on tec*."""
        results: dict[bytes, TER] = {}
        engine = TransactionEngine(ledger)
        tracer = self.tracer

        def apply_one(tx, final: bool):
            ter, did_apply = engine.apply_transaction(
                tx, TxParams.NONE if final else TxParams.RETRY
            )
            if tracer.enabled and tracer.sampled(tx.txid()):
                tracer.instant("close.tx", "close", txid=tx.txid(),
                               mode="serial", ledger_seq=ledger.seq,
                               ter=int(ter))
            return ter, did_apply

        remaining = txset.items_sorted()
        for pass_no in range(LEDGER_TOTAL_PASSES):
            final_pass = pass_no == LEDGER_TOTAL_PASSES - 1
            retry: list = []
            changes = 0
            for key, tx in remaining:
                ter, did_apply = apply_one(tx, final_pass)
                results[tx.txid()] = ter
                if did_apply or ter == TER.tesSUCCESS:
                    changes += 1
                elif -99 <= int(ter) < 0 and not final_pass:  # ter* retry band
                    retry.append((key, tx))
                elif 100 <= int(ter) < 200 and not did_apply and not final_pass:
                    retry.append((key, tx))  # tec w/o fee claim under RETRY
            remaining = retry
            if not remaining or changes == 0:
                # no progress → another pass can't help (final pass already
                # recorded non-retry results)
                if remaining and not final_pass:
                    for _key, tx in remaining:
                        ter, _ = apply_one(tx, True)
                        results[tx.txid()] = ter
                break
        return results

    # -- close-stage observability ----------------------------------------

    def _note_close_stages(self, t0: float, t_apply: float,
                           t_seal: float, seq: int) -> None:
        now = time.perf_counter()
        stages = {
            "apply_ms": round((t_apply - t0) * 1000.0, 3),
            "seal_ms": round((t_seal - t_apply) * 1000.0, 3),
            "total_ms": round((now - t0) * 1000.0, 3),
        }
        self.last_close.update(stages)
        tr = self.tracer
        tr.complete("close.apply", "close", t0, t_apply, seq=seq)
        tr.complete("close.seal", "close", t_apply, t_seal, seq=seq)
        tr.complete("close.total", "close", t0, now, seq=seq)
