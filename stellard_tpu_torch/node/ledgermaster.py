"""LedgerMaster: the ledger-chain state machine.

Reference: src/ripple_app/ledger/LedgerMaster.cpp (1469 LoC) — tracks the
current open ledger, last closed ledger and last validated ledger
(LedgerHolder triples), holds transactions that can't apply yet
(terPRE_SEQ et al.) for retry on the next ledger, and accepts a ledger as
validated once a quorum of trusted validations arrives (checkAccept,
:705-750). Also CanonicalTXSet
(misc/CanonicalTXSet.cpp): the salted canonical application order used
when a closed ledger's tx set is applied.

This is the standalone node's close of the JAX package's
``node/ledgermaster.py``, its default path included:

- delta replay (``delta_replay``, on): each open-ledger accept also runs
  once in close mode against a speculative view, and the close splices
  the recorded deltas where their reads still validate
  (engine/deltareplay.py), running the full transactor only for the
  rest;
- the incremental seal (``incremental_seal``, on): speculated writes
  fold into a "building" state tree that a background drainer thread
  pre-hashes through the chain's hasher between closes, and the close
  adopts the pre-hashed root and hashes only the residual;
- the threaded seal (when ``persist_prep`` is set): the tx tree and the
  state tree hash on two helper threads while this thread builds the
  persist rows.

With ``delta_replay = False`` every closing transaction runs the full
transactor, and without ``persist_prep`` both trees are sealed in the
closing thread; the closed ledgers are byte-identical either way. Every
error a helper thread absorbs is counted in ``tree_stats``, and one that
came from the card is raised again by the next close. The node wires
its admission queue (``txq``, node/txq.py) in: held transactions are
absorbed into it and its queued ones promoted at each close. The
consensus paths (``close_with_txset``, ``switch_lcl``,
``set_validated``, ``check_accept``) serve a validator's rounds
(node/validator.py); with ``min_validations`` at 0, the standalone
default, every close is its own validation. With a ``spec_executor``
(engine/specexec.py, ``[spec] workers>1``) the open window's
speculation is dispatched to its Block-STM worker pool, and the close
drains the window before it splices.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..engine.engine import TransactionEngine, TxParams
from ..node.hashrouter import SF_SIGGOOD
from ..ops.build import is_device_error
from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from ..state.ledger import Ledger
from ..state.shamap import compute_hashes
from ..utils.taggedcache import TaggedCache
from .metrics import AtomicCounters, LatencyHist
from .tracer import STAGE_BOUNDS, get_tracer

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
        # optional loader for cache misses (Node wires the NodeStore in;
        # overlay validators are memory-resident and leave it unset)
        self.fetch_fallback: Optional[Callable[[bytes], Optional[Ledger]]] = None
        # optional LIGHT resolver: ledger hash -> (seq, parent_hash)
        # from the stored header alone (no tree loads) — used by the
        # LCL-switch reindex walk
        self.header_fetch: Optional[
            Callable[[bytes], Optional[tuple[int, bytes]]]
        ] = None
        # admission-control plane ([txq]): wired by Node; promotion of
        # queued txs into each new open ledger happens at _open_next
        self.txq = None
        self.min_validations = 0  # quorum for checkAccept
        # the validated-ledger hook (Node wires the read plane's
        # note_validated); standalone closes are their own validation
        self.on_validated: Optional[Callable[[Ledger], None]] = None
        # optional persist-row materializer (node.build_tx_rows): when
        # set, the close overlaps this Python tail with the seal
        # tree-hash, whose device batches release the GIL
        self.persist_prep: Optional[Callable[[Ledger, dict], list]] = None
        # speculative delta-replay close: the open-ledger accept also
        # runs the tx once in close mode against a SpecView, and the
        # close splices the recorded delta when the read set still
        # validates (engine/deltareplay.py)
        self.delta_replay = True
        # close-info counters in one AtomicCounters bundle (the close
        # path and readers on other threads share them)
        self.delta_stats = AtomicCounters(
            "closes", "spliced", "fallback", "invalidated",
        )
        # the last close's splice split and stage times (ms) and, per
        # tree, the seal's wall ms and the number of nodes it hashed
        self.last_close: dict = {}
        # parallel speculative executor ([spec] workers=N, engine/
        # specexec.py): when active, _speculate_open dispatches to the
        # worker pool instead of executing inline, and the close drains
        # the window before consuming the records. None/inactive keeps
        # the serial inline path byte-for-byte.
        self.spec_executor = None
        # incremental O(dirty) seal: speculated writes fold into a
        # pre-seal "building" tree on the SpecState, and a background
        # drainer hashes its dirty subtrees through the chain's hasher
        # between closes — the in-close seal then adopts the pre-hashed
        # root and hashes only the residual (engine/deltareplay.py
        # maybe_adopt_prehashed). The full serial seal remains the
        # per-close fallback, never forked.
        self.incremental_seal = True
        self.seal_drain_batch = 256  # writes folded before a drain fires
        # batched-commit counters, and every error a helper absorbed:
        # the drainer's and the seal threads' hashing, the persist rows,
        # the building-tree fold, the speculation and the adoption
        self.tree_stats = {
            "drains": 0, "drained_nodes": 0, "seal_adopted": 0,
            "seal_rejected": 0, "seal_residual_keys": 0,
            "bulk_merges": 0, "bulk_merged_keys": 0,
            "drain_errors": 0, "seal_thread_errors": 0,
            "persist_prep_errors": 0, "fold_errors": 0,
            "spec_errors": 0, "adopt_errors": 0,
        }
        # the first error from the card a helper thread absorbed, raised
        # again by the next close (_raise_device_error)
        self._device_error: Optional[BaseException] = None
        self._drain_hist = LatencyHist(bounds=STAGE_BOUNDS, interpolate=True)
        self._drain_cv = threading.Condition()
        self._drain_pending = 0
        self._drain_kick = False
        self._drain_busy = False
        self._drainer: Optional[threading.Thread] = None
        self._drain_stop = False
        # per-close stage latency histograms (ms): apply pass, seal
        # overlap, total
        self.close_stage_hist: dict[str, LatencyHist] = {
            "apply": LatencyHist(bounds=STAGE_BOUNDS, interpolate=True),
            "seal": LatencyHist(bounds=STAGE_BOUNDS, interpolate=True),
            "total": LatencyHist(bounds=STAGE_BOUNDS, interpolate=True),
        }

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
            led = self.ledgers_by_hash.get(h)
            if led is None and self.fetch_fallback is not None:
                led = self.fetch_fallback(h)
                if led is not None:
                    self.ledgers_by_hash.put(h, led)
            return led

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

    def _open_apply(self, tx: SerializedTransaction, params: TxParams,
                    speculate: bool = True) -> tuple[TER, bool]:
        """Apply to the open ledger; on accept, seed the parsed-tx memo
        and run the speculative close-mode execution. Caller holds the
        lock. ``speculate=False`` skips the close-mode dry run."""
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
            # speculate only for OPEN-mode accepts: the open window
            # never mutates ledger state, which is the invariant that
            # makes the SpecView's parent reads equal to the state the
            # close will start from
            if speculate and (int(params) & int(TxParams.OPEN_LEDGER)):
                self._speculate_open(open_ledger, tx)
        return ter, applied

    def _speculate_open(self, open_ledger: Ledger,
                        tx: SerializedTransaction,
                        origin: str = "submit") -> None:
        """Close-mode dry run of an open-accepted tx against the open
        window's speculative overlay (engine/deltareplay.py), creating
        the SpecState on first use: dispatched to the parallel
        executor's pool when it is active, else inline on this thread.
        ``origin`` tags the record so the queue's promotion counters can
        tell spliced-promoted txs apart from submit-time speculation."""
        if not self.delta_replay:
            return
        spec = getattr(open_ledger, "_spec_state", None)
        if spec is None:
            from ..engine.deltareplay import SpecState

            spec = open_ledger._spec_state = SpecState(open_ledger)
            if self.incremental_seal:
                # the open window never mutates the state map, so its
                # root IS the parent state the close starts from — the
                # building tree folds speculated writes onto it and
                # pre-hashes between closes, through the chain's hasher
                spec.attach_building(
                    open_ledger.state_map.root, self.hash_batch
                )
        if tx.txid() in spec.records:
            return
        ex = self.spec_executor
        if ex is not None and ex.active:
            # parallel plane: dispatch to the worker pool (O(1) under
            # the chain lock — the execution itself runs on workers and
            # commits in index order off this thread). Folding into the
            # building tree rides the commit step via _note_fold.
            session = getattr(spec, "_exec_session", None)
            if session is None and ex.can_accept:
                session = spec._exec_session = ex.begin_window(
                    spec, open_ledger, on_fold=self._note_fold,
                )
            if session is not None:
                if ex.dispatch(session, tx, origin):
                    return
                # executor refused (stopping / pool dead): seal the
                # window so no late commit races the serial path, then
                # fall through
                ex.end_window(session, timeout=ex.drain_timeout_s)
                spec._exec_session = None
        with self.tracer.span("open.speculate", "apply",
                              txid=tx.txid(), origin=origin):
            spec.speculate(tx, origin=origin)
        rec = spec.records.get(tx.txid())
        if rec is not None and spec.building is not None:
            folded = spec.fold_building(rec)
            if folded:
                self._note_fold(folded)

    # -- incremental-seal background drain --------------------------------

    def _absorb(self, counter: str, exc: BaseException) -> None:
        """Count an error a helper absorbed; keep the first one that came
        from the card for the next close to raise."""
        with self._drain_cv:
            self.tree_stats[counter] += 1
            if self._device_error is None and is_device_error(exc):
                self._device_error = exc

    def _raise_device_error(self) -> None:
        with self._drain_cv:
            exc, self._device_error = self._device_error, None
        if exc is not None:
            raise exc

    def _ensure_drainer_locked(self) -> None:
        """Lazily start the seal-drain thread; caller holds _drain_cv."""
        if self._drainer is None and not self._drain_stop:
            self._drainer = threading.Thread(
                target=self._drain_loop, name="seal-drain",
                daemon=True,
            )
            self._drainer.start()

    def _note_fold(self, n_ops: int) -> None:
        """Count folded writes; past the drain batch, wake the drainer to
        pre-hash the building tree's dirty subtrees off this thread.
        drain_batch < 1 disables background drains entirely (folding and
        root adoption still run; the seal just hashes at close time)."""
        if self.seal_drain_batch < 1:
            return
        with self._drain_cv:
            self._drain_pending += n_ops
            if self._drain_pending >= self.seal_drain_batch:
                self._ensure_drainer_locked()
                self._drain_cv.notify()

    def kick_seal_drain(self, wait_s: float = 0.0) -> None:
        """Flush the sub-batch fold residual to the background pre-hash
        thread NOW. With ``wait_s``, block up to that long for the
        drainer to go idle so a caller about to close sees the pre-hash
        actually finished — still outside any lock, and bounded."""
        if self.seal_drain_batch < 1:
            return
        with self._drain_cv:
            if self._drain_pending > 0:
                self._ensure_drainer_locked()
                self._drain_kick = True
                self._drain_cv.notify()
            if wait_s > 0:
                deadline = time.perf_counter() + wait_s
                while (self._drain_pending > 0 or self._drain_kick
                       or self._drain_busy) and not self._drain_stop:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._drain_cv.wait(min(remaining, 0.05))

    def _drain_loop(self) -> None:
        while True:
            with self._drain_cv:
                # max(1, batch): a runtime knob change to <1 must idle
                # the thread (pending only grows via _note_fold, which
                # gates on the same knob), never spin it
                while (self._drain_pending < max(1, self.seal_drain_batch)
                       and not self._drain_kick
                       and not self._drain_stop):
                    self._drain_cv.wait(timeout=1.0)
                if self._drain_stop:
                    return
                self._drain_pending = 0
                self._drain_kick = False
                self._drain_busy = True
            # snapshot the building tree UNDER the chain lock, hash it
            # OUTSIDE: the tree is persistent, so hashing a snapshot
            # root only fills write-once _hash slots on nodes the
            # foreground shares — concurrent folds build new paths and
            # never touch fields this walk writes
            with self._lock:
                cur = self.current
                spec = getattr(cur, "_spec_state", None) if cur else None
                building = spec.building if spec is not None else None
                root = building.root if building is not None else None
                hasher = building.hash_batch if building is not None else None
            if root is None:
                with self._drain_cv:
                    self._drain_busy = False
                    self._drain_cv.notify_all()
                continue
            t0 = time.perf_counter()
            try:
                tree_fn = getattr(hasher, "hash_tree", None)
                if tree_fn is not None and getattr(hasher, "fused_enabled", True):
                    n = tree_fn(root)
                else:
                    n = compute_hashes(root, hasher)
            except Exception as exc:  # noqa: BLE001 — pre-hashing is advisory;
                # the close's full seal recomputes whatever is missing
                self._absorb("drain_errors", exc)
                with self._drain_cv:
                    self._drain_busy = False
                    self._drain_cv.notify_all()
                continue
            t1 = time.perf_counter()
            with self._drain_cv:
                self.tree_stats["drains"] += 1
                self.tree_stats["drained_nodes"] += n
                self._drain_busy = False
                self._drain_cv.notify_all()
            self._drain_hist.record((t1 - t0) * 1000.0)
            self.tracer.complete("seal.incremental", "seal", t0, t1,
                                 nodes=n)

    def stop_seal_drainer(self) -> None:
        """Stop the background pre-hash thread. Idempotent; a stopped
        LedgerMaster never restarts it."""
        with self._drain_cv:
            self._drain_stop = True
            self._drain_cv.notify_all()
        t = self._drainer
        if t is not None:
            t.join(timeout=5)

    def tree_json(self) -> dict:
        """Batched-commit-plane counters (and the absorbed errors)."""
        with self._drain_cv:
            out = dict(self.tree_stats)
        out["incremental_seal"] = self.incremental_seal
        out["drain_batch"] = self.seal_drain_batch
        if self._drain_hist.count:
            out["drain_p50_ms"] = self._drain_hist.quantile(0.5)
            out["drain_p90_ms"] = self._drain_hist.quantile(0.9)
        return out

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

    def _seal_tree(self, name: str, m) -> None:
        """Hash one tree through its map's batch hasher (a CudaHasher
        seals it with one readback) and record its wall ms and the
        number of nodes it hashed in ``last_close``."""
        t0 = time.perf_counter()
        n = compute_hashes(m.root, m.hash_batch)
        self.last_close[f"seal_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        self.last_close[f"seal_{name}_nodes"] = n

    def _seal(self, new_lcl: Ledger, results: dict[bytes, TER]) -> None:
        """Seal tail of the close: compute the two tree hashes.

        With ``persist_prep`` set, the tx map and the state map each hash
        on their OWN helper thread (the two trees are disjoint, and the
        hasher is safe with several trees in flight) while THIS thread
        builds the persist rows. The SHAMap is persistent: hashing only
        fills node._hash slots, and the row walk reads item
        data/children, so the traversals never write the same fields. A
        hashing failure on a helper thread is counted and absorbed —
        _push_closed recomputes serially — unless it came from the card,
        which this close raises. Without ``persist_prep`` both trees
        are hashed here, the transaction map first.

        Emits the transfer-honesty spans: ``close.device.fused`` (the
        hash window) and ``close.device.transfer`` (the per-close deltas
        of the hasher's transfer meters — the device-residency proof)."""
        trees = (("tx", new_lcl.tx_map), ("state", new_lcl.state_map))
        if self.persist_prep is None:
            for name, m in trees:
                self._seal_tree(name, m)
            return
        t0 = time.perf_counter()
        tj = getattr(self.hash_batch, "transfer_json", None)
        before = tj() if tj is not None else None

        def run(name, m):
            try:
                self._seal_tree(name, m)
            except Exception as exc:  # noqa: BLE001 — recomputed on push
                self._absorb("seal_thread_errors", exc)

        threads = [
            threading.Thread(target=run, args=(name, m), name=f"seal-hash-{name}")
            for name, m in trees
        ]
        for t in threads:
            t.start()
        try:
            new_lcl.persist_rows = self.persist_prep(new_lcl, results)
        except Exception as exc:  # noqa: BLE001 — the persist stage rebuilds rows
            self._absorb("persist_prep_errors", exc)
        finally:
            for t in threads:
                t.join()
        t1 = time.perf_counter()
        self._raise_device_error()
        self.tracer.complete(
            "close.device.fused", "seal", t0, t1,
            fused=bool(getattr(self.hash_batch, "fused_enabled", True)),
            seq=new_lcl.seq,
        )
        if before is not None:
            after = tj()
            self.tracer.complete(
                "close.device.transfer", "seal", t0, t1,
                seq=new_lcl.seq,
                uploads=after["uploads"] - before["uploads"],
                readbacks=after["readbacks"] - before["readbacks"],
                transfers=after["transfers"] - before["transfers"],
                bytes_moved=after["bytes_moved"] - before["bytes_moved"],
            )

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
           (applyTransactions, LedgerConsensus.cpp:1935-2070), splicing
           speculative deltas where the open pass's records validate,
        3. seal it, open the next ledger, re-apply held txns.

        Returns (new closed ledger, per-txid results). Raises first an
        error from the card that a helper thread absorbed since the last
        close.
        """
        with self._lock:
            self._raise_device_error()
            t0 = time.perf_counter()
            prev = self.closed_ledger()
            open_ledger = self.current_ledger()

            # 1. canonical set from the open ledger's recorded blobs;
            # SF_SIGGOOD verdicts memoized at submit time carry over to
            # the freshly-parsed copies
            txset = CanonicalTXSet(prev.hash())
            for txid, blob, _meta in open_ledger.tx_entries():
                txset.insert(self._parse_with_verdict(open_ledger, txid, blob))
            for tx in extra_txs or []:
                txset.insert(tx)

            # 2. successor of the LCL; apply with retry passes, splicing
            # speculative deltas where the open pass's records validate
            new_lcl = prev.open_successor()
            spec = (
                getattr(open_ledger, "_spec_state", None)
                if self.delta_replay else None
            )
            self._drain_spec(spec)
            results = self._apply_transactions(new_lcl, txset, spec=spec)
            t_apply = time.perf_counter()

            # 3. seal + advance
            new_lcl.close(close_time, close_resolution, correct_close_time)
            new_lcl.accepted = True
            # seed the parsed-tx memo so persist/publish reuse these
            # exact objects instead of re-parsing every blob
            for tx in txset.values():
                new_lcl.parsed_txs[tx.txid()] = tx
            self._seal(new_lcl, results)
            t_seal = time.perf_counter()
            self._push_closed(new_lcl)
            self._open_next(new_lcl, (t_apply - t0) * 1000.0)

            # standalone trusts its own closes (reference: standalone mode
            # skips validations; checkAccept quorum handles the net case)
            if self.min_validations == 0:
                self.validated = new_lcl
                if self.on_validated:
                    self.on_validated(new_lcl)

            self._note_close_stages(t0, t_apply, t_seal, new_lcl.seq)
            return new_lcl, results

    def close_with_txset(
        self,
        txs: list[SerializedTransaction],
        close_time: int,
        close_resolution: int,
        correct_close_time: bool = True,
    ) -> tuple[Ledger, dict[bytes, TER]]:
        """Consensus-accept path (reference: LedgerConsensus::accept,
        :931-1127): close the chain with the *agreed* tx set — which may
        differ from our open ledger's — then re-apply to the new open
        ledger anything we had locally that didn't make the consensus set
        (reference: reapply of local/disputed txns :1050-1127). Raises
        first an error from the card that a helper thread absorbed since
        the last close."""
        with self._lock:
            self._raise_device_error()
            t0 = time.perf_counter()
            prev = self.closed_ledger()
            open_ledger = self.current_ledger()

            txset = CanonicalTXSet(prev.hash())
            for tx in txs:
                txset.insert(tx)

            new_lcl = prev.open_successor()
            spec = (
                getattr(open_ledger, "_spec_state", None)
                if self.delta_replay else None
            )
            self._drain_spec(spec)
            results = self._apply_transactions(new_lcl, txset, spec=spec)
            t_apply = time.perf_counter()

            new_lcl.close(close_time, close_resolution, correct_close_time)
            new_lcl.accepted = True
            for tx in txset.values():
                new_lcl.parsed_txs[tx.txid()] = tx
            self._seal(new_lcl, results)
            t_seal = time.perf_counter()
            self._push_closed(new_lcl)

            # re-apply: our open-ledger txns that missed consensus first
            # (they are the lower sequences), then held/queued;
            # SF_SIGGOOD verdicts from submit time carry over so the
            # re-apply never host-re-verifies. In canonical order, each
            # account's by sequence (reference: the retriable
            # CanonicalTXSet of LedgerConsensus::accept); the JAX package
            # takes the tx map's order, where a cut burst of one
            # account's sequences meets terPRE_SEQ and is held, ten an
            # account once the TxQ absorbs it (ROADMAP Queue C)
            consensus_ids = {tx.txid() for tx in txs}
            leftovers = CanonicalTXSet(new_lcl.hash())
            for txid, blob, _meta in open_ledger.tx_entries():
                if txid not in consensus_ids:
                    leftovers.insert(
                        self._parse_with_verdict(open_ledger, txid, blob))
            self._open_next(new_lcl, (t_apply - t0) * 1000.0,
                            leftovers=[tx for _k, tx in leftovers.items_sorted()])
            self._note_close_stages(t0, t_apply, t_seal, new_lcl.seq)
            return new_lcl, results

    def _open_next(self, new_lcl: Ledger, apply_ms: float,
                   leftovers: list = ()) -> None:
        """Open the successor ledger and replenish it: consensus
        leftovers first, then the held pile or the admission queue. With
        the TxQ enabled this is the promotion site — held terPRE_SEQ txs
        are absorbed into the fee-ordered queue and the best-paying
        eligible queued txs fill the new open ledger up to the soft cap,
        sized from ``apply_ms`` (this close's apply pass); without it (no
        TxQ, or [txq] enabled=0) the held pile is re-applied as it is.
        Caller holds the lock."""
        self.current = new_lcl.open_successor()
        for tx in leftovers:
            ter, _applied = self._open_apply(
                tx, TxParams.OPEN_LEDGER | TxParams.RETRY
            )
            if ter == TER.terPRE_SEQ:
                self._hold_or_queue(tx)
        txq = self.txq
        if txq is not None and txq.enabled:
            for tx, expire in self._drain_held():
                txq.absorb_held(tx, self, expire)
            txq.after_close(self, new_lcl, apply_ms)
        else:
            for tx, expire in self._drain_held():
                ter, _applied = self._open_apply(
                    tx, TxParams.OPEN_LEDGER | TxParams.RETRY
                )
                if ter == TER.terPRE_SEQ:
                    self._hold(tx, expire)

    def _drain_spec(self, spec) -> None:
        """Seal the open window's parallel-speculation session before
        the close consumes its records: every dispatched task commits
        (in-flight work finishes through the pool; a wedged pool's
        remainder is executed serially in index order on this thread).
        No-op on the serial path. Caller holds the chain lock; the
        commit machinery never takes it, so waiting here cannot
        deadlock."""
        ex = self.spec_executor
        session = getattr(spec, "_exec_session", None) if spec else None
        if ex is None or session is None:
            return
        t0 = time.perf_counter()
        ex.end_window(session)
        spec._exec_session = None
        self.tracer.complete("spec.drain", "close", t0,
                             time.perf_counter(),
                             dispatched=len(session.tasks))

    def _hold_or_queue(self, tx: SerializedTransaction) -> None:
        """terPRE_SEQ disposition: the fee-ordered queue when the TxQ is
        enabled, the (bounded) held pile otherwise."""
        if self.txq is not None and self.txq.enabled:
            self.txq.absorb_held(tx, self)
        else:
            self.add_held_transaction(tx)

    def switch_lcl(self, ledger: Ledger) -> None:
        """Adopt a different (acquired) last-closed ledger — the network
        moved on without us (reference: switchLastClosedLedger,
        NetworkOPs.cpp:930). Our open-ledger txns are NOT carried over;
        anything still valid will be re-relayed by peers."""
        with self._lock:
            ledger.accepted = True
            self._push_closed(ledger)
            self.current = ledger.open_successor()
            self._reindex_chain(ledger)

    def _reindex_chain(self, ledger: Ledger) -> None:
        """Repoint the seq->hash index at the adopted chain's ancestry.
        Closes we made ourselves before the switch are ORPHANS: leaving
        them indexed would make get_ledger_by_seq (and the `ledger` RPC)
        serve a ledger the network never validated at that index — the
        mismatch the reference's LedgerHistory::handleMismatch repairs.
        Repoints every resolvable ancestor; index entries between the
        last VALIDATED seq and the deepest confirmed ancestor that
        cannot be confirmed are DROPPED — after a switch they are
        orphan-branch closes, and serving nothing (the caller falls
        back to stored history, whose own divergence is LedgerCleaner
        repair territory) beats serving a ledger the network never
        validated. The tip itself was just indexed by _push_closed; the
        walk starts at its parent. Ancestry resolves from the in-memory
        cache or the LIGHT header fetch (seq + parent only) — never a
        full two-tree Ledger.load under the master lock — and stops at
        the validated floor, which no switch may rewrite."""
        floor = self.validated.seq if self.validated is not None else 0
        resolve = self._resolve_header
        cur_hash = ledger.parent_hash
        confirmed_down_to = ledger.seq
        while True:
            info = resolve(cur_hash)
            if info is None:
                break
            seq, parent_hash = info
            if seq <= floor:
                break  # never rewrite the validated chain's entries
            if self.ledger_history.get(seq) == cur_hash:
                confirmed_down_to = seq
                break
            self.ledger_history[seq] = cur_hash
            confirmed_down_to = seq
            cur_hash = parent_hash
        # one pass: (a) unconfirmable entries between the floor and the
        # deepest confirmed ancestor are orphan-branch closes; (b)
        # entries ABOVE the adopted tip are our own solo closes on an
        # abandoned fork (backward adoption repairs a runaway node) —
        # the network validated neither
        for seq in [
            s for s in self.ledger_history
            if floor < s < confirmed_down_to or s > ledger.seq
        ]:
            del self.ledger_history[seq]
        while len(self.ledger_history) > 8192:
            del self.ledger_history[min(self.ledger_history)]

    def _resolve_header(self, h: bytes) -> Optional[tuple[int, bytes]]:
        """(seq, parent_hash) for a ledger hash, from the in-memory
        cache or the LIGHT header fetch — never a full two-tree load
        under the master lock."""
        led = self.ledgers_by_hash.get(h)
        if led is not None:
            return led.seq, led.parent_hash
        if self.header_fetch is not None:
            return self.header_fetch(h)
        return None

    def set_validated(self, ledger: Ledger) -> None:
        """A quorum of trusted validations arrived for this ledger
        (reference: LedgerMaster::checkAccept tail, :705-750)."""
        with self._lock:
            if self.validated is not None and ledger.seq <= self.validated.seq:
                return
            prev_floor = (
                self.validated.seq if self.validated is not None else 0
            )
            self.validated = ledger
            # a quorum-validated ledger is the strongest possible signal
            # for its index slot: repair any orphan entry left by a fork
            # healed without an LCL switch (LedgerHistory mismatch role)
            self.ledger_history[ledger.seq] = ledger.hash()
            self.ledgers_by_hash.put(ledger.hash(), ledger)
            # and for every slot it SKIPPED: when validation jumps a
            # seq range (contested rounds, a revived node), the new
            # tip's ancestry is authoritative for the gap — without
            # this, a node that closed an orphan inside the gap served
            # that orphan from its history forever (scenario-fuzzer
            # find: honest histories permanently disagreed at a seq
            # below the validated floor)
            # bounded: never walk (or grow the index) past the 8192
            # history bound — a cold node whose first validation lands
            # at a high seq must not do seq-many header reads under
            # the master lock
            prev_floor = max(prev_floor, ledger.seq - 256)
            cur_hash = ledger.parent_hash
            seq = ledger.seq - 1
            while seq > prev_floor:
                self.ledger_history[seq] = cur_hash
                info = self._resolve_header(cur_hash)
                if info is None:
                    # deeper ancestry unresolvable from memory/headers:
                    # any remaining gap entries are unconfirmable —
                    # probably this node's own orphan-branch closes from
                    # before the jump. Same policy as the switch_lcl
                    # repair: serving NOTHING beats serving a hash the
                    # network never validated (re-resolvable later via
                    # stored history / LedgerCleaner).
                    for s in range(prev_floor + 1, seq):
                        self.ledger_history.pop(s, None)
                    break
                _seq, cur_hash = info
                seq -= 1
            while len(self.ledger_history) > 8192:
                del self.ledger_history[min(self.ledger_history)]
        if self.on_validated:
            self.on_validated(ledger)

    def check_accept(self, ledger_hash: bytes, trusted_count: int) -> bool:
        """Quorum test for a closed ledger we know about (reference:
        checkAccept) — promotes it to validated when `trusted_count`
        meets `min_validations`."""
        if trusted_count < max(self.min_validations, 1):
            return False
        ledger = self.get_ledger_by_hash(ledger_hash)
        if ledger is None:
            return False
        self.set_validated(ledger)
        return True

    def _apply_transactions(
        self, ledger: Ledger, txset: CanonicalTXSet, spec=None
    ) -> dict[bytes, TER]:
        """reference: LedgerConsensus::applyTransactions — passes over the
        canonical set, retrying ter* failures (which may succeed once an
        earlier tx lands), claiming fees on tec*.

        With a SpecState from the open pass, each tx first consults the
        delta-replay context: a record whose read set validates against
        the close's writer map is spliced (recorded delta + meta, no
        transactor run); everything else runs the full serial apply and
        poisons its written keys (engine/deltareplay.py)."""
        results: dict[bytes, TER] = {}
        engine = TransactionEngine(ledger)
        tracer = self.tracer
        replay = None
        if spec is not None and self.delta_replay:
            from ..engine.deltareplay import CloseReplay

            replay = CloseReplay(spec, ledger, tracer=tracer)

        def apply_one(tx, final: bool):
            if replay is not None:
                hit = replay.try_splice(engine, tx, final)
                if hit is not None:
                    return hit
                # the serial transactor reads the real trees: queued
                # spliced writes must land first
                replay.flush_pending()
            ter, did_apply = engine.apply_transaction(
                tx, TxParams.NONE if final else TxParams.RETRY
            )
            if replay is not None:
                replay.note_fallback(tx, engine, did_apply)
            elif tracer.enabled and tracer.sampled(tx.txid()):
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
        if replay is not None:
            replay.flush_pending()
            if self.incremental_seal:
                # adopt the pre-hashed building root where it matches the
                # close's final write set — the seal then hashes only the
                # residual (full seal stays the automatic fallback)
                replay.maybe_adopt_prehashed()
            self._note_delta_stats(replay)
        return results

    # -- delta-replay / close-stage observability -------------------------

    def _note_delta_stats(self, replay) -> None:
        c = replay.counts()
        if self.txq is not None and self.txq.enabled:
            # queue-aware speculation honesty: which of the txs the
            # queue promoted into this window spliced vs fell back
            self.txq.note_close_classes(replay.classes())
        # one atomic multi-key bump: concurrent readers never see a torn
        # closes/spliced pair
        self.delta_stats.add_many(
            closes=1, spliced=c["spliced"], fallback=c["fallback"],
            invalidated=c["invalidated"],
        )
        spec = replay.spec
        with self._drain_cv:
            self.tree_stats["bulk_merges"] += c.get("bulk_merges", 0)
            self.tree_stats["bulk_merged_keys"] += c.get(
                "bulk_merged_keys", 0
            )
            if spec is not None:
                self.tree_stats["spec_errors"] += spec.spec_errors
                self.tree_stats["fold_errors"] += spec.fold_errors
            adopt = c.get("seal_adopt")
            if adopt == "adopted":
                self.tree_stats["seal_adopted"] += 1
                self.tree_stats["seal_residual_keys"] += c.get(
                    "seal_residual", 0
                )
            elif adopt in ("rejected", "error"):
                self.tree_stats["seal_rejected"] += 1
            if adopt == "error":
                self.tree_stats["adopt_errors"] += 1
        self.last_close.update(c)

    def _note_close_stages(self, t0: float, t_apply: float,
                           t_seal: float, seq: int) -> None:
        now = time.perf_counter()
        stages = {
            "apply_ms": round((t_apply - t0) * 1000.0, 3),
            "seal_ms": round((t_seal - t_apply) * 1000.0, 3),
            "total_ms": round((now - t0) * 1000.0, 3),
        }
        self.close_stage_hist["apply"].record(stages["apply_ms"])
        self.close_stage_hist["seal"].record(stages["seal_ms"])
        self.close_stage_hist["total"].record(stages["total_ms"])
        self.last_close.update(stages)
        tr = self.tracer
        tr.complete("close.apply", "close", t0, t_apply, seq=seq)
        tr.complete("close.seal", "close", t_apply, t_seal, seq=seq)
        tr.complete("close.total", "close", t0, now, seq=seq)

    def delta_replay_json(self) -> dict:
        """spliced/fallback/invalidation counters + close-stage latency
        percentiles. Snapshots under the chain lock: readers on other
        threads call this while the close thread records stages."""
        with self._lock:
            out = {
                "enabled": self.delta_replay,
                **self.delta_stats.snapshot(),
                "last_close": dict(self.last_close),
            }
            if self.close_stage_hist["total"].count:
                for stage, hist in self.close_stage_hist.items():
                    out[f"{stage}_p50_ms"] = hist.quantile(0.5)
                    out[f"{stage}_p90_ms"] = hist.quantile(0.9)
        if self.spec_executor is not None:
            out["spec"] = self.spec_executor.get_json()
        return out
