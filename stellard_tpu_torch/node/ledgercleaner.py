"""LedgerCleaner: background integrity checker over stored ledgers, and
OnlineDeleter: rippled-style storage rotation.

LedgerCleaner role parity with the reference's
src/ripple_app/ledger/LedgerCleaner.cpp (448 LoC): walk
a range of persisted ledgers, verify each loads from the NodeStore with
its recorded hash (Ledger.load recomputes and compares), verify
parent-hash chain linkage against the header index, and count / report
what is broken so the operator (or the acquisition plane) can repair.
Driven by the `ledger_cleaner` admin RPC like the reference.

OnlineDeleter fills production rippled's ``SHAMapStore`` online_delete
role (``src/ripple/app/misc/SHAMapStoreImp.cpp``): retain the last N
validated ledgers, mark every node reachable from their roots, sweep
the rest out of the store, and let the segstore compactor reclaim the
dead segments — a validator's disk stays bounded near the live set
under an arbitrarily long flood. Where rippled rotates whole backend
instances (copy live into the writable store, archive the old one),
the segmented backend deletes in place: same policy, no double-write
of the live set. The sweep's apply step runs ON the close pipeline's
drain worker (ClosePipeline.submit_task) so no NodeStore flush can be
mid-flight when entries are removed — the flush known-set race
(a flush skipping a node the sweep is about to delete) is closed by
ordering, and the segstore's own in-sweep guards (dedup off +
recent-key protection) cover every writer that isn't the drain worker.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

__all__ = ["LedgerCleaner", "OnlineDeleter"]


class LedgerCleaner:
    def __init__(self, node):
        self.node = node
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.state = "idle"
        self.checked = 0
        self.failed: list[dict] = []
        self.range: tuple[int, int] = (0, 0)
        self.repairs_requested = 0
        self.repaired = 0
        self.repairs_failed = 0

    def start(self, min_seq: Optional[int] = None,
              max_seq: Optional[int] = None) -> dict:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return {"status": "already_running", **self.get_json()}
            seqs = self.node.txdb.ledger_seqs()
            if not seqs:
                return {"status": "no_ledgers"}
            lo = min_seq if min_seq is not None else seqs[0]
            hi = max_seq if max_seq is not None else seqs[-1]
            self.range = (lo, hi)
            self.state = "running"
            self.checked = 0
            self.failed = []
            self.repairs_requested = 0
            self.repaired = 0
            self.repairs_failed = 0
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="ledger-cleaner", daemon=True
            )
            self._thread.start()
        return {"status": "started", "min_ledger": lo, "max_ledger": hi}

    def _run(self) -> None:
        from ..state.ledger import Ledger

        lo, hi = self.range
        prev_hash: Optional[bytes] = None
        for seq in range(hi, lo - 1, -1):  # newest-first like the reference
            if self._stop.is_set():
                with self._lock:
                    self.state = "stopped"
                return
            hdr = self.node.txdb.get_ledger_header(seq=seq)
            if hdr is None:
                self.failed.append({"seq": seq, "problem": "missing header"})
                # walking newest-first, the ledger above already told us
                # this ledger's hash (its parent_hash) — acquirable
                if prev_hash is not None:
                    self._request_repair(seq, prev_hash)
                prev_hash = None  # linkage unknown across the gap
                continue
            try:
                led = Ledger.load(
                    self.node.nodestore, hdr["hash"],
                    hash_batch=self.node.hasher,
                )
            except (KeyError, ValueError) as e:
                self.failed.append({"seq": seq, "problem": f"load: {e}"})
                self._request_repair(seq, hdr["hash"])
                prev_hash = None
                self.checked += 1
                continue
            if prev_hash is not None and prev_hash != hdr["hash"]:
                self.failed.append({"seq": seq, "problem": "chain break"})
            prev_hash = led.parent_hash
            self.checked += 1
        with self._lock:
            self.state = "done"

    # outstanding-repair cap per scan: a large corrupted range must not
    # open thousands of live acquisition sessions at once
    MAX_INFLIGHT_REPAIRS = 32

    def _request_repair(self, seq: int, ledger_hash: bytes) -> None:
        """Ask the acquisition plane to re-fetch a broken/missing stored
        ledger from peers and re-persist it (reference: LedgerCleaner's
        acquire path). No-op without an overlay; capped in flight (the
        stale-acquisition expiry reclaims unserveable requests)."""
        overlay = getattr(self.node, "overlay", None)
        if overlay is None:
            return
        with self._lock:
            in_flight = (
                self.repairs_requested - self.repaired - self.repairs_failed
            )
            if in_flight >= self.MAX_INFLIGHT_REPAIRS:
                return
            self.repairs_requested += 1
        vn = overlay.node

        def on_persisted():
            with self._lock:
                self.repaired += 1

        def on_persist_failed():
            # release the in-flight slot on a failed disk write, or the
            # cleaner's 32-slot repair budget leaks one slot per failure
            with self._lock:
                self.repairs_failed += 1

        def persist(led):
            # led is None when the acquisition expired or failed to
            # build — release the in-flight slot so later repairs in the
            # scan are not starved by unserveable requests
            if led is None:
                on_persist_failed()
                return
            # fires on the overlay message thread UNDER the master lock —
            # hand the disk work to the close pipeline's ordered drain
            # (concurrent TxDatabase batches are not safe, and disk time
            # must not stall consensus); a "repair" entry persists data
            # only, never the CLF resume pointer. Inline fallback for
            # embedders that stubbed the pipeline out.
            pipeline = getattr(self.node, "close_pipeline", None)
            if pipeline is not None:
                pipeline.submit_repair(
                    led,
                    done=lambda _results: on_persisted(),
                    on_failed=on_persist_failed,
                )
                return
            from .node import _results_from_meta

            try:
                self.node.persist_ledger_data(led, _results_from_meta(led))
                on_persisted()
            except Exception:  # noqa: BLE001 — log, keep the cleaner alive
                logging.getLogger("stellard.cleaner").exception(
                    "repair persist failed for seq %d", seq
                )
                on_persist_failed()

        with vn.lock:
            vn.inbound.acquire(ledger_hash, callback=persist)

    def stop(self) -> dict:
        """Abort a running scan (reference: the handler's stop verb)."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        return self.get_json()

    def get_json(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "min_ledger": self.range[0],
                "max_ledger": self.range[1],
                "checked": self.checked,
                "failures": list(self.failed[:16]),
                "failure_count": len(self.failed),
                "repairs_requested": self.repairs_requested,
                "repaired": self.repaired,
                "repairs_failed": self.repairs_failed,
            }


class OnlineDeleter:
    """Rotation-driven online deletion (see module docstring).

    Lifecycle per sweep:

    1. ``on_validated(seq)`` — called from the drain worker after each
       CLF commit — starts a background mark thread every ``interval``
       validated ledgers;
    2. the mark thread arms the store's sweep guards
       (``Database.begin_sweep``) and walks every node reachable from
       the retained ledgers' roots ([seq-retain+1, seq]): header blob,
       state tree, tx tree — shared subtrees walk once via the live
       set itself;
    3. the apply step is submitted to the close pipeline
       (``submit_task``): ON the drain worker it catch-up-marks any
       ledger persisted since the mark started (their headers are in
       txdb by drain order), then ``Database.apply_sweep`` removes
       everything else, purges the façade's cache/known-set, and the
       segstore compactor + checkpoint make the deletion durable and
       reclaim the bytes.
    """

    def __init__(self, node, retain: int, interval: int = 0,
                 sql_trim: bool = True, shardstore=None):
        self.node = node
        # history tiering ([node_db] shards=): the retired range is
        # sealed into an offline-verifiable shard BEFORE the sweep
        # deletes it and before trim_below drops its SQL rows — with a
        # shard store configured, rotation tiers history to cold
        # storage instead of discarding it (doc/storage.md)
        self.shardstore = shardstore
        self.retain = max(1, int(retain))
        self.interval = int(interval) if interval > 0 else max(
            1, self.retain // 2
        )
        # also trim the txdb SQL mirror (tx rows, account index, ledger
        # headers, validations) below the same horizon, on the same
        # drain worker — nodestore-only rotation leaves SQLite growing
        # without bound ([node_db] sql_trim=0 opts out)
        self.sql_trim = bool(sql_trim)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_sweep_seq = 0
        # one sweep generation at a time: the backend's sweep guards
        # (_recent_keys / dedup-off) are single-generation state, so a
        # new begin_sweep must not fire while a previous generation's
        # apply task is still queued on the drain worker
        self._apply_pending = False
        # counters (node_store observability block)
        self.sweeps_started = 0
        self.sweeps_completed = 0
        self.nodes_removed = 0
        self.last_marked = 0
        self.last_removed = 0
        self.last_sweep_ms = 0.0
        self.last_retain_floor = 0
        self.sql_rows_trimmed = 0
        self.last_sql_trimmed = 0
        self.shards_sealed = 0
        self.seal_failures = 0

    # -- hooks -------------------------------------------------------------

    def on_validated(self, seq: int) -> None:
        """Drain-worker hook (after a durable CLF commit): start a sweep
        every `interval` validated ledgers. Cheap when idle."""
        with self._lock:
            if self._stop.is_set():
                return
            if self._thread is not None and self._thread.is_alive():
                return
            if self._apply_pending:
                return  # previous generation's apply not yet landed
            if seq - self._last_sweep_seq < self.interval:
                return
            self._last_sweep_seq = seq
            self.sweeps_started += 1
            self._thread = threading.Thread(
                target=self._run, args=(seq,), daemon=True,
                name="online-delete",
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=10)

    # -- sweep -------------------------------------------------------------

    def _run(self, validated_seq: int) -> None:
        db = self.node.nodestore
        t0 = time.perf_counter()
        try:
            db.begin_sweep()
            live: set[bytes] = set()
            lo = max(1, validated_seq - self.retain + 1)
            self.last_retain_floor = lo
            for seq in range(lo, validated_seq + 1):
                if self._stop.is_set():
                    db.cancel_sweep()
                    return
                self._mark_seq(seq, live)
        except Exception:  # noqa: BLE001 — a failed mark must disarm
            db.cancel_sweep()
            logging.getLogger("stellard.cleaner").exception(
                "online-delete mark failed (sweep skipped)"
            )
            return

        def apply_task():
            # ON the drain worker: no save_stage can be concurrent
            try:
                if self._stop.is_set():
                    db.cancel_sweep()
                    return
                try:
                    # catch-up mark: ledgers persisted since the mark
                    # began — contiguous from validated_seq+1, walked by
                    # direct header lookup (a full ledger_seqs() scan
                    # here would stall the drain worker, and before SQL
                    # trimming existed it also grew without bound)
                    seq = validated_seq + 1
                    while True:
                        hdr = self.node.txdb.get_ledger_header(seq=seq)
                        if hdr is None:
                            break
                        self._mark_seq(seq, live)
                        seq += 1
                    if self.shardstore is not None:
                        # tiering contract: history leaves the live
                        # store only AFTER its shard sealed — a failed
                        # seal skips this whole sweep generation (disk
                        # keeps growing, loudly) rather than deleting
                        # unsealed history
                        if not self._seal_retired(lo, live):
                            db.cancel_sweep()
                            return
                    removed = db.apply_sweep(live)
                except Exception:  # noqa: BLE001
                    db.cancel_sweep()
                    logging.getLogger("stellard.cleaner").exception(
                        "online-delete apply failed (sweep skipped)"
                    )
                    return
                trimmed = 0
                if self.sql_trim:
                    # SQL mirror rotation, ON the drain worker (it owns
                    # every txdb write, so no batch can be concurrent):
                    # the horizon is the same retain floor the mark used
                    try:
                        trimmed = sum(
                            self.node.txdb.trim_below(lo).values()
                        )
                    except Exception:  # noqa: BLE001 — trimming is an
                        # optimization over intact history; never fail
                        # the sweep for it
                        logging.getLogger("stellard.cleaner").exception(
                            "online-delete SQL trim failed (skipped)"
                        )
                with self._lock:
                    self.sql_rows_trimmed += trimmed
                    self.last_sql_trimmed = trimmed
                    self.sweeps_completed += 1
                    self.nodes_removed += removed
                    self.last_marked = len(live)
                    self.last_removed = removed
                    self.last_sweep_ms = round(
                        (time.perf_counter() - t0) * 1000.0, 2
                    )
            finally:
                with self._lock:
                    self._apply_pending = False

        def apply_failed():
            db.cancel_sweep()
            with self._lock:
                self._apply_pending = False

        with self._lock:
            self._apply_pending = True
        self.node.close_pipeline.submit_task(
            apply_task, on_failed=apply_failed
        )

    def _seal_retired(self, floor: int, live: set) -> bool:
        """Seal every stored-but-retiring ledger (seq < floor, above the
        last sealed shard) into history shards, one shard per contiguous
        header run. Runs ON the drain worker right before apply_sweep —
        by drain order no flush is concurrent, so the walked blobs are
        exactly what the sweep would delete. Returns False when a seal
        failed (the caller must then skip the sweep)."""
        from ..nodestore.shards import collect_retired

        txdb = self.node.txdb
        db = self.node.nodestore
        sealed_range = self.shardstore.range()
        start = sealed_range[1] + 1 if sealed_range else 1
        start = max(start, getattr(txdb, "retain_floor", 0) or 1)
        runs: list[list[dict]] = []
        cur: list[dict] = []
        for seq in range(start, floor):
            hdr = txdb.get_ledger_header(seq=seq)
            if hdr is None:
                if cur:
                    runs.append(cur)
                    cur = []
                continue
            cur.append(hdr)
        if cur:
            runs.append(cur)

        def fetch(h: bytes):
            obj = db.fetch(h, populate_cache=False)
            return obj.data if obj is not None else None

        for run in runs:
            lo_s, hi_s = run[0]["seq"], run[-1]["seq"]
            try:
                records = collect_retired(fetch, run, live)
                acct_rows = txdb.account_tx_index(lo_s, hi_s)
                self.shardstore.seal(
                    lo_s, hi_s, records, acct_rows,
                    first_hash=run[0]["hash"], last_hash=run[-1]["hash"],
                )
                with self._lock:
                    self.shards_sealed += 1
            except Exception:  # noqa: BLE001 — never delete unsealed
                with self._lock:
                    self.seal_failures += 1
                logging.getLogger("stellard.cleaner").exception(
                    "history-shard seal failed for [%d, %d] "
                    "(sweep skipped; disk keeps history)", lo_s, hi_s,
                )
                return False
        return True

    def _mark_seq(self, seq: int, live: set) -> None:
        hdr = self.node.txdb.get_ledger_header(seq=seq)
        if hdr is None:
            return
        live.add(hdr["hash"])  # the stored header object itself
        self._mark_tree(hdr["account_hash"], live)
        self._mark_tree(hdr["tx_hash"], live)

    def _mark_tree(self, root_hash: bytes, live: set) -> None:
        """Mark every reachable node by walking stored blobs directly
        (prefix-format: an inner node is HP_INNER_NODE + 16 child
        hashes) — no SHAMap materialization, and the live set itself
        memoizes shared subtrees across retained ledgers."""
        from ..state.shamap import ZERO256
        from ..utils.hashes import HP_INNER_NODE

        inner_prefix = HP_INNER_NODE.to_bytes(4, "big")
        db = self.node.nodestore
        stack = [root_hash]
        while stack:
            h = stack.pop()
            if h == ZERO256 or h in live:
                continue
            # facade fetch (pending writes must be visible) but without
            # cache insertion: an O(live-set) walk would otherwise
            # evict every hot close-path entry each sweep
            obj = db.fetch(h, populate_cache=False)
            if obj is None:
                continue  # history gap: nothing below it to retain
            live.add(h)
            blob = obj.data
            if blob[:4] == inner_prefix:
                for i in range(16):
                    stack.append(blob[4 + 32 * i: 36 + 32 * i])

    def get_json(self) -> dict:
        with self._lock:
            return {
                "retain": self.retain,
                "interval": self.interval,
                "running": (
                    self._thread is not None and self._thread.is_alive()
                ),
                "sweeps_started": self.sweeps_started,
                "sweeps_completed": self.sweeps_completed,
                "nodes_removed": self.nodes_removed,
                "last_marked": self.last_marked,
                "last_removed": self.last_removed,
                "last_sweep_ms": self.last_sweep_ms,
                "last_retain_floor": self.last_retain_floor,
                "sql_trim": self.sql_trim,
                "sql_rows_trimmed": self.sql_rows_trimmed,
                "last_sql_trimmed": self.last_sql_trimmed,
                "shards_enabled": self.shardstore is not None,
                "shards_sealed": self.shards_sealed,
                "seal_failures": self.seal_failures,
            }
