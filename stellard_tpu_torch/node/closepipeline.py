"""ClosePipeline: ordered async persistence for closed ledgers.

Reference shape: Ledger::pendSaveValidated hands the just-accepted
ledger to a JobQueue worker so the close path never waits on the disk
(Ledger.cpp pendSaveValidated → savePostponedLedger). This node makes
that stage explicit and strictly ordered:

- a bounded FIFO of sealed ledgers drained by ONE dedicated worker, so
  ledger N's NodeStore flush / tx-row insert / CLF commit run while
  ledger N+1 is already applying on the close path;
- ordered CLF commits: the single drain order guarantees the resume
  pointer never observes N+1 before N (concurrent workers could not);
- backpressure: when the queue is `depth` deep, the next close BLOCKS in
  submit() instead of pinning an unbounded backlog of whole Ledgers in
  memory — a disk that cannot keep up slows closes, never the process;
- read-your-writes: a queued-but-unpersisted ledger resolves from its
  in-flight entry (by hash, seq, or contained txid), so RPC/history
  lookups between close and persist never miss;
- drain-on-stop: stop() persists everything already queued before the
  worker exits, so the CLF pointer lands on the last closed ledger.

The pipeline is storage-agnostic: the node passes the three stage
callables (NodeStore save, txdb header+rows, CLF commit) and gets
per-stage latency histograms + queue-depth gauges back via get_json()
(surfaced in `server_state` / `get_counts`).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .metrics import LatencyHist

log = logging.getLogger("stellard.closepipeline")

# LatencyHist moved to node.metrics (one percentile implementation for
# the whole node); re-exported here for existing importers
__all__ = ["ClosePipeline", "LatencyHist"]


@dataclass
class _Entry:
    kind: str  # "close" (all stages) | "repair" (no CLF) | "task" (fn)
    ledger: object  # None for "task" entries
    results: dict
    done: Optional[Callable] = None  # done(results) after persist, in order
    on_failed: Optional[Callable] = None
    fn: Optional[Callable] = None  # "task" body, runs on the drain worker
    enqueued_at: float = field(default_factory=time.perf_counter)


class ClosePipeline:
    """Bounded, strictly-ordered persistence stage for closed ledgers."""

    def __init__(
        self,
        save_stage: Callable,          # save_stage(ledger) -> NodeStore flush
        txdb_stage: Callable,          # txdb_stage(ledger, results) -> rows
        clf_stage: Callable,           # clf_stage(ledger) -> CLF commit
        recover_results: Optional[Callable] = None,  # ledger -> {txid: TER}
        depth: int = 8,
        name: str = "ledger-persist",
        tracer=None,
    ):
        from .tracer import get_tracer

        self.save_stage = save_stage
        self.txdb_stage = txdb_stage
        self.clf_stage = clf_stage
        self.recover_results = recover_results
        self.tracer = tracer if tracer is not None else get_tracer()
        self.depth = max(1, int(depth))
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._queue: list[_Entry] = []
        self._active: Optional[_Entry] = None  # entry being persisted now
        self._by_hash: dict[bytes, _Entry] = {}
        self._by_seq: dict[int, _Entry] = {}
        self._stopping = False
        # metrics
        self.persisted = 0
        self.failed = 0
        self.depth_hwm = 0
        self.backpressure_waits = 0
        self.backpressure_ms = 0.0
        self.stage_hist = {
            "queue_wait": LatencyHist(),  # enqueue -> drain start
            "nodestore": LatencyHist(),
            "txdb": LatencyHist(),
            "clf": LatencyHist(),
            "total": LatencyHist(),
        }
        # the ms of each stage of the entry persisted last; a ``done``
        # callback (run on the worker before the next entry starts)
        # reads its own ledger's here
        self.last_stage_ms: dict[str, float] = {}
        self._name = name
        # worker starts lazily on first submit: a Node constructed and
        # discarded without stop() must not leak a polling daemon thread
        self._thread: Optional[threading.Thread] = None

    def _ensure_worker(self) -> None:
        """Start the drain worker on first use; caller holds self._lock."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._drain, name=self._name, daemon=True
            )
            self._thread.start()

    # -- submission --------------------------------------------------------

    def submit_close(self, ledger, results: dict,
                     done: Optional[Callable] = None,
                     on_failed: Optional[Callable] = None) -> None:
        """Queue a freshly-closed ledger for full persistence (NodeStore +
        tx rows + ordered CLF commit). Blocks when the queue is full."""
        self._submit(_Entry("close", ledger, results, done, on_failed),
                     self.depth)

    def submit_repair(self, ledger, results: Optional[dict] = None,
                      done: Optional[Callable] = None,
                      on_failed: Optional[Callable] = None) -> None:
        """Queue a HISTORICAL ledger (cleaner repair / catch-up): data only,
        never the CLF resume pointer (it must not move backwards). Bounded
        more generously than closes — the cleaner's own in-flight cap is
        the real limiter — and each kind counts only against its OWN
        limit, so a repair burst can never back-pressure the consensus
        tick through the shared queue."""
        self._submit(_Entry("repair", ledger, results or {}, done, on_failed),
                     max(self.depth, 256))

    def submit_task(self, fn: Callable, done: Optional[Callable] = None,
                    on_failed: Optional[Callable] = None) -> None:
        """Queue a storage-maintenance task to run ON the drain worker,
        in order with the persists around it. The online-deletion sweep
        applies through here: while the task runs, no save_stage can be
        mid-flight, so a flush that already passed its known-set check
        can never land after the sweep deleted the nodes it skipped."""
        self._submit(
            _Entry("task", None, {}, done, on_failed, fn=fn),
            max(self.depth, 256),
        )

    @staticmethod
    def _fail(entry: _Entry) -> None:
        """Fire the submitter's failure accounting; its exceptions must
        never propagate into the pipeline."""
        if entry.on_failed is not None:
            try:
                entry.on_failed()
            except Exception:  # noqa: BLE001
                pass

    def _kind_depth(self, kind: str) -> int:
        return sum(1 for e in self._queue if e.kind == kind)

    def _submit(self, entry: _Entry, limit: int) -> None:
        with self._not_full:
            if self._stopping:
                # never strand the submitter's accounting on shutdown
                self._fail(entry)
                return
            if self._kind_depth(entry.kind) >= limit:
                self.backpressure_waits += 1
                t0 = time.perf_counter()
                while (self._kind_depth(entry.kind) >= limit
                       and not self._stopping):
                    self._not_full.wait(timeout=1.0)
                self.backpressure_ms += (time.perf_counter() - t0) * 1000.0
                if self._stopping:
                    # stop() fired while we were blocked: the drain worker
                    # may already have exited — appending now would strand
                    # the entry forever with neither callback fired
                    self._fail(entry)
                    return
            # stamped at APPEND, after any backpressure wait: queue_wait
            # must measure drain latency, not re-count backpressure_ms
            entry.enqueued_at = time.perf_counter()
            self._queue.append(entry)
            self._ensure_worker()
            self.depth_hwm = max(self.depth_hwm, len(self._queue))
            if entry.ledger is not None:
                h = entry.ledger.hash()
                self._by_hash[h] = entry
                self._by_seq[entry.ledger.seq] = entry
            self._not_empty.notify()

    # -- read-your-writes lookups -----------------------------------------

    def get(self, ledger_hash: bytes):
        """Queued-or-persisting ledger by hash, else None."""
        with self._lock:
            e = self._by_hash.get(ledger_hash)
            return e.ledger if e is not None else None

    def get_by_seq(self, seq: int):
        """Queued-or-persisting ledger by sequence, else None."""
        with self._lock:
            e = self._by_seq.get(seq)
            return e.ledger if e is not None else None

    def lookup_tx(self, txid: bytes) -> Optional[tuple]:
        """(ledger, tx_blob, meta_blob, results) for a tx inside any
        in-flight ledger — the txdb-miss resolver for the `tx` RPC."""
        with self._lock:
            entries = list(self._by_seq.values())
        for e in entries:
            found = e.ledger.get_transaction(txid)
            if found is not None:
                return e.ledger, found[0], found[1], e.results
        return None

    def pending(self) -> int:
        with self._lock:
            return len(self._queue) + (1 if self._active is not None else 0)

    # -- drain worker ------------------------------------------------------

    def _drain(self) -> None:
        while True:
            with self._not_empty:
                while not self._queue and not self._stopping:
                    self._not_empty.wait(timeout=1.0)
                if not self._queue:
                    # stopping and drained
                    self._idle.notify_all()
                    return
                entry = self._queue.pop(0)
                self._active = entry
                # all waiters: limits are per-kind, and a single notify
                # could wake a waiter whose own kind is still at limit
                self._not_full.notify_all()
            ok = False
            try:
                self._persist(entry)
                self.persisted += 1
                ok = True
            except Exception:  # noqa: BLE001 — keep persisting later ledgers
                self.failed += 1
                if entry.ledger is not None:
                    log.exception(
                        "persist failed for ledger seq %d", entry.ledger.seq
                    )
                else:
                    log.exception("pipeline task failed")
                self._fail(entry)
            finally:
                with self._lock:
                    self._active = None
                    if entry.ledger is not None:
                        h = entry.ledger.hash()
                        if self._by_hash.get(h) is entry:
                            del self._by_hash[h]
                        if self._by_seq.get(entry.ledger.seq) is entry:
                            del self._by_seq[entry.ledger.seq]
                    # every completion notifies: wait_for_closes watches
                    # individual entries, not just the queue-empty edge
                    self._idle.notify_all()
            if ok and entry.done is not None:
                # OUTSIDE the persist accounting: all storage stages
                # committed — a publish/WS-sink error must not read as a
                # phantom persistence failure (nor double-release the
                # cleaner's in-flight slot via on_failed)
                try:
                    entry.done(entry.results)
                except Exception:  # noqa: BLE001
                    log.exception(
                        "post-persist callback failed for ledger seq %d",
                        entry.ledger.seq,
                    )

    def _persist(self, entry: _Entry) -> None:
        if entry.kind == "task":
            entry.fn()
            return
        t_start = time.perf_counter()
        seq = entry.ledger.seq
        tr = self.tracer
        self.stage_hist["queue_wait"].record(
            (t_start - entry.enqueued_at) * 1000.0
        )
        tr.complete("persist.queue_wait", "persist", entry.enqueued_at,
                    t_start, seq=seq)
        results = entry.results
        if not results and self.recover_results is not None:
            # ledger we never applied locally (catch-up adoption / history
            # repair): recover per-tx results from the sfTransactionResult
            # metadata byte so stored history and streams report real codes
            results = self.recover_results(entry.ledger)
            entry.results = results

        stages = {"queue_wait": (t_start - entry.enqueued_at) * 1000.0}
        t0 = time.perf_counter()
        self.save_stage(entry.ledger)
        t1 = time.perf_counter()
        stages["nodestore"] = (t1 - t0) * 1000.0
        self.stage_hist["nodestore"].record(stages["nodestore"])
        tr.complete("persist.nodestore", "persist", t0, t1, seq=seq)
        self.txdb_stage(entry.ledger, results)
        t2 = time.perf_counter()
        stages["txdb"] = (t2 - t1) * 1000.0
        self.stage_hist["txdb"].record(stages["txdb"])
        tr.complete("persist.txdb", "persist", t1, t2, seq=seq)
        if entry.kind == "close":
            self.clf_stage(entry.ledger)
            t3 = time.perf_counter()
            stages["clf"] = (t3 - t2) * 1000.0
            self.stage_hist["clf"].record(stages["clf"])
            tr.complete("persist.clf", "persist", t2, t3, seq=seq)
        t_end = time.perf_counter()
        stages["total"] = (t_end - t_start) * 1000.0
        self.stage_hist["total"].record(stages["total"])
        self.last_stage_ms = stages
        tr.complete("persist.total", "persist", t_start, t_end, seq=seq,
                    kind=entry.kind, txs=len(results or ()))
        # per-tx persist marks close out each SAMPLED transaction's
        # causal tree (submit → verify → apply → close → persist); runs
        # on the drain worker, off the close path, and the sampling gate
        # bounds it
        if results and tr.enabled:
            for txid in results:
                if tr.sampled(txid):
                    tr.instant("persist.tx", "persist", txid=txid,
                               ledger_seq=seq)

    # -- lifecycle ---------------------------------------------------------

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until everything queued so far is persisted. True when
        drained, False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._queue or self._active is not None:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._idle.wait(timeout=remaining if remaining else 1.0)
        return True

    def wait_for_closes(self, timeout: float = 10.0) -> bool:
        """Block until every CLOSE entry pending AT CALL TIME is
        persisted (repairs and later arrivals excluded — this is the
        bounded read-your-writes barrier for the SQL-index RPCs). True
        when they all landed, False on timeout."""
        with self._lock:
            targets = [
                (e.ledger.hash(), e)
                for e in self._queue if e.kind == "close"
            ]
            if self._active is not None and self._active.kind == "close":
                targets.append((self._active.ledger.hash(), self._active))
        if not targets:
            return True
        deadline = time.monotonic() + timeout
        with self._idle:
            while any(
                self._by_hash.get(h) is e or self._active is e
                for h, e in targets
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(timeout=min(remaining, 1.0))
        return True

    def stop(self, timeout: float = 60.0) -> bool:
        """Drain the queue, then stop the worker. True when fully drained
        (nothing persisted is lost; the CLF pointer lands on the last
        closed ledger), False when the timeout expired first."""
        with self._lock:
            self._stopping = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            t = self._thread
        if t is None:
            return True  # worker never started: nothing ever queued
        t.join(timeout=timeout)
        if t.is_alive():
            log.error(
                "shutdown with ~%d ledgers still unpersisted", self.pending()
            )
            return False
        return True

    # -- metrics -----------------------------------------------------------

    def get_json(self) -> dict:
        with self._lock:
            depth = len(self._queue) + (1 if self._active is not None else 0)
        return {
            "depth": depth,
            "depth_limit": self.depth,
            "depth_hwm": self.depth_hwm,
            "persisted": self.persisted,
            "failed": self.failed,
            "backpressure_waits": self.backpressure_waits,
            "backpressure_ms": round(self.backpressure_ms, 3),
            "stages": {
                name: h.get_json() for name, h in self.stage_hist.items()
            },
        }
