"""Parallel speculative executor: a multi-worker Block-STM apply plane.

The JAX package's ``engine/specexec.py``. The delta-replay close executes
every accepted transaction once at submit time and splices the recorded
delta at close — but on the serial path that one speculative execution
runs on the submit thread under the chain lock, so speculation
throughput is pinned to one interpreter core. This module finishes the
Block-STM idea (Gelashvili et al., 2022): execute transactions
optimistically across N workers and validate read sets at commit, so
speculation scales with cores.

Shape:

- ``SpecExecutor`` owns the worker pool ([spec] workers=N). ``workers=1``
  (the default) keeps the executor inert — ``LedgerMaster._speculate_open``
  runs the serial inline path byte-for-byte as before.

- Each open window gets a ``SpecSession``. Dispatch (under the chain
  lock) allocates the transaction's speculation index from the
  SpecState — the one total order that the commit step, the pre-seal
  building-tree folds, and the close's splice all share.

- Workers execute optimistically: a per-task ``_ExecView`` captures
  reads/succs/writes over a *replica* of the committed state (the shared
  ``SpecState.view`` for thread workers; a worker-local mirror built
  from shipped deltas for process workers). The record a worker produces
  is built by ``engine.deltareplay.execute_record`` — the exact code the
  serial path runs, which is what makes records byte-equal.

- Commit is strictly in index order, guarded by one commit lock: the
  record's entry reads must resolve to the same writers in the committed
  view and its succ cursors must reproduce — the SAME validation the
  close's ``try_splice`` applies, run early. A stale record (executed
  before a lower-indexed conflict committed) is re-executed with bounded
  retries, then executed serially on the committing thread against the
  committed view itself — which is literally the serial path and
  therefore always valid. Nothing is ever silently poisoned: an aborted
  execution retries; only an in-execution *exception* on the serial
  fallback disables the overlay (the serial path's own semantics).

- Worker transports: ``thread`` (in-process; optimistic shared-view
  reads — torn reads are caught by commit validation), ``process``
  (fork workers; a worker's state is the picklable scalar snapshot plus
  parent state read through the pipe and cached per window — never a
  full state copy), and ``manual`` (no workers; tests drive execution
  in seeded orders via ``step``/``pump`` so conflict interleavings
  replay deterministically, and ``drain`` completes the window inline).

- Process scheduling is ACCOUNT-AFFINE: a task is assigned to the
  worker its account hashes to, so one account's sequence chain
  executes in order on one worker, chained tentatively through a
  journaled replica (rolled back when a retry re-enters the chain).
  Committed-writer deltas ship only with RETRY chunks — a first
  execution reads its own chain plus the immutable parent, and a
  cross-account conflict surfaces as a validation abort whose retry
  then executes against a fully-current replica (guaranteed valid,
  since retries run at the commit frontier).

Lock order (deadlock audit): commit work takes session.commit_lock →
session.lock → (fold) nothing of the LedgerMaster's — the chain lock is
NEVER taken by commit threads. The close thread holds the chain lock and
waits on the session condition / takes commit_lock, so no inversion is
possible. Building-tree folds race only against the seal drainer's root
*read*, which is safe because ``SHAMap.bulk_update`` builds a new
persistent root and installs it with one attribute store.

A process worker is a fork of a node that may hold a CUDA context: it
must never touch the card (a forked child that does raises, and it
inherits the locks other threads held at the fork). So this module and
everything it imports import neither ``torch`` nor ``jax``, and
``_worker_main`` runs only the engine: never the hasher, never the
verify plane.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time
from bisect import insort
from collections import deque
from typing import Optional

from ..node.metrics import AtomicCounters
from ..node.tracer import get_tracer
from ..protocol.sfields import sfTransactionIndex
from ..protocol.stobject import STObject
from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from ..state.shamap import SHAMapItem
from ..state.specview import PARENT, SpecView, _ShimItem
from .deltareplay import HEADER_TYPES, SpecRecord, execute_record

__all__ = ["SpecExecutor", "SpecSession"]

log = logging.getLogger("stellard.specexec")

_MISS = object()

# task lifecycle
PENDING = 0    # awaiting a worker
RUNNING = 1    # executing on a worker
READY = 2      # candidate record produced, awaiting ordered commit
COMMITTED = 3  # validated + folded into the committed view
SKIPPED = 4    # consumed its index without a retained record


class _ExecView(SpecView):
    """Per-task capture view over a worker's replica of the committed
    state: reads fall through to the replica WITH its committed-writer
    provenance (``peek``), writes stay local to this view, and the
    spring-into-existence probe asks the replica's merged view instead
    of the raw parent map. The capture a task produces is therefore
    exactly what the serial path would have captured had the committed
    prefix been the overlay it ran on."""

    @classmethod
    def over(cls, replica: SpecView) -> "_ExecView":
        view = cls.from_snapshot(replica.snapshot_scalars(),
                                 replica._parent)
        view._replica = replica
        return view

    def read_entry_pristine(self, index: bytes):
        sle = self._overlay.get(index, _MISS)
        if sle is not _MISS:
            if index not in self._reads:
                self._reads[index] = self._writers.get(index, PARENT)
            return sle
        v, w = self._replica.peek(index)
        if index not in self._reads:
            self._reads[index] = w
        return v

    def resolve_succ(self, key: bytes):
        # the replica's merged succ (parent + committed overlay),
        # re-merged with this task's own created/deleted keys — mirrors
        # SpecView.resolve_succ with the replica in the parent role
        cur = key
        while True:
            item = self._replica.resolve_succ(cur)
            if item is None or self._overlay.get(item.tag, _MISS) is not None:
                break
            cur = item.tag
        created = self._created_after(key)
        if item is not None and (created is None or item.tag < created):
            return item
        if created is not None:
            return _ShimItem(created)
        return None

    def write_entry(self, index: bytes, sle) -> None:
        prev = self._overlay.get(index, _MISS)
        if index not in self._created_set and (prev is _MISS or prev is None):
            # existence probe on the MERGED committed view (not the raw
            # parent map): a key created by a committed predecessor must
            # not re-join this task's created list
            if not self._replica.merged_has(index):
                insort(self._created, index)
                self._created_set.add(index)
        self._overlay[index] = sle
        self._writers[index] = self._txid
        self._writes.append((index, sle))


class _Task:
    __slots__ = (
        "index", "txid", "tx", "blob", "sig_good", "origin", "state",
        "attempts", "rec", "wire", "error", "t_dispatch", "exec_span",
        "owner",
    )

    def __init__(self, index, tx, origin):
        self.index = index
        self.txid = tx.txid()
        self.tx = tx
        # account-affinity key (deterministic, unlike salted hash()):
        # one account's sequence chain always lands on one worker, so
        # dependent neighbors chain tentatively instead of aborting
        self.owner = int.from_bytes(tx.account[:8], "big")
        self.blob = None        # lazily serialized for process transport
        self.sig_good = bool(tx._sig_good)
        self.origin = origin
        self.state = PENDING
        self.attempts = 0
        self.rec: Optional[SpecRecord] = None   # thread/manual candidate
        self.wire = None                        # process-mode payload
        self.error: Optional[str] = None
        self.t_dispatch = time.perf_counter()
        self.exec_span: Optional[tuple] = None  # (t0, t1, worker)


class SpecSession:
    """One open window's scheduling state. Tasks are index-aligned with
    the SpecState's speculation indexes (dispatch allocates them under
    the chain lock, so they are contiguous from 0)."""

    def __init__(self, executor: "SpecExecutor", spec, parent_ledger,
                 window_id: int, on_fold=None):
        self.executor = executor
        self.spec = spec
        self.view = spec.view
        self.parent_ledger = parent_ledger
        self.window_id = window_id
        self.on_fold = on_fold
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.tasks: list[_Task] = []
        self.pending: deque[int] = deque()
        self.next_commit = 0
        self.seen: set[bytes] = set()
        self.commit_lock = threading.Lock()
        self.closed = False
        # committed-writer log for the process workers: one entry per
        # committed record, shipped to each worker PIGGYBACKED on its
        # next exec assignment (an idle worker needs no deltas, and a
        # busy one gets them exactly when they matter — just before it
        # executes). Appended under commit_lock, so it is in commit
        # order; per-worker watermarks live on the _Proc.
        self.delta_log: list[tuple] = []
        # process-mode provenance map: key -> (txid, attempt-epoch) of
        # the committed writer. Worker replicas tag TENTATIVE chained
        # writes with their execution attempt, so a record that read an
        # aborted attempt's value can never validate against the same
        # txid's eventually-committed (different) execution — bare-txid
        # provenance alone could not tell them apart. Normalized back
        # to bare txids at commit, which is what the close's splice
        # validation consumes.
        self.writer_epoch: dict[bytes, object] = {}

    def complete(self) -> bool:
        """Caller holds self.lock."""
        return self.next_commit >= len(self.tasks)


def _wire_record(rec: SpecRecord, retained: bool):
    """Picklable result payload for the process transport."""
    writes = [
        (k, it.data if it is not None else None)
        for k, it in rec.write_items
    ]
    meta_b, off = rec.meta_blob, rec.meta_index_off
    if rec.meta is not None and meta_b is None:
        # index span wasn't pinnable: ship a canonical index-0
        # serialization; the parent re-parses and the splice
        # re-serializes (the always-correct slow path)
        rec.meta[sfTransactionIndex] = 0
        meta_b, off = rec.meta.serialize(), -1
    return (
        int(rec.raw_ter), int(rec.ter), rec.did_apply, rec.reads,
        rec.succs, writes, tuple(rec.net_deletes), meta_b, off, rec.fee,
        rec.origin, retained,
    )


def _unwire_record(payload) -> tuple[SpecRecord, bool]:
    (raw, ter, did, reads, succs, writes, netdel, meta_b, off, fee,
     origin, retained) = payload
    items = []
    for k, data in writes:
        items.append((k, SHAMapItem(k, data) if data is not None else None))
    meta = STObject.from_bytes(meta_b) if meta_b is not None else None
    rec = SpecRecord(TER(raw), TER(ter), did, reads, list(succs), items,
                     meta, fee)
    rec.net_deletes = frozenset(netdel)
    rec.origin = origin
    if meta_b is not None and off >= 0:
        rec.meta_blob = meta_b
        rec.meta_index_off = off
    return rec, retained


# ---------------------------------------------------------------------------
# process-worker side
# ---------------------------------------------------------------------------


class _IPCParent:
    """Worker-side read-through adapter standing in for the parent
    ledger: entry reads and succ walks cross the pipe once and are
    cached for the window (the parent state map is immutable while the
    window is open). Doubles as its own ``state_map`` facade."""

    def __init__(self, sync_read):
        self._sync = sync_read
        self._entries: dict[bytes, Optional[STObject]] = {}
        self._raw: dict[bytes, Optional[bytes]] = {}
        self._succ: dict[bytes, Optional[bytes]] = {}
        self.state_map = self

    def reset(self) -> None:
        self._entries.clear()
        self._raw.clear()
        self._succ.clear()

    def _fetch(self, key: bytes) -> Optional[bytes]:
        if key in self._raw:
            return self._raw[key]
        data = self._sync("r", key)
        self._raw[key] = data
        return data

    def read_entry_pristine(self, key: bytes) -> Optional[STObject]:
        sle = self._entries.get(key, _MISS)
        if sle is not _MISS:
            return sle
        data = self._fetch(key)
        sle = STObject.from_bytes(data) if data is not None else None
        self._entries[key] = sle
        return sle

    # -- state_map facade (get existence probe + succ walks) ---------------

    def get(self, key: bytes):
        return _ShimItem(key) if self._fetch(key) is not None else None

    def succ(self, key: bytes):
        if key in self._succ:
            tag = self._succ[key]
        else:
            tag = self._sync("s", key)
            self._succ[key] = tag
        return _ShimItem(tag) if tag is not None else None


def _chain_tentative(replica, journal, index, txid, rec, attempt,
                     created_set) -> None:
    """Apply one executed record's writes to the worker replica as if
    committed — tagged (txid, attempt) so a read of an aborted attempt
    can never validate — journaling every key's prior state so a later
    retry chunk can roll the speculation back (`_rollback_tentative`).
    The overlay stores the record's SHAMapItems directly: `.parsed` is
    already pinned, so a same-worker dependent pays zero re-parse."""
    for k, it in rec.write_items:
        journal.append((
            index, k, replica._overlay.get(k, _MISS),
            replica._writers.get(k), k in replica._created_set,
        ))
        replica._writers[k] = (txid, attempt)
        if it is None:
            replica._created_remove(k)
            replica._overlay[k] = None
        else:
            if k in created_set and k not in replica._created_set:
                insort(replica._created, k)
                replica._created_set.add(k)
            replica._overlay[k] = it


def _rollback_tentative(replica, journal, min_index) -> None:
    """Undo every journaled tentative write from tasks >= min_index (a
    retry chunk re-executes the commit frontier: speculation chained
    past it on THIS worker is stale and must not be visible). Reversed
    walk so stacked writes to one key unwind to the oldest prior."""
    keep = [e for e in journal if e[0] < min_index]
    for index, k, prior, pw, was_created in reversed(journal):
        if index < min_index:
            continue
        if prior is _MISS:
            replica._overlay.pop(k, None)
        else:
            replica._overlay[k] = prior
        if pw is None:
            replica._writers.pop(k, None)
        else:
            replica._writers[k] = pw
        now = k in replica._created_set
        if was_created and not now:
            replica._created_set.add(k)
            insort(replica._created, k)
        elif not was_created and now:
            replica._created_remove(k)
    journal[:] = keep


def _worker_main(cmd, res) -> None:
    """Process-worker loop. Messages on ``cmd``: win/delta/exec/end/stop
    plus rr/sr read replies; results and read requests go out on ``res``.
    Replies can interleave with proactive sends (deltas, the next exec),
    so non-reply messages arriving while a read is in flight are buffered
    and handled after the current execution finishes."""
    # the heap inherited through the fork is never scanned here: a
    # collection would touch (and so copy) every page of the parent's
    gc.freeze()
    for conn in (cmd, res):
        # ring transport: drop this process's inherited copy of the
        # parent-side doorbell fd so parent death surfaces as EOF here
        # (the pipe transport's Connections need no settling)
        settle = getattr(conn, "settle", None)
        if settle is not None:
            settle()
    buffered: deque = deque()
    state = {"wid": None, "replica": None, "adapter": None,
             "journal": [], "committed_max": -1}

    def sync_read(kind, key):
        res.send((kind, state["wid"], key))
        want = "rr" if kind == "r" else "sr"
        while True:
            m = cmd.recv()
            if m[0] == want:
                return m[1]
            if m[0] == "stop":
                # the parent is shutting down: the read server (its
                # committer) is gone and the reply will never come —
                # exit now instead of wedging in recv until stop()'s
                # join timeout expires and SIGTERMs this process
                raise SystemExit(0)
            buffered.append(m)

    adapter = _IPCParent(sync_read)

    def handle(msg) -> bool:
        kind = msg[0]
        if kind == "win":
            _k, wid, scalars = msg
            adapter.reset()
            state["wid"] = wid
            state["replica"] = SpecView.from_snapshot(scalars, adapter)
            state["journal"] = []
            state["committed_max"] = -1
        elif kind == "exec":
            _k, wid, deltas, items = msg
            if wid != state["wid"] or state["replica"] is None:
                res.send(("resb", wid,
                          [(i, 0.0, 0.0, "stale", None, _a)
                           for i, _b, _s, _o, _a in items]))
                return True
            replica = state["replica"]
            journal = state["journal"]
            # a retry chunk re-executes the commit frontier: any
            # tentative speculation this worker chained at or past it
            # is stale — unwind it BEFORE the committed deltas land
            if journal and items and items[0][0] <= journal[-1][0]:
                _rollback_tentative(replica, journal, items[0][0])
            # the committed-writer deltas since this worker's last
            # assignment ride the exec message — apply them first so
            # the replica is current for this chunk. The writer epoch
            # (txid, committed-attempt) is the provenance readers will
            # record and commit validation will compare.
            for index, txid, pairs, added, removed, applied, epoch \
                    in deltas:
                replica.apply_delta(txid, pairs, added, removed, applied,
                                    writer=(txid, epoch))
                if index > state["committed_max"]:
                    state["committed_max"] = index
            if journal:
                # tentative writes the committed deltas superseded can
                # never roll back (the frontier is past them) — prune
                journal[:] = [e for e in journal
                              if e[0] > state["committed_max"]]
            out = []
            for index, blob, sig_good, origin, attempt in items:
                t0 = time.perf_counter()
                try:
                    tx = SerializedTransaction.from_bytes(blob)
                    if sig_good:
                        tx.set_sig_verdict(True)
                    txid = tx.txid()
                    view = _ExecView.over(replica)
                    view.begin_tx(txid)
                    rec = execute_record(view, tx, origin)
                    retained = not (rec.did_apply and rec.meta is None)
                    out.append((index, t0, time.perf_counter(), None,
                                _wire_record(rec, retained), attempt))
                    # chain TENTATIVELY (journaled): apply this record's
                    # writes to the replica as if committed, so
                    # same-chunk dependents execute against their
                    # predecessors. Tagged with THIS attempt's epoch: if
                    # the record aborts and re-executes, a read of this
                    # value can never validate against the committed
                    # epoch.
                    if rec.write_items:
                        _chain_tentative(replica, journal, index, txid,
                                         rec, attempt, view._created_set)
                except Exception as exc:  # noqa: BLE001 — the parent
                    # decides between retry and serial fallback; never
                    # kill the worker
                    out.append((index, t0, time.perf_counter(),
                                repr(exc), None, attempt))
            res.send(("resb", wid, out))
        elif kind in ("rr", "sr"):
            pass  # stale reply after an abandoned read; drop
        elif kind == "end":
            if msg[1] == state["wid"]:
                state["wid"] = state["replica"] = None
                adapter.reset()
        elif kind == "stop":
            return False
        return True

    while True:
        try:
            msg = buffered.popleft() if buffered else cmd.recv()
            alive = handle(msg)
        except (EOFError, OSError):
            # parent gone (or closed our command channel at stop):
            # exit quietly — this IS the shutdown signal when the
            # parent marked this worker dead and skipped its ("stop",)
            return
        if not alive:
            return


class _Proc:
    __slots__ = ("proc", "cmd", "res", "send_lock", "outstanding",
                 "alive", "delta_sent")

    def __init__(self, proc, cmd, res):
        self.proc = proc
        self.cmd = cmd                  # parent -> worker
        self.res = res                  # worker -> parent
        self.send_lock = threading.Lock()
        self.outstanding = 0
        self.alive = True
        self.delta_sent = 0             # session.delta_log watermark

    def send(self, msg) -> bool:
        if not self.alive:
            return False
        try:
            with self.send_lock:
                self.cmd.send(msg)
            return True
        except (OSError, ValueError, BrokenPipeError):
            self.alive = False
            return False



# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


class SpecExecutor:
    """Multi-worker Block-STM speculative executor ([spec] workers=N).

    ``workers<=1`` → inert (``active`` False): LedgerMaster keeps the
    serial inline path, byte-for-byte. ``mode``: "process" (default,
    real parallelism around the GIL), "thread" (in-process workers —
    races are real, parallelism is GIL-bound; the concurrency-hammer
    configuration), "manual" (tests drive seeded schedules)."""

    def __init__(self, workers: int = 1, mode: str = "process",
                 max_retries: int = 3, tracer=None,
                 drain_timeout_s: float = 10.0, transport: str = "ring"):
        self.workers = int(workers)
        self.mode = mode
        if transport not in ("ring", "pipe"):
            raise ValueError(
                f"[spec] transport must be 'ring' or 'pipe', got "
                f"{transport!r}"
            )
        # process-worker wire: "ring" (shared-memory SPSC rings, pickle-
        # free codec — the default) or "pipe" (pickled
        # multiprocessing.Pipe, kept as the comparison/fallback leg)
        self.transport = transport
        self.max_retries = int(max_retries)
        self.drain_timeout_s = float(drain_timeout_s)
        self.tracer = tracer if tracer is not None else get_tracer()
        self.active = self.workers > 1
        # process workers take chunks of up to exec_batch tasks per
        # message (one round trip per chunk, not per task), assigned by
        # ACCOUNT AFFINITY, and chain tentative writes locally — one
        # account's dependent run executes against its predecessors on
        # one worker however the chunks split. Affinity is also why the
        # execution horizon can be generous (classic Block-STM gates
        # execution near the validation frontier because far-ahead
        # executions go wholesale-stale): an execution ahead of the
        # frontier on its OWN chain stays valid, and cross-account
        # staleness is caught by commit validation regardless of
        # distance. The horizon only bounds worst-case wasted work when
        # a window turns out conflict-heavy.
        self.exec_batch = max(8, 64 // max(1, self.workers))
        self.exec_horizon = max(512, 4 * self.workers * self.exec_batch)
        self.counters = AtomicCounters(
            "windows", "dispatched", "executed", "committed", "retries",
            "validation_aborts", "serial_fallbacks", "exec_errors",
            "no_records", "drains_forced", "reads_served", "deltas_sent",
            "worker_deaths", "committer_errors",
        )
        self._started = False
        self._stopping = False
        self._failed = False  # committer crashed: degrade to serial
        self._slock = threading.Lock()   # session/start lifecycle
        # one assigner at a time: the committer loop and a drain/pump
        # caller's retry path can both reach _assign_procs, and
        # interleaved pending-pops would send one worker's chunks out
        # of index order, breaking the account-affine in-order premise
        # the tentative-chain journal relies on
        self._assign_lock = threading.Lock()
        self.session: Optional[SpecSession] = None
        self._window_seq = 0
        self._threads: list[threading.Thread] = []
        self._procs: list[_Proc] = []
        # ONE committer thread multiplexes every worker pipe
        # (multiprocessing.connection.wait): results, parent-state
        # reads, ordered commits, and chunk assignment all run on it,
        # so the steady state has zero cross-thread handoffs — on a
        # small host the GIL ping-pong between per-worker service
        # threads costs more than the work itself. The submit thread
        # wakes it through a self-pipe (one byte, no locks held).
        self._committer: Optional[threading.Thread] = None
        self._wake_r: Optional[int] = None
        self._wake_w: Optional[int] = None

    # -- lifecycle ---------------------------------------------------------

    @property
    def can_accept(self) -> bool:
        """True while dispatch could take new work: not stopping,
        committer alive, and (in process mode, once started) at least
        one live worker. _speculate_open checks this BEFORE opening a
        window so a permanently-failed executor doesn't churn a fresh
        session — snapshot broadcast, windows-counter bump, teardown —
        per transaction on its way to the serial path."""
        if self._stopping or self._failed or not self.active:
            return False
        if self.mode == "process" and self._started \
                and not any(w.alive for w in self._procs):
            return False
        return True

    def start(self) -> None:
        """Start the worker pool (idempotent). Fork-based process
        workers start here — as early in the node's life as possible,
        before the window machinery is hot."""
        with self._slock:
            if self._started or not self.active or self._stopping:
                return
            self._started = True
            if self.mode == "process":
                self._wake_r, self._wake_w = os.pipe()
                os.set_blocking(self._wake_r, False)
                os.set_blocking(self._wake_w, False)
                self._start_procs()
                self._committer = threading.Thread(
                    target=self._committer_loop, name="spec-committer",
                    daemon=True,
                )
                self._committer.start()
            elif self.mode == "thread":
                for i in range(self.workers):
                    t = threading.Thread(
                        target=self._thread_worker_loop, args=(i,),
                        name=f"spec-worker-{i}", daemon=True,
                    )
                    t.start()
                    self._threads.append(t)
            # manual: no workers — tests drive step()/pump()/drain()

    def _start_procs(self) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        for i in range(self.workers):
            if self.transport == "ring":
                from .specring import ring_pipe

                # built BEFORE fork; the child inherits the mapped
                # segments and its doorbell fds through Process args
                # (fork does not pickle them)
                cmd_r, cmd_w = ring_pipe()          # parent -> worker
                res_r, res_w = ring_pipe()          # worker -> parent
            else:
                cmd_r, cmd_w = ctx.Pipe(duplex=False)   # parent -> worker
                res_r, res_w = ctx.Pipe(duplex=False)   # worker -> parent
            proc = ctx.Process(
                target=_worker_main, args=(cmd_r, res_w),
                name=f"spec-worker-{i}", daemon=True,
            )
            proc.start()
            if self.transport == "ring":
                # keep cmd_w/res_r; settle drops the parent's copies of
                # the child-side doorbell fds so worker death surfaces
                # as EOF on res / EPIPE on cmd, like a broken pipe did
                cmd_w.settle()
                res_r.settle()
            else:
                cmd_r.close()
                res_w.close()
            self._procs.append(_Proc(proc, cmd_w, res_r))

    def stop(self) -> None:
        """Stop workers (Node.stop). Any open session is force-completed
        serially first so no records are abandoned mid-window."""
        with self._slock:
            self._stopping = True
            session = self.session
        if session is not None:
            self.end_window(session, timeout=0.0)
        for w in self._procs:
            w.send(("stop",))
        if self._wake_w is not None:
            self._wake()
        for w in self._procs:
            if w.proc.is_alive():
                w.proc.join(timeout=5)
                if w.proc.is_alive():
                    w.proc.terminate()
            w.alive = False
            for conn in (w.cmd, w.res):
                # ring ends: release + unlink the shared segments (the
                # creator owns teardown); pipe Connections just close.
                # getattr both ways: tests wrap conns in minimal fakes
                fin = getattr(conn, "destroy", None) \
                    or getattr(conn, "close", None)
                try:
                    if fin is not None:
                        fin()
                except OSError:
                    pass
        if self._committer is not None:
            self._committer.join(timeout=5)
            self._committer = None
        for fd in (self._wake_r, self._wake_w):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._wake_r = self._wake_w = None
        with self._slock:
            self._started = False

    def get_json(self) -> dict:
        out = self.counters.snapshot()
        out.update(workers=self.workers, mode=self.mode,
                   active=self.active, max_retries=self.max_retries,
                   transport=self.transport)
        if self.transport == "ring" and self._procs:
            ring = {"msgs_sent": 0, "bytes_sent": 0, "msgs_recv": 0,
                    "bytes_recv": 0, "full_waits": 0, "torn_slots": 0}
            for w in self._procs:
                cs = getattr(w.cmd, "counters", None)
                rs = getattr(w.res, "counters", None)
                if cs:
                    ring["msgs_sent"] += cs["msgs"]
                    ring["bytes_sent"] += cs["bytes"]
                    ring["full_waits"] += cs["full_waits"]
                if rs:
                    ring["msgs_recv"] += rs["msgs"]
                    ring["bytes_recv"] += rs["bytes"]
                    ring["torn_slots"] += rs["torn_slots"]
            out["ring"] = ring
        return out

    # -- window lifecycle (called under the chain lock) --------------------

    def begin_window(self, spec, parent_ledger, on_fold=None) -> SpecSession:
        self.start()
        with self._slock:
            self._window_seq += 1
            session = SpecSession(self, spec, parent_ledger,
                                  self._window_seq, on_fold=on_fold)
            self.session = session
        self.counters.add("windows")
        if self.mode == "process":
            scalars = spec.view.snapshot_scalars()
            for w in self._procs:
                w.delta_sent = 0
                w.send(("win", session.window_id, scalars))
        return session

    def dispatch(self, session: SpecSession, tx, origin: str) -> bool:
        """Enqueue one accepted tx for parallel speculation. Caller
        holds the chain lock (index allocation is the total order).
        Returns False when the executor cannot take it (stopped, window
        closed, committer crashed, or worker pool dead) — the caller
        falls back to the serial inline path after ending the window."""
        if self._stopping or self._failed or session.closed:
            return False
        if self.mode == "process" and not any(w.alive for w in self._procs):
            return False
        if tx.tx_type in HEADER_TYPES or session.spec.disabled:
            return True  # serial parity: these are never speculated
        txid = tx.txid()
        if txid in session.seen or txid in session.spec.records:
            return True  # dup submit: already scheduled this window
        index = session.spec.alloc_index()
        task = _Task(index, tx, origin)
        with session.lock:
            # indexes are allocated under the chain lock in dispatch
            # order, so the task list stays index-aligned
            assert index == len(session.tasks), "index/task misalignment"
            session.tasks.append(task)
            session.seen.add(txid)
            session.pending.append(index)
            session.cv.notify()
        self.counters.add("dispatched")
        tr = self.tracer
        if tr.enabled and tr.sampled(txid):
            tr.instant("spec.dispatch", "spec", txid=txid,
                       index=index, origin=origin)
        if self.mode == "process":
            self._wake()
        return True

    def _wake(self) -> None:
        """Poke the committer through the self-pipe (a single byte; no
        locks held — safe from the submit thread under the chain lock).
        EAGAIN means a wake is already pending: coalesced, done."""
        try:
            os.write(self._wake_w, b"x")
        except (BlockingIOError, OSError):
            pass

    def drain(self, session: SpecSession, timeout: float,
              force: bool = True) -> bool:
        """Wait for every dispatched task to commit. With ``force``
        (the close-side call), a timeout completes the window inline:
        the remaining tasks run serially in index order on THIS thread —
        the close never waits on a wedged pool. Advisory callers
        (pre-close drain outside the chain lock) pass force=False."""
        deadline = time.perf_counter() + max(0.0, timeout)
        self._pump(session)
        while True:
            with session.lock:
                if session.complete():
                    return True
                # waiting is pointless when nothing can make progress:
                # manual mode has no workers at all, a crashed committer
                # will never drive another commit, and a fully-dead
                # process pool will never deliver another result — go
                # straight to the serial completion instead of burning
                # the whole timeout window
                stalled = self.mode == "manual" or self._failed or (
                    self.mode == "process"
                    and not any(w.alive for w in self._procs)
                )
                if not stalled:
                    remaining = deadline - time.perf_counter()
                    if remaining > 0:
                        session.cv.wait(min(remaining, 0.05))
            if stalled or time.perf_counter() >= deadline:
                break
            self._pump(session)
        if not force:
            return False
        self.counters.add("drains_forced")
        self._force_serial(session)
        return True

    def end_window(self, session: SpecSession, timeout: float = None) -> None:
        """Drain + seal the window: after this returns no commit can
        mutate the SpecState, so the close may consume it."""
        self.drain(session,
                   self.drain_timeout_s if timeout is None else timeout)
        with session.commit_lock:   # waits out any in-flight commit
            session.closed = True
        with self._slock:
            if self.session is session:
                self.session = None
        if self.mode == "process":
            for w in self._procs:
                w.send(("end", session.window_id))

    # -- execution (workers) -----------------------------------------------

    def _thread_worker_loop(self, wid: int) -> None:
        while not self._stopping:
            with self._slock:
                session = self.session
            if session is None:
                time.sleep(0.005)
                continue
            with session.lock:
                if not session.pending:
                    session.cv.wait(0.05)
                    continue
                index = session.pending.popleft()
                task = session.tasks[index]
                task.state = RUNNING
            self._execute_inproc(session, task, wid)
            self._pump(session)

    def _execute_inproc(self, session: SpecSession, task: _Task,
                        wid) -> None:
        """Thread/manual-mode execution: an _ExecView over the SHARED
        committed view. Reads are optimistic — a commit mutating the
        overlay mid-read can tear, and validation (or the exception
        handler here) catches it."""
        t0 = time.perf_counter()
        try:
            view = _ExecView.over(session.view)
            view.begin_tx(task.txid)
            rec = execute_record(view, task.tx, task.origin)
            task.rec, task.error = rec, None
        except Exception as exc:  # noqa: BLE001 — torn optimistic read
            # or a genuine transactor bug; retry decides downstream
            task.rec, task.error = None, repr(exc)
        task.exec_span = (t0, time.perf_counter(), wid)
        self.counters.add("executed")
        with session.lock:
            task.state = READY
            session.cv.notify_all()

    # -- process transport (parent side) -----------------------------------

    def _assign_procs(self, session: SpecSession) -> None:
        """Hand pending tasks to workers by ACCOUNT AFFINITY, in index
        order, chunked up to exec_batch per message: one account's
        sequence chain always executes on one worker, where the
        journaled tentative chaining makes dependent neighbors see their
        predecessors — cross-worker aborts are left for genuine
        cross-account conflicts. Never assigns past the execution
        horizon (a replica only carries committed deltas, so execution
        far ahead of the commit frontier would re-run wholesale), and a
        saturated worker's tasks stay pending rather than spilling to a
        foreign worker. Serialized by _assign_lock: concurrent assigners
        (committer loop vs a drain caller's retry path) would interleave
        pending-pops and send one worker's chunks out of index order.
        _assign_lock is NOT reentrant, so a mid-assignment send failure
        is handled here, after the locked pass returns: requeue the
        casualty's tasks, recompute the live set, and assign again."""
        while True:
            live = [w for w in self._procs if w.alive]
            if not live:
                return
            with self._assign_lock:
                failed = self._assign_procs_locked(session, live)
            if not failed:
                return
            for w in failed:
                self.counters.add("worker_deaths")
                self._requeue_inflight(w, session)

    def _assign_procs_locked(self, session: SpecSession, live) -> list:
        failed: list = []
        budget = {
            id(w): 2 * self.exec_batch - w.outstanding for w in live
        }
        chunks: dict[int, list[_Task]] = {}
        leftover: list[int] = []
        with session.lock:
            while (session.pending
                   and (session.pending[0] - session.next_commit
                        < self.exec_horizon)):
                index = session.pending.popleft()
                task = session.tasks[index]
                w = live[task.owner % len(live)]
                chunk = chunks.setdefault(id(w), [])
                if budget[id(w)] <= 0 or len(chunk) >= self.exec_batch:
                    leftover.append(index)
                    continue
                budget[id(w)] -= 1
                task.state = RUNNING
                chunk.append(task)
            if leftover:
                session.pending.extendleft(reversed(leftover))
        for w in live:
            chunk = chunks.get(id(w))
            if not chunk:
                continue
            items = []
            retrying = False
            for task in chunk:
                if task.blob is None:
                    task.blob = task.tx.serialize()
                if task.attempts:
                    retrying = True
                items.append((task.index, task.blob, task.sig_good,
                              task.origin, task.attempts))
            w.outstanding += len(chunk)
            # committed-writer deltas ship ONLY with retry chunks: the
            # account-affinity schedule means a first execution reads
            # its own chain (tentatively present) and otherwise the
            # parent — if a cross-account conflict makes that stale,
            # commit validation catches it and the RETRY re-executes
            # against a replica brought fully current here. Shipping
            # (and worker-side applying) every commit to every worker
            # costs more than the rare retry it would prevent.
            ok = False
            if w.alive:
                try:
                    with w.send_lock:
                        deltas = ()
                        if retrying:
                            dlog = session.delta_log
                            deltas = dlog[w.delta_sent:]
                            w.delta_sent = len(dlog)
                        w.cmd.send(("exec", session.window_id, deltas,
                                    items))
                    if deltas:
                        self.counters.add("deltas_sent", len(deltas))
                    ok = True
                except (OSError, ValueError, BrokenPipeError):
                    w.alive = False
            if not ok:
                w.outstanding -= len(chunk)
                failed.append(w)
        return failed

    def _committer_loop(self) -> None:
        """THE parent-side pipeline thread (process mode): multiplexes
        every worker's result pipe plus the dispatch self-pipe, answers
        parent-state reads, records results, drives ordered commits and
        chunk assignment — all on one thread, so the steady state has no
        cross-thread handoffs to pay for."""
        from multiprocessing.connection import wait as conn_wait

        while not self._stopping:
            by_conn = {w.res: w for w in self._procs if w.alive}
            if not by_conn:
                break
            try:
                ready = conn_wait(list(by_conn) + [self._wake_r],
                                  timeout=0.1)
            except OSError:
                break
            with self._slock:
                session = self.session
            progressed = False
            try:
                for conn in ready:
                    if conn == self._wake_r:
                        try:
                            os.read(self._wake_r, 4096)
                        except (BlockingIOError, OSError):
                            pass
                        progressed = True
                        continue
                    w = by_conn[conn]
                    try:
                        msg = conn.recv()
                    except (EOFError, OSError) as exc:
                        # guard: the same worker may already have been
                        # discovered dead this iteration via a failed
                        # send
                        if w.alive:
                            w.alive = False
                            self.counters.add("worker_deaths")
                            # a torn ring slot (CRC/framing mismatch)
                            # retires the connection exactly like a
                            # death, but the distinction matters when
                            # debugging: spec.ring.torn means corrupt
                            # shared memory, spec.ring.dead a lost peer
                            if self.transport == "ring":
                                torn = (type(exc).__name__
                                        == "TornSlotError")
                                self.tracer.instant(
                                    "spec.ring.torn" if torn
                                    else "spec.ring.dead",
                                    "spec", error=str(exc)[:120],
                                )
                            if session is not None:
                                self._fail_worker(w, session)
                        continue
                    progressed = self._handle_worker_msg(session, w, msg) \
                        or progressed
                if progressed and session is not None:
                    self._pump(session)
                    self._assign_procs(session)
            except Exception:  # noqa: BLE001 — ANY commit-machinery
                # failure (the fold-ordering assertion, a bug in
                # message handling, a corrupt pipe unpickling in
                # recv — anything beyond the clean worker-EOF path)
                # must not silently kill this thread and leave every
                # later close burning its full drain timeout: log
                # LOUDLY, flag the executor failed (dispatch refuses,
                # drain goes straight to serial completion) and stop
                # driving — the node degrades to the serial path
                log.exception(
                    "spec committer crashed; degrading to serial "
                    "speculation"
                )
                self.counters.add("committer_errors")
                self._failed = True
                if session is not None:
                    with session.lock:
                        session.cv.notify_all()
                return

    def _handle_worker_msg(self, session, w: _Proc, msg) -> bool:
        """-> True when the message may have unblocked commits or
        assignment (a result batch or a dispatch wake)."""
        kind = msg[0]
        if kind in ("r", "s"):
            _k, wid, key = msg
            data = None
            if session is not None and wid == session.window_id:
                self.counters.add("reads_served")
                if kind == "r":
                    item = session.parent_ledger.state_map.get(key)
                    data = item.data if item is not None else None
                else:
                    item = session.parent_ledger.state_map.succ(key)
                    data = item.tag if item is not None else None
            was_alive = w.alive
            if not w.send(("rr" if kind == "r" else "sr", data)) \
                    and was_alive:
                # undeliverable reply: the worker is wedged waiting for
                # it, so its in-flight tasks will never produce results
                # — requeue them now instead of burning the close's
                # whole drain timeout
                self.counters.add("worker_deaths")
                if session is not None:
                    self._fail_worker(w, session)
            return False
        if kind == "resb":
            _k, wid, results = msg
            # under _assign_lock: the increment in _assign_procs_locked
            # and this decrement are read-modify-writes from different
            # threads — unsynchronized, a lost decrement would skew the
            # worker's budget upward until it starves
            with self._assign_lock:
                w.outstanding = max(0, w.outstanding - len(results))
            if session is None or wid != session.window_id:
                return False
            n = 0
            with session.lock:
                for index, t0, t1, err, payload, attempt in results:
                    task = session.tasks[index]
                    if task.state != RUNNING \
                            or attempt != task.attempts:
                        # superseded: drain/retry, or a stale execution
                        # instance (the task was requeued after a worker
                        # loss and re-issued under a NEWER attempt —
                        # accepting the old result here would let its
                        # epoch collide with another instance's
                        # tentative chain on a different worker)
                        continue
                    task.wire, task.error = payload, err
                    task.exec_span = (t0, t1, w.proc.name)
                    task.state = READY
                    n += 1
                session.cv.notify_all()
            if n:
                self.counters.add("executed", n)
            return True
        return False

    def _fail_worker(self, w: _Proc, session: SpecSession) -> None:
        """A worker died: its in-flight tasks go back to pending (their
        results will never arrive) and the survivors pick them up; the
        drain's serial completion covers a fully-dead pool. Must be
        called WITHOUT _assign_lock held (the reassignment takes it)."""
        w.alive = False
        self._requeue_inflight(w, session)
        self._assign_procs(session)

    def _requeue_inflight(self, w: _Proc, session: SpecSession) -> None:
        with session.lock:
            # reversed so the appendlefts leave pending index-sorted
            # (in-flight indexes are all below the pending head)
            for task in reversed(session.tasks):
                if task.state == RUNNING and task.wire is None \
                        and task.error is None:
                    task.state = PENDING
                    # a NEW execution instance: a still-in-flight result
                    # from the old assignment (this requeue is
                    # conservative — it also re-pends tasks running on
                    # survivors) is dropped by the resb attempt check,
                    # so two instances of one task can never both land
                    # and their epoch-tagged tentative chains can never
                    # cross-validate
                    task.attempts += 1
                    session.pending.appendleft(task.index)
            session.cv.notify_all()

    # -- manual mode (deterministic test schedules) ------------------------

    def step(self, session: SpecSession, index: int) -> None:
        """Execute task `index` synchronously on this thread against the
        CURRENT committed state (manual mode). Tests call this in seeded
        orders to replay conflict interleavings deterministically."""
        with session.lock:
            task = session.tasks[index]
            if task.state not in (PENDING, RUNNING):
                return
            if index in session.pending:
                session.pending.remove(index)
            task.state = RUNNING
        self._execute_inproc(session, task, "manual")

    def pump(self, session: SpecSession) -> None:
        """Drive ordered commits over whatever candidates are ready."""
        self._pump(session)

    # -- ordered commit ----------------------------------------------------

    def _pump(self, session: SpecSession) -> None:
        while True:
            if not session.commit_lock.acquire(blocking=False):
                return  # the holder re-checks the frontier on release
            task = None
            try:
                if session.closed:
                    return
                with session.lock:
                    if session.next_commit < len(session.tasks):
                        cand = session.tasks[session.next_commit]
                        if cand.state == READY:
                            task = cand
                if task is not None:
                    self._commit_one(session, task)
            finally:
                session.commit_lock.release()
            if task is not None:
                continue
            # the frontier was not READY while we held commit_lock — but
            # a concurrent setter may have made it READY after our check
            # and had ITS try-acquire fail against us. Re-check now that
            # we've released: if it is READY, loop and commit it; if the
            # window is quiet, whoever flips it next pumps successfully.
            with session.lock:
                if (session.closed
                        or session.next_commit >= len(session.tasks)
                        or session.tasks[session.next_commit].state
                        != READY):
                    return

    def _force_serial(self, session: SpecSession) -> None:
        """Complete the window inline: every uncommitted task executes
        serially, in index order, against the committed view (the
        drain's close-side guarantee)."""
        with session.commit_lock:
            if session.closed:
                return
            while True:
                with session.lock:
                    if session.complete():
                        return
                    task = session.tasks[session.next_commit]
                    if task.state in (PENDING, RUNNING):
                        task.state = READY
                        task.rec, task.wire = None, None
                        task.error = "drain_forced"
                        if task.index in session.pending:
                            session.pending.remove(task.index)
                self._commit_one(session, task)

    def _candidate(self, task: _Task) -> Optional[tuple]:
        """-> (rec, retained) from whichever transport produced it."""
        if task.rec is not None:
            rec = task.rec
            return rec, not (rec.did_apply and rec.meta is None)
        if task.wire is not None:
            return _unwire_record(task.wire)
        return None

    def _commit_one(self, session: SpecSession, task: _Task) -> None:
        """Validate-or-retry-or-serial-fallback, then commit, in index
        order. Caller holds session.commit_lock; NEVER the chain lock."""
        tr = self.tracer
        t0 = time.perf_counter()
        spec = session.spec
        rec = retained = None
        cand = None if task.error is not None else self._candidate(task)
        if cand is not None:
            rec, retained = cand
            if task.exec_span is not None and tr.enabled \
                    and tr.sampled(task.txid):
                e0, e1, wid = task.exec_span
                tr.complete("spec.exec", "spec", e0, e1, txid=task.txid,
                            index=task.index, worker=str(wid),
                            attempt=task.attempts)
            if not self._validate(session, rec,
                                  epochal=task.rec is None):
                self.counters.add("validation_aborts")
                cand = rec = None  # stale execution
        if cand is None:
            # no candidate (exec error / worker loss) or a stale one
            if task.error is None and task.attempts < self.max_retries:
                task.attempts += 1
                self.counters.add("retries")
                if tr.enabled and tr.sampled(task.txid):
                    tr.instant("spec.retry", "spec", txid=task.txid,
                               index=task.index, attempt=task.attempts)
                with session.lock:
                    task.state = PENDING
                    task.rec = task.wire = None
                    # retries go to the FRONT: the task is the commit
                    # frontier itself, and pending stays index-sorted
                    session.pending.appendleft(task.index)
                    session.cv.notify_all()
                if self.mode == "process":
                    self._assign_procs(session)
                return
            if task.error is not None and task.error != "drain_forced":
                self.counters.add("exec_errors")
            # serial fallback: execute against the committed view itself
            # — the serial path, valid by construction. speculate() bakes
            # the writes into the overlay and retains the record (or
            # poisons the overlay on an execution exception, exactly the
            # serial semantics).
            self.counters.add("serial_fallbacks")
            rec = spec.speculate(task.tx, origin=task.origin,
                                 index=task.index)
            retained = rec is not None and spec.records.get(task.txid) is rec
            if rec is not None:
                self._finish_commit(session, task, rec, retained,
                                    serial=True)
            else:
                with session.lock:
                    task.state = SKIPPED
                    session.next_commit += 1
                    session.cv.notify_all()
            if tr.enabled and tr.sampled(task.txid):
                tr.complete("spec.validate", "spec", t0,
                            time.perf_counter(), txid=task.txid,
                            index=task.index, outcome="serial_fallback")
            return
        # optimistic candidate validated: fold it into the committed view
        # (applied=False for the kept-no-record case — the serial path's
        # incomplete commit tail bakes the writes but never reaches
        # record_transaction, so the tx-map membership must not either)
        rec.index = task.index
        if task.rec is None:
            # process record: normalize the (txid, attempt) epochs back
            # to the bare txids the close's splice validation consumes
            rec.reads = {
                k: (w[0] if type(w) is tuple else w)
                for k, w in rec.reads.items()
            }
        session.view.apply_record(task.txid, rec.write_items,
                                  rec.did_apply and retained)
        if retained:
            spec.records[task.txid] = rec
        self._finish_commit(session, task, rec, retained, serial=False)
        if tr.enabled and tr.sampled(task.txid):
            tr.complete("spec.validate", "spec", t0, time.perf_counter(),
                        txid=task.txid, index=task.index,
                        outcome="commit", attempts=task.attempts)

    def _finish_commit(self, session: SpecSession, task: _Task, rec,
                       retained: bool, serial: bool) -> None:
        spec = session.spec
        if retained:
            self.counters.add("committed")
            if spec.building is not None:
                folded = spec.fold_building(rec)
                if folded and session.on_fold is not None:
                    session.on_fold(folded)
        else:
            # kept-no-record: the writes are already in the overlay
            # (apply_record on the worker path, speculate() on the
            # serial one) — only the record itself is withheld
            self.counters.add("no_records")
        if self.mode == "process" and rec.write_items:
            pairs = [(k, it.data if it is not None else None)
                     for k, it in rec.write_items]
            # the committed created-set delta is authoritative for the
            # worker replicas (they never probe the parent for existence)
            added, removed = self._created_delta(session, rec)
            # the committed epoch: the attempt whose execution produced
            # this record, or -1 for a serial (committed-view) execution
            # — tentative same-txid values from OTHER attempts can never
            # validate against it
            epoch = -1 if serial else task.attempts
            for k, _it in rec.write_items:
                session.writer_epoch[k] = (task.txid, epoch)
            session.delta_log.append(
                (task.index, task.txid, pairs, added, removed,
                 rec.did_apply and retained, epoch)
            )
        with session.lock:
            task.state = COMMITTED if retained else SKIPPED
            task.rec = rec if retained else None
            task.wire = None
            session.next_commit += 1
            session.cv.notify_all()
        # no per-commit assignment: the generous horizon means commits
        # rarely release gated work, and the committer loop assigns on
        # every dispatch wake and result batch anyway — an extra
        # session.lock acquisition per commit just contends with the
        # submit thread. The retry path assigns explicitly (latency).

    def _created_delta(self, session: SpecSession, rec) -> tuple:
        """(created_added, created_removed) for one committed record, as
        observed in the committed view AFTER application."""
        view = session.view
        added, removed = [], []
        for k, it in rec.write_items:
            if it is None:
                removed.append(k)
            elif k in view._created_set:
                added.append(k)
        return added, removed

    def _validate(self, session: SpecSession, rec,
                  epochal: bool) -> bool:
        """The commit-time read validation — the same provenance +
        succ-reproduction test the close's try_splice applies. Process
        records carry (txid, attempt) epochs and validate against the
        session's epoch map (a read of an aborted attempt's tentative
        value must never pass); thread/manual records read the live
        committed view and validate against its bare-txid writers."""
        writers = session.writer_epoch if epochal else session.view._writers
        for k, wid in rec.reads.items():
            if writers.get(k, PARENT) != wid:
                return False
        for cursor, tag in rec.succs:
            item = session.view.resolve_succ(cursor)
            if (item.tag if item is not None else None) != tag:
                return False
        return True
