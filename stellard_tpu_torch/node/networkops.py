"""NetworkOPs: the application brain.

Reference: src/ripple_app/misc/NetworkOPs.cpp (2923 LoC) — operating-mode
state machine (NetworkOPs.h:76-84), transaction submission/processing
(:274-558), standalone ledger close (acceptLedger), and the pub/sub
fan-out (pubLedger / pubProposedTransaction / pubAcceptedTransaction).

TPU shape: signature checks route through the VerifyPlane (coalesced
device batches) with HashRouter SF_SIGGOOD/SF_BAD memoization, so the
apply path under the master lock never re-verifies.
"""

from __future__ import annotations

import logging
import threading
import time
from enum import IntEnum
from typing import Callable, Optional

from ..crypto.backend import VerifyRequest
from ..engine.engine import TxParams
from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from ..state.ledger import Ledger
from .hashrouter import SF_BAD, SF_RELAYED, SF_SIGGOOD, HashRouter
from .jobqueue import JobQueue, JobType

log = logging.getLogger("stellard.netops")
from .ledgermaster import LedgerMaster
from .verifyplane import VerifyPlane

__all__ = ["NetworkOPs", "OperatingMode", "TxStatus"]

# seconds between 1970-01-01 and 2000-01-01 (reference: iToSeconds /
# NetClock epoch) — ledger close times are seconds since 2000.
EPOCH_OFFSET = 946_684_800


class OperatingMode(IntEnum):
    """reference: NetworkOPs.h:76-84"""

    DISCONNECTED = 0
    CONNECTED = 1
    SYNCING = 2
    TRACKING = 3
    FULL = 4


class TxStatus(IntEnum):
    """reference: Transaction.h TransStatus"""

    NEW = 0
    INVALID = 1
    INCLUDED = 2
    CONFLICTED = 3
    COMMITTED = 4
    HELD = 5
    REMOVED = 6
    OBSOLETE = 7
    INCOMPLETE = 8


class NetworkOPs:
    def __init__(
        self,
        ledger_master: LedgerMaster,
        job_queue: JobQueue,
        verify_plane: VerifyPlane,
        hash_router: HashRouter,
        standalone: bool = True,
        fee_track=None,
        tracer=None,
        txq=None,
    ):
        from .tracer import get_tracer

        self.lm = ledger_master
        self.jq = job_queue
        self.vp = verify_plane
        self.router = hash_router
        self.tracer = tracer if tracer is not None else get_tracer()
        self.fee_track = fee_track  # loadmgr.LoadFeeTrack or None
        # admission-control plane ([txq], node/txq.py): post-verify
        # intake routes through TxQ.admit when enabled — soft open-
        # ledger cap, escalating fee, fee-priority queue (terQUEUED);
        # enabled=0 (or None) is the legacy direct-apply path
        self.txq = txq
        self.standalone = standalone
        self.mode = OperatingMode.FULL if standalone else OperatingMode.DISCONNECTED
        self.master_lock = threading.RLock()  # reference: getApp().getMasterLock()
        self.net_time_offset = 0
        # networked-mode seams (wired by Node when an overlay exists):
        # relay an applied client tx to peers (excluding the suppression
        # peer-id set it arrived from) / track it for re-apply across
        # rounds (reference: processTransaction relay step + LocalTxs
        # client-submit tracking)
        # read plane (rpc/readplane.py, wired by Node): the serving
        # side's immutable validated-snapshot pointer — publish hands it
        # each closed ledger so read RPCs resolve "validated" without
        # ever taking the chain lock
        self.read_plane = None
        self.relay_tx: Optional[
            Callable[[SerializedTransaction, set[int]], None]
        ] = None
        self.local_push: Optional[Callable[[int, SerializedTransaction], None]] = None
        # pub/sub sinks (wired by InfoSub manager; reference NetworkOPsImp
        # mSubLedger / mSubTransactions / ...)
        self.on_ledger_closed: list[Callable[[Ledger, dict], None]] = []
        self.on_proposed_tx: list[Callable[[SerializedTransaction, TER], None]] = []
        # bounded status map (insertion-ordered; oldest evicted) — the
        # HashRouter equivalent of this sweeps on a hold timer
        self.on_tx_result: dict[bytes, TxStatus] = {}
        self.max_tx_results = 100_000
        self.stats = {"processed": 0, "bad_sig": 0, "held": 0}
        # ordered intake (see _enqueue_intake)
        self._intake: list = []
        self._intake_lock = threading.Lock()
        self._intake_scheduled = False

    # -- time (reference: getNetworkTimeNC via SNTP offset) ---------------

    def network_time(self) -> int:
        return int(time.time()) - EPOCH_OFFSET + self.net_time_offset

    # -- transaction intake ----------------------------------------------

    def submit_transaction(
        self, tx: SerializedTransaction, cb: Optional[Callable] = None
    ) -> None:
        """Async submission: verify (coalesced) off the master lock, then
        process on a jtTRANSACTION job (reference:
        NetworkOPs::submitTransaction :274-321)."""
        # relay backlog shed (reference: PeerImp.cpp:64-66 — drop new
        # network transactions outright past a 100-job backlog). A caller
        # that asked for a result still gets one (telINSUF_FEE_P: transient
        # local overload, resubmittable) so local clients never hang.
        from .loadmgr import TX_BACKLOG_SHED

        # intake backlog counts toward the shed gate: batching collapses
        # the queue to at most one jtTRANSACTION job, so the job count
        # alone no longer reflects a flood (the drain queue does)
        if (self.jq.get_job_count(JobType.jtTRANSACTION)
                + len(self._intake)) > TX_BACKLOG_SHED:
            self.stats["shed"] = self.stats.get("shed", 0) + 1
            if cb:
                cb(tx, TER.telINSUF_FEE_P, False)
            return
        txid = tx.txid()
        tr = self.tracer
        # root of the transaction's causal span tree (trace id = txid):
        # every later stage — verify wait, intake process, open apply,
        # close splice/fallback, persist — links back to this span
        sub = tr.begin("submit", "submit", txid=txid)
        flags = self.router.get_flags(txid)
        if flags & SF_BAD:
            tr.end(sub, outcome="known_bad")
            if cb:
                cb(tx, TER.temINVALID, False)
            return
        if flags & SF_SIGGOOD:
            tx.set_sig_verdict(True)
            tr.end(sub, outcome="cached_sig")
            self._enqueue_intake(tx, cb, parent=sub)
            return
        # cross-thread span: begins here, ends on the verify plane's
        # flusher thread when the coalesced batch completes the future
        vtok = tr.begin("verify.wait", "verify", txid=txid, parent=sub)
        tr.end(sub, outcome="verify_queued")
        fut = self.vp.submit(
            VerifyRequest(tx.signing_pub_key, tx.signing_hash(), tx.signature)
        )

        def when_done(f):
            exc = f.exception()
            if exc is not None:
                # the verify plane failed (K1 did not build or launch, or
                # the card is wedged): that is no verdict on the
                # signature, so nothing is cached against the txid and
                # the caller gets a local, retriable error
                tr.end(vtok, error=repr(exc))
                self.stats["verify_errors"] = self.stats.get("verify_errors", 0) + 1
                log.error("submit %s: the verify plane failed: %r", txid.hex(), exc)
                if cb:
                    cb(tx, TER.telLOCAL_ERROR, False)
                return
            good = bool(f.result())
            tr.end(vtok, good=good)
            tx.set_sig_verdict(good)
            self.router.set_flag(txid, SF_SIGGOOD if good else SF_BAD)
            if not good:
                self.stats["bad_sig"] += 1
                if cb:
                    cb(tx, TER.temINVALID, False)
                return
            self._enqueue_intake(tx, cb, parent=vtok)

        fut.add_done_callback(when_done)

    def _enqueue_intake(self, tx, cb, parent=None) -> None:
        """Ordered intake: verified txs drain FIFO under ONE
        jtTRANSACTION job at a time. One job per tx let the worker pool
        race same-account bursts out of sequence order — a 3000-tx
        single-account flood scrambled ~80% of itself into terPRE_SEQ
        holds (and each close then re-walked the held pile). The verify
        plane completes futures in submission order, so a FIFO drain
        preserves the client's order end-to-end; it also amortizes job
        dispatch across the batch. (reference: per-tx jtTRANSACTION
        jobs work there because holds are rare on real traffic; the
        coalescing verify plane makes bursts the NORM here.)"""
        with self._intake_lock:
            self._intake.append((tx, cb, parent))
            if self._intake_scheduled:
                return
            self._intake_scheduled = True
        if not self.jq.add_job(
            JobType.jtTRANSACTION, "processTxBatch", self._drain_intake
        ):
            # queue refused (stopping): never strand the flag set with no
            # drain coming — fail the queued callers resubmittably
            with self._intake_lock:
                stranded = list(self._intake)
                self._intake.clear()
                self._intake_scheduled = False
            for s_tx, s_cb, _par in stranded:
                if s_cb:
                    s_cb(s_tx, TER.telINSUF_FEE_P, False)

    def _drain_intake(self) -> None:
        try:
            while True:
                with self._intake_lock:
                    if not self._intake:
                        return
                    batch = list(self._intake)
                    self._intake.clear()
                for tx, cb, parent in batch:
                    try:
                        self._process_cb(tx, cb, parent)
                    except Exception:  # noqa: BLE001 — one bad tx must not
                        # drop the rest of the batch (the per-tx-job design
                        # this replaces lost only the failing tx)
                        log.exception("intake: processing failed for %s",
                                      tx.txid().hex()[:16])
        finally:
            # ALWAYS release the schedule flag — an exception escaping the
            # loop (or the jobqueue killing the job) must not wedge intake
            # forever; reschedule if arrivals raced the drain's exit
            resched = False
            with self._intake_lock:
                self._intake_scheduled = False
                if self._intake:
                    self._intake_scheduled = True
                    resched = True
            if resched and not self.jq.add_job(
                JobType.jtTRANSACTION, "processTxBatch", self._drain_intake
            ):
                # queue refused (stopping): fail the stranded callers
                # resubmittably instead of hanging them (same contract
                # as _enqueue_intake's refusal path)
                with self._intake_lock:
                    stranded = list(self._intake)
                    self._intake.clear()
                    self._intake_scheduled = False
                for s_tx, s_cb, _par in stranded:
                    if s_cb:
                        s_cb(s_tx, TER.telINSUF_FEE_P, False)

    def _process_cb(self, tx, cb, parent=None):
        # the process span parents the open-apply/speculation spans
        # recorded inside do_transaction (same thread, tls stack)
        with self.tracer.span("process", "submit", txid=tx.txid(),
                              parent=parent):
            ter, applied = self.process_transaction(tx)
        if cb:
            cb(tx, ter, applied)

    def _plane_check_sign(self, tx: SerializedTransaction) -> bool:
        """Synchronous single-tx verification THROUGH the routed verify
        plane (the RPC submit path). Before this, process_transaction
        verified inline via tx.check_sign(), bypassing the plane
        entirely — a mesh-enabled node could serve a whole RPC flood
        with device_sigs frozen at 0 and no routing/latency evidence.
        The plane's cost model sends a 1-sig batch to the host arm
        (same verify_signature underneath), so the common case costs
        what check_sign did; forced-device mode and big resubmit
        sweeps ride the configured kernel."""
        ok = bool(self.vp.verify_many(
            [VerifyRequest(tx.signing_pub_key, tx.signing_hash(),
                           tx.signature)]
        )[0])
        tx.set_sig_verdict(ok)
        return ok

    def process_transaction(
        self, tx: SerializedTransaction, admin: bool = False
    ) -> tuple[TER, bool]:
        """Synchronous path (reference: NetworkOPs::processTransaction
        :444-558): router flags → checkSign (memoized / pre-batched) →
        apply to open ledger under the master lock → status bookkeeping
        → relay."""
        txid = tx.txid()
        flags = self.router.get_flags(txid)
        if flags & SF_BAD:
            self._record_status(txid, TxStatus.INVALID)
            return TER.temINVALID, False
        if flags & SF_SIGGOOD:
            tx.set_sig_verdict(True)
        elif not self._plane_check_sign(tx):
            self.router.set_flag(txid, SF_BAD)
            self.stats["bad_sig"] += 1
            self._record_status(txid, TxStatus.INVALID)
            return TER.temINVALID, False
        else:
            self.router.set_flag(txid, SF_SIGGOOD)

        params = TxParams.OPEN_LEDGER
        if admin:
            params |= TxParams.ADMIN
        txq = self.txq
        use_txq = txq is not None and txq.enabled
        with self.master_lock:
            if self.fee_track is not None:
                # load-scaled open-ledger fee: Transactor::payFee reads the
                # ledger's load_factor (reference: scaleFeeLoad via
                # LoadFeeTrack) and rejects under-payers with telINSUF_FEE_P.
                # The NETWORK floor only (local + remote) — never the queue
                # escalation component: TxQ.admit already prices admission,
                # and folding it here would double-gate — the stamped value
                # rides open_successor into the next window, where payFee
                # would reject the very txs the queue is promoting
                # (telINSUF_FEE_P -> retriable -> promotion starves).
                self.lm.current_ledger().load_factor = self.fee_track.network_floor
            if use_txq:
                # admission control: soft open-ledger cap + escalating
                # fee; under-payers above the cap queue (terQUEUED) or
                # shed, terPRE_SEQ holds fold into the queue fee-ordered
                ter, did_apply = txq.admit(tx, self.lm, params)
            else:
                ter, did_apply = self.lm.do_transaction(tx, params)
        self.stats["processed"] += 1

        # status bookkeeping (reference :500-533). Only tem (malformed) is
        # permanently bad — tel (transient local, e.g. telINSUF_FEE_P under
        # load) and tef must stay resubmittable.
        if ter == TER.tesSUCCESS or did_apply:
            status = TxStatus.INCLUDED
        elif ter.is_tem:
            status = TxStatus.INVALID
            self.router.set_flag(txid, SF_BAD)
        elif ter == TER.terQUEUED:
            # waiting in the admission queue for a later ledger
            status = TxStatus.HELD
            self.stats["queued"] = self.stats.get("queued", 0) + 1
        elif ter == TER.terPRE_SEQ:
            # future sequence: hold for the next ledger (reference
            # :516-524). With the TxQ enabled admit() already queued or
            # shed it and never returns terPRE_SEQ from this path.
            if not use_txq:
                self.lm.add_held_transaction(tx)
            status = TxStatus.HELD
            self.stats["held"] += 1
        else:
            status = TxStatus.INVALID if int(ter) < 0 else TxStatus.INCLUDED
        self._record_status(txid, status)

        for sink in self.on_proposed_tx:
            sink(tx, ter)

        # relay seam (overlay broadcast; no-op in standalone). The
        # SF_RELAYED flag is only CONSUMED when the tx actually applied:
        # a transiently-failing submission (e.g. telINSUF_FEE_P under
        # load) must still relay on its later successful resubmit, while
        # a successful one must not become a per-resubmit broadcast
        # amplifier (swap_set returns newly-set exactly for this gate).
        # A QUEUED tx relays only once it meets the current NETWORK fee
        # floor (other nodes would drop an under-payer anyway); a queued
        # tx below the floor relays when promotion applies it
        # (publish_closed_ledger drains TxQ.drain_relay).
        if not ter.is_tem and (did_apply or ter == TER.terPRE_SEQ):
            self.relay_applied(tx)
        elif ter == TER.terQUEUED and txq is not None and (
            txq.meets_network_floor(tx, self.lm.current_ledger())
        ):
            # a queued tx at the network floor relays, but is NOT
            # LocalTxs-tracked yet: the queue owns its retry, and the
            # validator's LocalTxs re-apply would bypass admission
            # (tracking starts when promotion applies it — see
            # publish_closed_ledger's drain)
            self.relay_applied(tx, track=False)
        return ter, did_apply

    def relay_applied(self, tx: SerializedTransaction,
                      track: bool = True) -> bool:
        """Relay (+ optional local-retry tracking) for a tx this node
        accepted — shared by the submit path and the TxQ promotion
        drain. The SF_RELAYED swap_set gate makes the broadcast
        exactly-once per txid; returns whether THIS call won it."""
        prev_peers, newly = self.router.swap_set(
            tx.txid(), set(), SF_RELAYED
        )
        if newly:
            if self.relay_tx is not None:
                # prev_peers = peers this tx already arrived from;
                # they are excluded from the fan-out
                self.relay_tx(tx, prev_peers)
            if track and self.local_push is not None:
                self.local_push(self.lm.closed_ledger().seq, tx)
        return newly

    # -- standalone close (reference: NetworkOPs::acceptLedger) ------------

    def accept_ledger(self) -> tuple[Ledger, dict[bytes, TER]]:
        """Close the open ledger immediately (standalone `ledger_accept`
        admin RPC; the JS integration tests drive closes this way,
        SURVEY §4.3)."""
        ex = getattr(self.lm, "spec_executor", None)
        if ex is not None and ex.active:
            # advisory pre-drain OUTSIDE the close lock: let in-flight
            # worker speculation commit while submissions can still
            # interleave, so the in-lock drain inside close_and_advance
            # is (usually) a no-op and the lock hold stays at splice
            # cost. Never forces — the close-side drain owns that.
            spec = getattr(self.lm.current, "_spec_state", None)
            session = getattr(spec, "_exec_session", None) if spec else None
            if session is not None:
                ex.drain(session, timeout=1.0, force=False)
                # the drain just landed a burst of building-tree folds;
                # hash them on the background drainer BEFORE the close
                # takes the lock, not inside its seal window (bounded
                # wait — still outside every lock)
                self.lm.kick_seal_drain(wait_s=0.25)
        with self.master_lock:
            if self.fee_track is not None:
                # refresh before close: held-tx retries inside
                # close_and_advance must see the CURRENT load, not the
                # factor stamped by the last submission. NETWORK floor
                # only, same as the submit path: the queue-escalation
                # component must never reach a window payFee gates, or
                # promotion double-prices the txs the queue admits
                self.lm.current_ledger().load_factor = self.fee_track.network_floor
            closed, results = self.lm.close_and_advance(
                close_time=self.network_time(),
                close_resolution=self.lm.closed_ledger().close_resolution,
            )
        self.publish_closed_ledger(closed, results)
        return closed, results

    def publish_closed_ledger(
        self, closed: Ledger, results: dict[bytes, TER]
    ) -> None:
        """Status promotion + ledger-closed sinks, shared by the
        standalone close above and the networked consensus path (the
        WS ledger/transactions streams hang off on_ledger_closed)."""
        if self.txq is not None:
            # promoted txs whose relay waited out the chain lock (and
            # the fee floor) broadcast here, outside the close path —
            # BEFORE the COMMITTED promotion below: a deferred-promoted
            # tx commits in the very close being published, and its
            # HELD->INCLUDED transition must land first or it would
            # stay INCLUDED forever. Promotion applied it, so it always
            # (re-)enters LocalTxs tracking even when the fee floor
            # already relayed it at queue time.
            for tx in self.txq.drain_relay():
                self._record_status(tx.txid(), TxStatus.INCLUDED)
                if not self.relay_applied(tx) and self.local_push is not None:
                    self.local_push(self.lm.closed_ledger().seq, tx)
        for txid, _ter in results.items():
            if self.on_tx_result.get(txid) == TxStatus.INCLUDED:
                self._record_status(txid, TxStatus.COMMITTED)
        for sink in self.on_ledger_closed:
            sink(closed, results)
        if self.read_plane is not None:
            # hand the serving side its persisted-tip floor — AFTER the
            # sinks, so by the time the validated-seq cache opens this
            # epoch the persistence pipeline already holds the ledger's
            # entry and the SQL-index RPCs' read-your-writes wait
            # (_await_history) covers it; in networked mode this whole
            # method runs post-persist on the drain worker. The read
            # plane publishes min(persisted, validated): a degraded
            # solo close never masquerades as validated state, and on a
            # quorum net the epoch opens when the validation floor
            # catches up (LedgerMaster.on_validated -> note_validated).
            self.read_plane.note_persisted(closed)

    def _record_status(self, txid: bytes, status: TxStatus) -> None:
        m = self.on_tx_result
        m.pop(txid, None)
        m[txid] = status
        while len(m) > self.max_tx_results:
            m.pop(next(iter(m)))

    # -- introspection ----------------------------------------------------

    def server_state(self) -> str:
        return {
            OperatingMode.DISCONNECTED: "disconnected",
            OperatingMode.CONNECTED: "connected",
            OperatingMode.SYNCING: "syncing",
            OperatingMode.TRACKING: "tracking",
            OperatingMode.FULL: "full",
        }[self.mode]
