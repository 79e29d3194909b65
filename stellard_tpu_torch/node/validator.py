"""ValidatorNode: the consensus-facing orchestration of one validator —
round lifecycle, peer message handling, and quorum acceptance.

Reference: this is the slice of NetworkOPs that owns consensus
(tryStartConsensus/beginConsensus, NetworkOPs.cpp:741-975; recvValidation
:1668; processTrustedProposal) plus LedgerMaster::checkAccept. It is
transport-agnostic: the deterministic simnet (overlay.simnet) and the
TCP overlay both drive it through the same entry points, mirroring how
the reference tests consensus through testoverlay without sockets.

Device shape: peer validations, proposals and relayed transactions are
signature-checked through the VerifyPlane (K1 on the card) rather than
one libsodium call per message. With no plane wired (``verify_many``
None) they are checked on the host, as the JAX package does.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Optional

from ..consensus.consensus import ConsensusAdapter, LedgerConsensus
from ..consensus.proposal import LedgerProposal
from ..consensus.timing import LEDGER_IDLE_INTERVAL, LEDGER_MIN_CONSENSUS_MS
from ..consensus.txset import TxSet
from ..consensus.validation import STValidation
from ..consensus.validations import ValidationsStore
from ..engine.engine import TxParams
from ..nodestore.shards import SHARD_FILE_BASE
from ..protocol.keys import KeyPair
from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from ..state.ledger import Ledger
from .hashrouter import SF_BAD, SF_SIGGOOD, HashRouter
from .ledgermaster import LedgerMaster

__all__ = ["ValidatorNode"]


def _locked(method):
    """Serialize a ValidatorNode entry point on the master lock (RLock:
    accept callbacks re-enter from within a locked timer tick)."""
    import functools

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self.lock:
            return method(self, *args, **kwargs)

    return wrapper


class ValidatorNode:
    # closed-vs-validated lag (in ledgers) beyond which the node reports
    # itself degraded: it is still CLOSING rounds (closing needs no
    # quorum) but the network is not validating them — an operator must
    # see "tracking", not a confident "proposing/full" from a node whose
    # chain nobody else signs (reference: NetworkOPs::setMode demotes on
    # lost consensus)
    DEGRADE_LAG = 4

    def __init__(
        self,
        key: KeyPair,
        unl: set[bytes],
        adapter: ConsensusAdapter,
        quorum: int,
        network_time: Callable[[], int],
        clock: Callable[[], float] = _time.monotonic,
        hash_batch: Optional[Callable] = None,
        verify_many: Optional[Callable] = None,
        proposing: bool = True,
        idle_interval: int = LEDGER_IDLE_INTERVAL,
        voting=None,
        lock=None,
        router: Optional[HashRouter] = None,
        follower: bool = False,
    ):
        import threading

        # master lock: consensus timer / peer-message threads and the RPC
        # plane mutate the SAME LedgerMaster when this validator backs an
        # application container (reference: getApp().getMasterLock());
        # every public entry point below serializes on it
        self.lock = lock if lock is not None else threading.RLock()
        self.key = key
        self.unl = set(unl) | {key.public}  # we trust ourselves
        self.adapter = adapter
        self.network_time = network_time
        self.clock = clock
        self.hash_batch = hash_batch
        self.verify_many = verify_many  # VerifyPlane.verify_many or None
        self.proposing = proposing and not follower
        # follower mode ([node] mode=follower, ROADMAP item 3): this
        # node NEVER runs consensus rounds — it tails validated-ledger
        # announcements from trusted validators, acquires each validated
        # ledger (bulk GetSegments catch-up + the node-granular tree
        # walk, every record/hash content-verified), and adopts it.
        # The whole read RPC + subscription surface then serves from
        # the ingested chain at wire speed, off the write path.
        self.follower = follower
        self.idle_interval = idle_interval
        self.voting = voting  # consensus.voting.VotingBox or None

        self.lm = LedgerMaster(hash_batch=hash_batch)
        self.lm.min_validations = quorum
        # byzantine-defense counters (`byzantine.*` in get_counts): every
        # hostile input the node recognized and neutralized bumps one of
        # these and emits a `byzantine.<kind>` tracer instant — the
        # anti-vacuity evidence the adversarial scenarios assert on
        from .metrics import AtomicCounters

        self.defense = AtomicCounters(
            "bad_proposal_sig", "bad_validation_sig",
            "conflicting_proposal", "duplicate_proposal",
            "conflicting_validation", "duplicate_validation",
            "stale_validation", "untrusted_validation",
            "oversized_txset", "txset_mismatch", "malformed_frame",
            "garbage_segment",
        )
        # optional sink for per-peer misbehavior bookkeeping (the overlay
        # wires UniqueNodeList.on_byzantine here)
        self.on_byzantine: Optional[Callable[[str, Optional[bytes]], None]] = None
        self.validations = ValidationsStore(
            is_trusted=lambda pk: pk in self.unl, now=network_time
        )
        self.validations.note_byzantine = self.note_byzantine
        # shared with the application container when one embeds this
        # validator: RPC-plane and peer-plane sig verdicts / suppression
        # must be ONE state (reference: a single getApp().getHashRouter())
        self.router = router if router is not None else HashRouter()
        # close-time re-application skips re-verifying SF_SIGGOOD txs
        self.lm.router = self.router
        from .localtxs import LocalTxs

        self.local_txs = LocalTxs()
        # trusted proposer -> (its proposal's prev-ledger hash, seen-at):
        # the peer-LCL votes of the reference's checkLastClosedLedger
        self._peer_prevs: dict[bytes, tuple[bytes, int]] = {}
        self._lcl_candidate: Optional[bytes] = None  # election hysteresis
        self._lcl_acquiring: Optional[bytes] = None  # single-flight catch-up
        # highest trusted-validation seq seen for the pinned target when
        # the session started — the election retargets past a transfer
        # the net has clearly outrun (see _check_lcl)
        self._lcl_acquiring_seq: Optional[int] = None
        self._tick = 0
        # fired for EVERY ledger that becomes our LCL — locally-closed
        # rounds AND catch-up adoptions — so the persistence plane never
        # gaps (reference: pendSaveValidated covers both paths)
        self.on_ledger: list[Callable[[Ledger], None]] = []
        self.round: Optional[LedgerConsensus] = None
        self.prev_proposers = 0
        self.prev_round_ms = LEDGER_MIN_CONSENSUS_MS
        self.rounds_completed = 0
        # peer tx sets seen this round (simnet share / TMHaveTransactionSet)
        self.txset_cache: dict[bytes, TxSet] = {}
        # recent trusted proposals, stashed ACROSS rounds (reference:
        # Consensus::recentPeerPositions_ + playbackProposals): a node
        # that adopts the network LCL mid-round must be able to replay
        # the positions that flew by BEFORE its begin_round, or it sits
        # in the round alone, closes a late solo ledger, and diverges —
        # the scenario fuzzer's catch-up limit cycle (fuzz_convergence)
        self._recent_proposals: dict[bytes, list] = {}
        # catch-up: ledger acquisition sessions (reference: InboundLedgers)
        from .inbound import InboundLedgers

        self.inbound = InboundLedgers(
            send=adapter.request_ledger_data, hash_batch=hash_batch,
            clock=clock,
        )
        self.inbound.on_complete = self._ledger_acquired
        # segment-granular catch-up plane (node/inbound.SegmentCatchup):
        # wired by the owner when a segment-capable store exists.
        # `segment_source` answers peers' GetSegments (an object with
        # segments()/fetch_segment(), i.e. the segstore backend).
        self.segment_catchup = None
        self.segment_source = None
        # archive mode: the deep-history shard backfill loop
        # (node/archive.ShardBackfill), ticked next to segment_catchup
        self.shard_backfill = None
        # follower ingest observability (`follower.ingest` spans +
        # get_counts block): validation-seen -> adopted latency per
        # ingested ledger, plus plain counters
        from .metrics import LatencyHist
        from .tracer import STAGE_BOUNDS

        self.ingest_hist = LatencyHist(bounds=STAGE_BOUNDS, interpolate=True)
        self.ledgers_ingested = 0
        self._ingest_t0: dict[bytes, float] = {}
        # follower ingest kick coalescing: a close produces one trusted
        # validation PER UNL MEMBER for the same seq, and kicking the
        # LCL election inline on every one ran |UNL| elections (and up
        # to |UNL| acquisition attempts) per close. One kick per target
        # seq suffices — on_timer()'s unconditional _check_lcl remains
        # the liveness backstop for anything the kick missed.
        self._lcl_kick_seq = 0
        self.lcl_inline_kicks = 0
        self.lcl_kicks_coalesced = 0
        # honest health reporting (see DEGRADE_LAG): transitions are
        # tracer-visible and counted, state rides consensus_info and the
        # container's operating mode
        self._degraded = False
        self.degrade_transitions = 0
        # last VALIDATED seq the LocalTxs inclusion-sweep ran against
        self._local_sweep_seq = 0

    # -- byzantine defense -------------------------------------------------

    def note_byzantine(self, kind: str, peer: Optional[bytes] = None,
                       **info) -> None:
        """Record one recognized-and-neutralized hostile input: counter
        (`defense`), tracer instant (`byzantine.<kind>`), and — when the
        offender is an identified signer — the per-validator misbehavior
        bookkeeping hook (UNL plane)."""
        self.defense.add(kind)
        self.lm.tracer.instant(
            "byzantine." + kind, "consensus",
            peer=peer.hex()[:16] if peer else None, **info,
        )
        if self.on_byzantine is not None and peer is not None:
            try:
                self.on_byzantine(kind, peer)
            except Exception:  # noqa: BLE001 — bookkeeping must not
                pass           # interfere with message handling

    # how long a live LCL acquisition may sit with NO progress before
    # the election may retarget past it (node clock: seconds on a real
    # node, virtual steps on the simnet — roughly two rounds)
    ACQ_PIN_S = 10.0

    # -- lifecycle --------------------------------------------------------

    def start(self, root_account_id: bytes, close_time: int = 0) -> None:
        self.lm.start_new_ledger(root_account_id, close_time)
        self.begin_round()

    def begin_round(self) -> None:
        """reference: NetworkOPs::beginConsensus → make_LedgerConsensus"""
        if self.follower:
            # a follower never drives rounds: its chain advances only by
            # adopting validated ledgers (the catch-up/tailing path)
            self.round = None
            return
        # txsets stay cached ACROSS rounds (bounded in handle_txset):
        # a late joiner replaying stashed proposals needs the candidate
        # set that was shared before its begin_round
        self.round = LedgerConsensus(
            prev_ledger=self.lm.closed_ledger(),
            ledger_master=self.lm,
            adapter=self.adapter,
            validations=self.validations,
            key=self.key,
            unl=self.unl,
            network_time=self.network_time,
            clock=self.clock,
            prev_proposers=self.prev_proposers,
            prev_round_ms=self.prev_round_ms,
            proposing=self.proposing,
            hash_batch=self.hash_batch,
            idle_interval=self.idle_interval,
            voting=self.voting,
            note_byzantine=self.note_byzantine,
            prefetch_sigs=self.prefetch_tx_sigs,
            check_sigs=self.check_tx_sigs,
        )
        # playback (reference: Consensus::playbackProposals): replay
        # stashed positions that belong to THIS round's prior ledger.
        # Sorted by signer so replay order never leaks PYTHONHASHSEED
        # into round state.
        now = self.network_time()
        for pub in sorted(self._recent_proposals):
            for when, prop in self._recent_proposals[pub]:
                if now - when <= 60 and \
                        prop.prev_ledger == self.round.prev_hash:
                    self.round.peer_proposal(prop)

    @_locked
    def on_timer(self) -> None:
        """Heartbeat → consensus timer + catch-up check (reference:
        processHeartbeatTimer → timerEntry / checkLastClosedLedger)."""
        if self.round is not None:
            self.round.timer_entry()
        self._check_lcl()
        # re-trigger stalled acquisitions every other tick (reference:
        # PeerSet timeouts); progress-driven triggers do the steady-state
        self._tick += 1
        if self._tick % 2 == 0:
            self.inbound.expire_stale()
            for il in list(self.inbound.live.values()):
                self.inbound.trigger(il)
        # the segment bulk path's timeout/retry/backoff clock
        if self.segment_catchup is not None:
            self.segment_catchup.tick(self.clock())
        if self.shard_backfill is not None:
            self.shard_backfill.tick(self.clock())
        self._update_health()

    # -- health ------------------------------------------------------------

    @property
    def degraded(self) -> bool:
        """True while we close ledgers the network does not validate
        (quorum lost — partition, killed peers, or a fork we are on the
        wrong side of)."""
        return self._degraded

    @property
    def validator_state(self) -> str:
        if self.follower:
            return "follower"
        if self._degraded:
            return "tracking"
        return "proposing" if self.proposing else "observing"

    def follower_json(self) -> dict:
        """Ingest-plane counters for get_counts (follower mode)."""
        out = {
            "ledgers_ingested": self.ledgers_ingested,
            "validated_seq": (
                self.lm.validated.seq if self.lm.validated else 0
            ),
            "acquisitions_live": len(self.inbound.live),
            "lcl_inline_kicks": self.lcl_inline_kicks,
            "lcl_kicks_coalesced": self.lcl_kicks_coalesced,
        }
        if self.ingest_hist.count:
            out["ingest_p50_ms"] = self.ingest_hist.quantile(0.5)
            out["ingest_p99_ms"] = self.ingest_hist.quantile(0.99)
        sc = self.segment_catchup
        if sc is not None:
            out["segfetch"] = sc.get_json()
        sb = self.shard_backfill
        if sb is not None:
            out["shard_backfill"] = sb.get_json()
        return out

    def _update_health(self) -> None:
        closed = self.lm.closed_ledger().seq
        validated = self.lm.validated.seq if self.lm.validated else 0
        degraded = (closed - validated) > self.DEGRADE_LAG
        if degraded == self._degraded:
            return
        self._degraded = degraded
        self.degrade_transitions += 1
        self.lm.tracer.instant(
            "consensus.degraded" if degraded else "consensus.recovered",
            "consensus",
            closed_seq=closed, validated_seq=validated,
            state=self.validator_state,
        )

    # -- catch-up ---------------------------------------------------------

    def _check_lcl(self) -> None:
        """Elect the network LCL from current trusted validations and
        switch if another ledger has strictly more weight than ours —
        this is both the lag (we're behind) and the fork (same seq,
        different hash) repair path (reference: checkLastClosedLedger,
        NetworkOPs.cpp:776-925). A candidate must win two consecutive
        ticks before we act, so a healthy node mid-accept doesn't churn
        on the transient where peer validations beat its own close."""
        ours = self.lm.closed_ledger()
        ours_hash = ours.hash()
        # floor: the last QUORUM-VALIDATED seq. Validations below it are
        # history; validations between it and our closed seq stay
        # eligible — a node that solo-closed AHEAD of a starved net must
        # be pullable BACK onto the authoritative chain (filtering by
        # our own closed seq let a runaway fork ratchet forever; the
        # reference's checkLastClosedLedger weighs all current
        # validations, NetworkOPs.cpp:776-925)
        floor = self.lm.validated.seq if self.lm.validated is not None else 0
        val_votes: dict[bytes, int] = {}
        val_seq: dict[bytes, int] = {}
        for v in self.validations.current_trusted():
            if v.ledger_seq is None or v.ledger_seq <= floor:
                continue
            val_votes[v.ledger_hash] = val_votes.get(v.ledger_hash, 0) + 1
            val_seq[v.ledger_hash] = max(
                val_seq.get(v.ledger_hash, 0), v.ledger_seq
            )
        # peer-LCL votes from current proposals (the reference's
        # nodesUsing, NetworkOPs.cpp:821-843) — these break a symmetric
        # validation split (every closed chain diverged 1-1-...-1) that
        # validations alone can never heal
        now = self.network_time()
        using: dict[bytes, int] = {ours_hash: 1}  # ourselves
        for pub, (prev, seen) in list(self._peer_prevs.items()):
            if now - seen > 60:
                del self._peer_prevs[pub]
                continue
            using[prev] = using.get(prev, 0) + 1
        # election key mirrors ValidationCount::operator> with the
        # LEDGER HASH as the final deterministic tie-break, so a split
        # net elects ONE winner everywhere
        def key(h: bytes) -> tuple[int, int, bytes]:
            return (val_votes.get(h, 0), using.get(h, 0), h)

        candidates = set(val_votes) | set(using)
        candidates.discard(ours.parent_hash)  # never our own previous
        best = max(candidates, key=key)
        if key(best) <= key(ours_hash):  # covers best == ours_hash
            self._lcl_candidate = None
            return
        # hysteresis bypass when we are clearly LAGGING: the two-tick
        # confirm protects a healthy node's mid-accept transient, where
        # peer validations momentarily beat its own same-seq close. A
        # candidate >= 2 seqs ahead of our closed chain is not that
        # transient — it is catch-up, and paying the hysteresis there
        # put a straggler in a permanent limit cycle: elect -> confirm
        # -> acquire -> adopt costs one full round, so it tracked the
        # net at a constant 2-ledger offset and a high-quorum net
        # (e.g. 5-of-6 after an even partition healed) could never
        # re-assemble a validation quorum on one seq (found by the
        # scenario fuzzer; corpus fuzz_convergence pins it)
        lagging = val_seq.get(best, 0) >= ours.seq + 2
        if self._lcl_candidate != best and not self.follower and not lagging:
            # hysteresis: confirm next tick. A follower skips it — it
            # never closes rounds of its own, so there is no healthy
            # mid-accept transient to protect, and tailing latency is
            # the product (validation seen -> adoption kicked at once)
            self._lcl_candidate = best
            return
        self._lcl_candidate = best
        if self.follower and best not in self._ingest_t0:
            # ingest span clock starts at the first sighting of the
            # target (bounded: adoption pops; a never-adopted target
            # ages out with the oldest entries)
            if len(self._ingest_t0) >= 256:
                self._ingest_t0.pop(next(iter(self._ingest_t0)))
            self._ingest_t0[best] = _time.perf_counter()
        led = self.lm.get_ledger_by_hash(best)
        if led is not None:
            self._adopt_network_lcl(led)
        else:
            # single-flight: while one catch-up acquisition is live AND
            # viable, finishing it beats chasing every newer validation —
            # an adopted slightly-stale LCL still moves us forward, and
            # the next election closes the remaining gap. Without this, a
            # moving target (net closes faster than one acquisition
            # completes) re-targets forever and catch-up never lands. A
            # session that never even got a header (an unserveable —
            # possibly fabricated — hash) must not pin catch-up: retarget.
            cur = self._lcl_acquiring
            if cur is not None and cur in self.inbound.live:
                il = self.inbound.live[cur]
                # the pin holds only while the session is (a) still
                # progressing, (b) not already resolvable locally (we
                # may have closed/acquired the target through another
                # path since), and (c) chasing a target the election
                # has not left far behind. Violating any of these held
                # a node hostage to a moot transfer — the scenario
                # fuzzer caught a validator wedged ~70 rounds acquiring
                # a deep order-book tree for its OWN orphaned close
                # while the net validated 6 seqs past it.
                fresh = (
                    self.clock() - il.last_progress <= self.ACQ_PIN_S
                )
                have_local = self.lm.get_ledger_by_hash(cur) is not None
                superseded = (
                    self._lcl_acquiring_seq is not None
                    and val_seq.get(best, 0)
                    > self._lcl_acquiring_seq + 2
                )
                if (
                    (cur == best or il.header is not None)
                    and fresh and not have_local and not superseded
                ):
                    return
                self.inbound.abandon(cur)
            self._lcl_acquiring = best
            self._lcl_acquiring_seq = val_seq.get(best)
            self.inbound.acquire(best, for_lcl=True)
            # a cold/lagging node kicking off catch-up also starts the
            # segment bulk transfer: whole store segments land locally
            # so the tree walk above resolves via local_fetch instead of
            # per-node network waves. can_start rate-limits to one
            # session at a time, re-armed REARM_S after the last ended.
            if (
                self.segment_catchup is not None
                and self.segment_catchup.can_start(self.clock())
            ):
                self.segment_catchup.start()

    def _ledger_acquired(self, ledger: Ledger) -> None:
        """Acquisition finished (reference: InboundLedger LADispatch →
        checkAccept)."""
        self._adopt_network_lcl(ledger)

    def _adopt_network_lcl(self, ledger: Ledger) -> None:
        ours = self.lm.closed_ledger()
        if ledger.hash() == ours.hash():
            return
        # adopting a LOWER-seq ledger is legal fork repair (we solo-ran
        # ahead); the floor is the validated chain, which never regresses
        floor = (
            self.lm.validated.seq if self.lm.validated is not None else 0
        )
        if ledger.seq <= floor:
            return
        self.lm.switch_lcl(ledger)
        self._lcl_candidate = None
        self.lm.check_accept(
            ledger.hash(), self.validations.trusted_count_for(ledger.hash())
        )
        if self.follower:
            # ingest observability: validation-seen -> adopted latency
            now = _time.perf_counter()
            t0 = self._ingest_t0.pop(ledger.hash(), None)
            self.ledgers_ingested += 1
            if t0 is not None:
                self.ingest_hist.record((now - t0) * 1000.0)
                self.lm.tracer.complete(
                    "follower.ingest", "follower", t0, now, seq=ledger.seq
                )
            tracer = self.lm.tracer
            if tracer.enabled:
                # per-sampled-tx ingest evidence: the leaf every cross-
                # node tx tree needs on the follower (deterministic
                # sampling means the leader sampled the same txids)
                for txid, _blob, _meta in ledger.tx_entries():
                    tracer.instant(
                        "follower.ingest.tx", "follower", txid=txid,
                        ledger_seq=ledger.seq,
                    )
        # a multi-ledger jump must hand EVERY resolvable intermediate
        # ledger to the persistence plane oldest-first, or the txdb gets
        # a permanent hole for the skipped range (unresolvable ancestors
        # are the LedgerCleaner's repair territory)
        chain = [ledger]
        cursor = ledger
        while cursor.seq > ours.seq + 1:
            parent = self.lm.get_ledger_by_hash(cursor.parent_hash)
            if parent is None:
                break
            chain.append(parent)
            cursor = parent
        for led in reversed(chain):
            self._fire_on_ledger(led)
        self.begin_round()
        # fork-repair client contract: local submissions that rode the
        # LOSING chain re-apply against the adopted one with a fresh
        # retry horizon — without the rebase, the adoption's seq jump
        # silently expired them out of LocalTxs (found by the
        # partition_kills scenario: 40/69 client txs lost)
        if len(self.local_txs):
            self.local_txs.rebase(ledger.seq)
            self._sweep_local_txs()
            self.local_txs.apply_to_open(
                self.lm, TxParams.OPEN_LEDGER | TxParams.RETRY
            )

    def _fire_on_ledger(self, ledger: Ledger) -> None:
        for cb in self.on_ledger:
            try:
                cb(ledger)
            except Exception:  # noqa: BLE001 — hooks must not kill consensus
                import logging

                logging.getLogger("stellard.validator").exception(
                    "on_ledger hook failed"
                )

    @_locked
    def round_accepted(self, ledger: Ledger, round_ms: int) -> None:
        """Adapter callback after accept(): record stats and start the
        next round (reference: endConsensus → NetworkOPs::endConsensus)."""
        self.prev_proposers = (
            len(self.round.peer_positions) + 1 if self.round else 1
        )
        self.prev_round_ms = max(round_ms, LEDGER_MIN_CONSENSUS_MS)
        self.rounds_completed += 1
        self._fire_on_ledger(ledger)
        # local submissions that missed this ledger re-apply to the new
        # open ledger; landed/expired ones sweep (reference LocalTxs).
        # The sweep runs against VALIDATED ledgers only — sweeping the
        # just-closed ledger treated inclusion in a ledger the network
        # never validated as done, so a client tx committed on a LOSING
        # solo fork vanished at fork repair instead of re-applying
        # (found by the partition_kills scenario)
        self._sweep_local_txs()
        if len(self.local_txs):
            self.local_txs.apply_to_open(
                self.lm, TxParams.OPEN_LEDGER | TxParams.RETRY
            )
        self.begin_round()

    def _sweep_local_txs(self) -> None:
        """Inclusion/expiry sweep against the latest quorum-validated
        ledger (once per validated seq)."""
        val = self.lm.validated
        if val is not None and val.seq != self._local_sweep_seq:
            self._local_sweep_seq = val.seq
            self.local_txs.sweep(val)

    # -- transaction submission ------------------------------------------

    @_locked
    def submit(
        self, tx: SerializedTransaction, local: bool = True
    ) -> tuple[TER, bool]:
        txid = tx.txid()
        flags = self.router.get_flags(txid)
        if flags & SF_BAD:
            return TER.temINVALID, False
        if not (flags & SF_SIGGOOD):
            ok, _ = tx.passes_local_checks()
            if not ok or not self._check_tx_sig(tx):
                self.router.set_flag(txid, SF_BAD)
                return TER.temINVALID, False
            self.router.set_flag(txid, SF_SIGGOOD)
        tx.set_sig_verdict(True)
        with self.lm.tracer.span(
            "submit", "submit", txid=txid,
            source="local" if local else "overlay",
        ):
            ter, applied = self.lm.do_transaction(
                tx, TxParams.OPEN_LEDGER | TxParams.RETRY
            )
        if ter == TER.terPRE_SEQ:
            self.lm.add_held_transaction(tx)
        if local and not ter.is_tem:
            # client submissions (NOT relayed gossip) re-apply across
            # rounds (reference: LocalTxs.cpp push_back fed only from the
            # client submit path — tracking relays would grow with total
            # network traffic)
            self.local_txs.push_back(self.lm.closed_ledger().seq, tx)
        return ter, applied

    @staticmethod
    def _tx_verify_request(tx: SerializedTransaction):
        from ..crypto.backend import VerifyRequest

        return VerifyRequest(
            public=tx.signing_pub_key,
            signing_hash=tx.signing_hash(),
            signature=tx.signature,
        )

    def _check_tx_sig(self, tx: SerializedTransaction) -> bool:
        """Tx signature through the verify plane when one is wired —
        relayed network txs are the bulk of a real validator's verify
        load (reference: PeerImp::checkTransaction, the #1 hot call),
        and the per-signature host-library path left them off the
        batched/native/device plane entirely (close-p50 profile: ~45%%
        of busy samples in keys.verify_signature)."""
        if self.verify_many is not None:
            good = bool(self.verify_many([self._tx_verify_request(tx)])[0])
            tx.set_sig_verdict(good)
            return good
        return tx.check_sign()

    def prefetch_tx_sigs(self, txs: list) -> None:
        """Batch-verify a burst of relayed txs' signatures through the
        verify plane in ONE call, recording verdicts in the HashRouter —
        submit() then sees SF_SIGGOOD/SF_BAD and never verifies again.
        The per-message path costs a full verify per tx regardless of
        backend (singleton marshaling ~= host-lib verify); one network
        read often carries many TxMessages, and THIS is the seam that
        puts relayed traffic on the batched/native/device plane
        (reference: PeerImp::checkTransaction, the #1 hot call). A tx the
        HashRouter already has a verdict for takes that verdict."""
        pending = []
        seen: set[bytes] = set()  # dedupe: N copies of one tx in a burst
        for tx in txs:            # must cost ONE verify, not N
            txid = tx.txid()
            flags = self.router.get_flags(txid)
            if flags & (SF_SIGGOOD | SF_BAD):
                tx.set_sig_verdict(bool(flags & SF_SIGGOOD))
                continue
            if txid in seen or self.verify_many is None:
                continue
            seen.add(txid)
            # structural validity gates the SIGGOOD flag exactly as the
            # per-tx path does (submit() skips its checks when the flag
            # is already set; reference: checkTransaction runs
            # checkValid before any signature work)
            ok, _why = tx.passes_local_checks()
            if not ok:
                self.router.set_flag(tx.txid(), SF_BAD)
                continue
            pending.append(tx)
        if not pending:
            return
        results = self.verify_many(
            [self._tx_verify_request(tx) for tx in pending]
        )
        for tx, good in zip(pending, results):
            good = bool(good)
            tx.set_sig_verdict(good)
            self.router.set_flag(
                tx.txid(), SF_SIGGOOD if good else SF_BAD
            )

    def check_tx_sigs(self, txs: list) -> list:
        """Each tx's signature verdict, checked anew whatever the
        HashRouter holds (a disputed tx's blob may come from a peer's
        set): one batch of the verify plane, or each on the host when
        no plane is wired (the JAX round's check)."""
        if self.verify_many is None:
            return [tx.check_sign() for tx in txs]
        if not txs:
            return []
        verdicts = [bool(v) for v in self.verify_many(
            [self._tx_verify_request(tx) for tx in txs])]
        for tx, good in zip(txs, verdicts):
            tx.set_sig_verdict(good)
        return verdicts

    # -- peer message handlers -------------------------------------------

    @_locked
    def handle_tx(self, tx: SerializedTransaction) -> bool:
        """Relayed network tx (reference: PeerImp::checkTransaction).
        Returns True when it should be re-relayed."""
        ter, _ = self.submit(tx, local=False)
        return int(ter) == 0 or -99 <= int(ter) < 0

    def handle_proposal(self, prop: LedgerProposal) -> bool:
        """reference: PeerImp::checkPropose → peerPosition. Signature is
        verified once per suppression id OUTSIDE the master lock (the
        reference checks on jtVALIDATION jobs off the lock too — a device
        verify batch must not serialize RPC tx application), then the
        round mutation runs locked."""
        pid = prop.suppression_id()
        flags = self.router.get_flags(pid)
        if flags & SF_BAD:
            return False
        if not (flags & SF_SIGGOOD):
            if not self._verify([prop]):
                self.router.set_flag(pid, SF_BAD)
                self.note_byzantine(
                    "bad_proposal_sig", peer=prop.node_public
                )
                return False
            self.router.set_flag(pid, SF_SIGGOOD)
        prop.set_sig_verdict(True)
        with self.lock:
            # remember each trusted proposer's view of the LCL even when
            # its proposal is for ANOTHER chain — these are the
            # "nodesUsing" votes of the reference's LCL election
            # (NetworkOPs.cpp:821-843 counts peer closed-ledger hashes)
            if prop.node_public in self.unl and not prop.is_bowout():
                self._peer_prevs[prop.node_public] = (
                    prop.prev_ledger, self.network_time()
                )
                # stash for playback into a later begin_round (bounded
                # per signer; see _recent_proposals)
                stash = self._recent_proposals.setdefault(
                    prop.node_public, []
                )
                stash.append((self.network_time(), prop))
                del stash[:-8]
            if self.round is None:
                return False
            return self.round.peer_proposal(prop)

    def handle_validation(self, val: STValidation) -> bool:
        """reference: PeerImp::checkValidation → recvValidation →
        Validations::addValidation → LedgerMaster::checkAccept.
        Signature check runs outside the master lock (see handle_proposal)."""
        vid = val.validation_id()
        flags = self.router.get_flags(vid)
        if flags & SF_BAD:
            return False
        if not (flags & SF_SIGGOOD):
            if not self._verify([val]):
                self.router.set_flag(vid, SF_BAD)
                self.note_byzantine(
                    "bad_validation_sig", peer=val.signer or None
                )
                return False
            self.router.set_flag(vid, SF_SIGGOOD)
        val.set_sig_verdict(True)
        if val.signer not in self.unl:
            # a correctly-signed validation from a key outside the UNL
            # (byzantine "self-signed" validation): stored untrusted —
            # zero quorum weight — but counted as evidence
            self.note_byzantine(
                "untrusted_validation", peer=val.signer or None
            )
        with self.lock:
            # validation arrival on the round timeline (trace id = the
            # validated ledger's seq when the peer reported one)
            self.lm.tracer.instant(
                "consensus.validation_in", "consensus",
                seq=val.ledger_seq,
                peer=val.signer.hex()[:16] if val.signer else None,
            )
            current = self.validations.add(val)
            self.lm.check_accept(
                val.ledger_hash,
                self.validations.trusted_count_for(val.ledger_hash),
            )
            if current and self.follower:
                # steady-state tailing: a fresh trusted validation IS
                # the new-validated-ledger announcement — elect/acquire
                # now instead of waiting out the next timer tick.
                # Coalesced per target seq: the 2nd..|UNL|th validation
                # of one close changes no election input worth a fresh
                # run (pinned by test_follower_kick_coalescing)
                seq = val.ledger_seq or 0
                if seq > self._lcl_kick_seq:
                    self._lcl_kick_seq = seq
                    self.lcl_inline_kicks += 1
                    self._check_lcl()
                else:
                    self.lcl_kicks_coalesced += 1
            return current

    @_locked
    def handle_ledger_data(self, msg) -> bool:
        """Route a LedgerData reply into the acquisition machinery.
        Returns True when the reply made progress (callers score the
        sending peer on this — unsolicited data must earn nothing)."""
        return bool(self.inbound.take_ledger_data(msg))

    @_locked
    def has_acquisition(self, ledger_hash: bytes) -> bool:
        """Live OR recently-completed: late LedgerData from peers we
        legitimately queried must not be charged as unwanted."""
        return (
            ledger_hash in self.inbound.live
            or self.inbound.recently_done(ledger_hash)
        )

    @_locked
    def serve_get_ledger(self, msg):
        """Answer a peer's GetLedger from our closed-ledger cache."""
        from ..state.shamap import MissingNodeError
        from .inbound import serve_get_ledger

        try:
            return serve_get_ledger(
                self.lm.get_ledger_by_hash(msg.ledger_hash), msg
            )
        except MissingNodeError:
            # a lazily-opened historical ledger whose nodes a sweep has
            # since retired: we cannot serve it — answer with silence
            # and the requester's acquisition retries another peer
            return None

    def snapshot_epoch(self) -> int:
        """Epoch stamp for the snapshot-handoff leg (doc/follower.md):
        a fingerprint of the SEALED segment set served over GetSegments.
        Rotation, compaction, and online deletion all change the sealed
        set — exactly the moments a mid-transfer fetcher's offsets go
        stale — while steady appends to the active segment do not.
        Nonzero by construction; 0 on the wire means "no epoch" (a
        pre-epoch peer), which fetchers treat as don't-care."""
        import zlib

        src = self.segment_source
        if src is None:
            return 0
        sealed = sorted(
            int(d["id"]) for d in src.segments() if not d["active"]
        )
        blob = ",".join(str(i) for i in sealed).encode()
        return zlib.crc32(blob) or 1

    def serve_get_segments(self, msg):
        """Answer a peer's GetSegments from the wired segment source
        (segstore backend): manifest for seg_id < 0, else one bounded
        chunk of the segment's raw bytes. NOT under the master lock —
        segment reads are pure store IO and must not stall consensus.

        Snapshot handoff (follower trees): every reply carries our
        current snapshot epoch + validated seq. The manifest doubles as
        the `snapshot_offer`; epoch-pinned chunk fetches are the
        `snapshot_fetch` — a fetcher seeing the epoch move mid-transfer
        restarts from a fresh manifest instead of splicing records from
        two different snapshots."""
        from ..overlay.wire import SEGMENT_CHUNK, SegmentData

        src = self.segment_source
        if src is None:
            return None
        epoch = self.snapshot_epoch()
        snap_seq = self.lm.validated.seq if self.lm.validated else 0
        if msg.seg_id < 0:
            # shard rows carry their sealed seq range + full file size
            # (nonzero-only on the wire: segstore rows encode exactly
            # as before) so range-selecting peers never probe
            rows = [
                (d["id"], d["size"], d["live_bytes"], bool(d["active"]),
                 int(d.get("lo", 0)), int(d.get("hi", 0)),
                 int(d.get("file_bytes", 0)))
                for d in src.segments()
            ]
            return SegmentData(seg_id=-1, segments=rows,
                               snap_epoch=epoch, snap_seq=snap_seq)
        off = max(0, int(msg.offset))
        try:
            # chunked read: serving a multi-chunk transfer must not
            # re-read the whole segment per request
            got = src.fetch_segment(msg.seg_id, offset=off,
                                    length=SEGMENT_CHUNK)
        except TypeError:  # sources without the chunk signature
            got = src.fetch_segment(msg.seg_id)
            if got is None:
                return None
            meta, data = got
            return SegmentData(
                seg_id=msg.seg_id, total=len(data), offset=off,
                data=data[off: off + SEGMENT_CHUNK],
                snap_epoch=epoch, snap_seq=snap_seq,
            )
        if got is None:
            return None
        meta, data = got
        return SegmentData(
            seg_id=msg.seg_id,
            total=int(meta["size"]),
            offset=off,
            data=data,
            snap_epoch=epoch,
            snap_seq=snap_seq,
        )

    def handle_segment_data(self, peer, msg) -> None:
        """Route a SegmentData reply into the bulk catch-up machinery
        (`peer` is the transport's peer id — simnet nid / node public).
        Archive nodes run a second fetcher on the same door: manifests
        feed BOTH (each selects its own rows), whole-shard-file chunks
        (ids at or above SHARD_FILE_BASE) go to the backfill."""
        sb = self.shard_backfill
        sc = self.segment_catchup
        if msg.seg_id < 0:
            if sc is not None:
                sc.on_manifest(peer, msg.segments, epoch=msg.snap_epoch,
                               snap_seq=msg.snap_seq)
            if sb is not None:
                sb.on_manifest(peer, msg.segments, epoch=msg.snap_epoch,
                               snap_seq=msg.snap_seq)
            return
        if msg.seg_id >= SHARD_FILE_BASE:
            if sb is not None:
                sb.on_data(peer, msg)
            return
        if sc is not None:
            sc.on_data(peer, msg)

    @_locked
    def handle_txset(self, txset: TxSet) -> None:
        """A shared/acquired candidate set arrived
        (reference: TMHaveTransactionSet/TransactionAcquire completion)."""
        h = txset.hash()
        self.txset_cache.pop(h, None)  # refresh insertion order
        self.txset_cache[h] = txset
        while len(self.txset_cache) > 16:
            # bounded cross-round cache (was: cleared per round; late
            # round joins need the sets shared before their begin_round)
            del self.txset_cache[next(iter(self.txset_cache))]
        if self.round is not None:
            self.round.have_tx_set(h, txset)

    def _verify(self, objs) -> bool:
        """Verify a burst of signed consensus objects (proposals or
        validations); batched on the VerifyPlane when available. Returns
        True only when every signature in the burst is good."""
        if self.verify_many is not None:
            from ..crypto.backend import VerifyRequest

            reqs = [
                VerifyRequest(
                    public=getattr(o, "node_public", None) or o.signer,
                    signing_hash=o.signing_hash(),
                    signature=o.signature,
                )
                for o in objs
            ]
            return bool(all(self.verify_many(reqs)))
        ok = True
        for o in objs:
            good = o.is_valid() if hasattr(o, "is_valid") else o.check_sign()
            ok = ok and good
        return ok

    # -- introspection ----------------------------------------------------

    def consensus_info(self) -> dict:
        info = {
            "rounds_completed": self.rounds_completed,
            "validation_count": self.validations.size(),
            # honest health: "tracking" while we close ledgers nobody
            # validates, "proposing"/"observing" otherwise
            "validator_state": self.validator_state,
            "degraded": self._degraded,
            "closed_seq": self.lm.closed_ledger().seq,
            "validated_seq": (
                self.lm.validated.seq if self.lm.validated else 0
            ),
        }
        if self.round is not None:
            info["round"] = self.round.get_json()
        return info
