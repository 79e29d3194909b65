"""LedgerConsensus: one consensus round, driven by a periodic timer.

Reference: src/ripple_app/consensus/LedgerConsensus.cpp — states
(:36-47), timerEntry (:589), statePreClose (:637), stateEstablish
(:713), closeLedger/takeInitialPosition (:1761-1813), peerPosition,
updateOurPositions, accept (:931-1127).

Device shape: the round's signature work — every peer proposal and
every round of validations — is handed to the VerifyPlane through
`verify_many` (K1 on the card), instead of the reference's
one-job-per-signature libsodium calls. Tx-set hashing rides the same
level-batched hasher as the ledger SHAMaps (K2/K3).

The round talks to the outside world only through a `ConsensusAdapter`,
so the deterministic in-process simnet (overlay.simnet) and the real
TCP overlay drive identical logic.
"""

from __future__ import annotations

import time as _time
from enum import IntEnum
from typing import Callable, Optional

from ..node.ledgermaster import CanonicalTXSet, LedgerMaster
from ..protocol.keys import KeyPair
from ..state.ledger import Ledger
from .disputed import DisputedTx
from .proposal import LedgerProposal
from .timing import (
    AV_CT_CONSENSUS_PCT,
    LEDGER_IDLE_INTERVAL,
    LEDGER_MIN_CONSENSUS_MS,
    have_consensus,
    next_close_resolution,
    should_close,
)

# keep our proposal fresh / drop stale peer positions, in seconds
# (reference: PROPOSE_INTERVAL / PROPOSE_FRESHNESS, LedgerTiming.h:64-67)
PROPOSE_INTERVAL = 12
PROPOSE_FRESHNESS = 20
from .txset import TxSet
from .validation import STValidation
from .validations import ValidationsStore

__all__ = ["LedgerConsensus", "ConsensusAdapter", "ConsensusState"]


class ConsensusState(IntEnum):
    """reference: LedgerConsensus.cpp:36-47"""

    PRE_CLOSE = 0  # open ledger accumulating txns
    ESTABLISH = 1  # we closed; exchanging positions
    FINISHED = 2  # consensus reached; accept scheduled
    ACCEPTED = 3  # new LCL built and validated


class ConsensusAdapter:
    """Round I/O seam. The simnet and the TCP overlay both implement
    this; LedgerConsensus never touches a socket."""

    def propose(self, proposal: LedgerProposal) -> None:
        raise NotImplementedError

    def share_tx_set(self, txset: TxSet) -> None:
        raise NotImplementedError

    def acquire_tx_set(self, set_hash: bytes) -> Optional[TxSet]:
        """Return the set if already known; else start acquisition and
        deliver later via LedgerConsensus.have_tx_set."""
        raise NotImplementedError

    def send_validation(self, val: STValidation) -> None:
        raise NotImplementedError

    def relay_disputed_tx(self, blob: bytes) -> None:
        """Flood a disputed tx so peers missing it can include it next
        round (reference: DisputedTx creation relays TMTransaction)."""

    def request_ledger_data(self, msg) -> None:
        """Send a GetLedger request toward peers (catch-up acquisition;
        reference: PeerSet::sendRequest)."""

    def on_accepted(self, ledger: Ledger, round_ms: int) -> None:
        """New LCL built; the node should start the next round."""


class LedgerConsensus:
    def __init__(
        self,
        prev_ledger: Ledger,
        ledger_master: LedgerMaster,
        adapter: ConsensusAdapter,
        validations: ValidationsStore,
        key: KeyPair,
        unl: set[bytes],
        network_time: Callable[[], int],
        clock: Callable[[], float] = _time.monotonic,
        prev_proposers: int = 0,
        prev_round_ms: int = LEDGER_MIN_CONSENSUS_MS,
        proposing: bool = True,
        hash_batch: Optional[Callable] = None,
        idle_interval: int = LEDGER_IDLE_INTERVAL,
        voting=None,
        note_byzantine: Optional[Callable] = None,
        *,
        prefetch_sigs: Callable[[list], None],
        check_sigs: Callable[[list], list],
    ):
        self.lm = ledger_master
        # consensus round events ride the chain's tracing plane (trace
        # id = the ledger under construction)
        self.tracer = ledger_master.tracer
        self.adapter = adapter
        self.validations = validations
        self.key = key
        self.unl = unl  # trusted node public keys (not including us)
        self.network_time = network_time
        self.clock = clock
        self.proposing = proposing
        self.hash_batch = hash_batch
        self.idle_interval = idle_interval
        self.voting = voting  # consensus.voting.VotingBox or None
        # defense sink (ValidatorNode.note_byzantine): recognized hostile
        # proposals are counted, never silently dropped
        self.note_byzantine = note_byzantine or (lambda kind, **kw: None)
        # the agreed set's signature verdicts before its close apply
        # (ValidatorNode.prefetch_tx_sigs: what the node already knows,
        # the rest in one batch of the verify plane)
        self.prefetch_sigs = prefetch_sigs
        # the disputed transactions' re-check on accept, the reference's
        # own (ValidatorNode.check_tx_sigs: one batch of the plane)
        self.check_sigs = check_sigs

        self.prev_ledger = prev_ledger
        self.prev_hash = prev_ledger.hash()
        self.seq = prev_ledger.seq + 1
        self.prev_proposers = prev_proposers
        self.prev_round_ms = max(prev_round_ms, LEDGER_MIN_CONSENSUS_MS)

        # close-time resolution for the ledger being built (reference:
        # getNextLedgerTimeResolution; close_flags bit 0 = no agreement)
        self.resolution = next_close_resolution(
            prev_ledger.close_resolution,
            (prev_ledger.close_flags & 1) == 0,
            self.seq,
        )

        self.state = ConsensusState.PRE_CLOSE
        self.round_start = self.clock()
        self.consensus_start: Optional[float] = None

        self.peer_positions: dict[bytes, LedgerProposal] = {}
        self.position_times: dict[bytes, float] = {}  # peer -> recv clock
        # highest propose_seq ever seen per peer — survives bow-outs and
        # staleness prunes so a replayed old proposal can't re-register a
        # departed proposer
        self.max_seen_seq: dict[bytes, int] = {}
        # (peer, propose_seq) -> (tx_set_hash, close_time): detects a key
        # SIGNING two different positions at one sequence (equivocation)
        # vs a mere duplicate relay of the same position
        self._seen_positions: dict[tuple[bytes, int], tuple[bytes, int]] = {}
        self.last_propose: Optional[float] = None
        self.acquired: dict[bytes, TxSet] = {}
        self.disputes: dict[bytes, DisputedTx] = {}
        self.compared: set[bytes] = set()  # set hashes diffed vs ours
        self.our_position: Optional[LedgerProposal] = None
        self.our_set: Optional[TxSet] = None
        self._pre_close_open_ids: set[bytes] = set()
        self.our_close_time = 0
        self.round_ms = 0  # set on accept

    # -- timer ------------------------------------------------------------

    def timer_entry(self) -> None:
        """reference: LedgerConsensus::timerEntry (:589)"""
        if self.state == ConsensusState.PRE_CLOSE:
            self._state_pre_close()
        elif self.state == ConsensusState.ESTABLISH:
            self._state_establish()

    def _ms_since(self, t0: Optional[float]) -> int:
        return int((self.clock() - (t0 if t0 is not None else 0)) * 1000)

    # -- PRE_CLOSE --------------------------------------------------------

    def _state_pre_close(self) -> None:
        open_ledger = self.lm.current_ledger()
        any_tx = any(True for _ in open_ledger.tx_entries())
        proposers_closed = len(self.peer_positions)
        open_ms = self._ms_since(self.round_start)
        if should_close(
            any_tx,
            max(self.prev_proposers, proposers_closed + 1),
            proposers_closed,
            open_ms,  # since our round began == since prev close
            open_ms,
            self.idle_interval,
        ):
            self.close_ledger()

    def close_ledger(self) -> None:
        """Take our initial position (reference: closeLedger +
        takeInitialPosition :1761-1813)."""
        open_ledger = self.lm.current_ledger()
        self.our_set = TxSet(self.hash_batch)
        for txid, blob, _meta in open_ledger.tx_entries():
            self.our_set.add(txid, blob)
        if self.voting is not None:
            # flag-ledger voting: amendment/fee pseudo-txs join our initial
            # position (reference: takeInitialPosition → doVoting,
            # LedgerConsensus.cpp:1033-1038). Votes are tallied over the
            # validations of the flag ledger's parent, which every honest
            # node has seen, so positions agree.
            parent_vals = self.validations.validations_for(
                self.prev_ledger.parent_hash
            )
            for ptx in self.voting.position_injections(
                self.prev_ledger, parent_vals
            ):
                self.our_set.add(ptx.txid(), ptx.serialize())
        # remembered for accept(): these are re-applied (when left out) by
        # close_with_txset, so the dispute-reapply loop must skip them
        self._pre_close_open_ids = self.our_set.txids()
        self.our_close_time = Ledger.round_close_time(
            self.network_time(), self.resolution
        )
        self.our_position = LedgerProposal(
            self.prev_hash, 0, self.our_set.hash(), self.our_close_time
        )
        if self.proposing:
            self.our_position.sign(self.key)
            self.adapter.propose(self.our_position)
            self.tracer.instant(
                "consensus.propose_out", "consensus", seq=self.seq,
                propose_seq=0, txs=len(self._pre_close_open_ids),
            )
        self.adapter.share_tx_set(self.our_set)
        self.acquired[self.our_set.hash()] = self.our_set
        self.state = ConsensusState.ESTABLISH
        self.tracer.instant(
            "consensus.state", "consensus", seq=self.seq,
            state="ESTABLISH", open_ms=self._ms_since(self.round_start),
        )
        self.consensus_start = self.clock()
        self.last_propose = self.clock()
        # fold in positions that arrived before we closed
        for prop in list(self.peer_positions.values()):
            ts = self.acquired.get(prop.tx_set_hash)
            if ts is None:
                ts = self.adapter.acquire_tx_set(prop.tx_set_hash)
                if ts is not None:
                    self.acquired[prop.tx_set_hash] = ts
            if ts is not None:
                self._compare_set(ts)

    # -- peer input -------------------------------------------------------

    def peer_proposal(self, prop: LedgerProposal) -> bool:
        """A signature-checked proposal from a trusted peer. Returns True
        if it changed our view (and should be relayed)."""
        if prop.prev_ledger != self.prev_hash:
            return False  # different LCL — not our round
        peer = prop.node_public
        if peer not in self.unl or peer == self.key.public:
            return False
        if prop.is_bowout():
            self.peer_positions.pop(peer, None)
            self.max_seen_seq[peer] = prop.propose_seq  # nothing tops this
            for d in self.disputes.values():
                d.unvote(peer)
            self.tracer.instant(
                "consensus.proposal_in", "consensus", seq=self.seq,
                peer=peer.hex()[:16], bowout=True,
            )
            return True
        position = (prop.tx_set_hash, prop.close_time)
        if prop.propose_seq <= self.max_seen_seq.get(peer, -1):
            # stale or replayed. Distinguish a harmless duplicate relay
            # from EQUIVOCATION — the same key signing a DIFFERENT
            # position at a sequence it already used. Either way the
            # first-seen position stands and quorum math never counts a
            # proposer twice (peer_positions is keyed by peer).
            prev = self._seen_positions.get((peer, prop.propose_seq))
            if prev is not None and prev != position:
                self.note_byzantine("conflicting_proposal", peer=peer,
                                    propose_seq=prop.propose_seq)
            else:
                self.note_byzantine("duplicate_proposal", peer=peer,
                                    propose_seq=prop.propose_seq)
            return False
        self._seen_positions[(peer, prop.propose_seq)] = position
        self.max_seen_seq[peer] = prop.propose_seq
        self.peer_positions[peer] = prop
        self.position_times[peer] = self.clock()
        self.tracer.instant(
            "consensus.proposal_in", "consensus", seq=self.seq,
            peer=peer.hex()[:16], propose_seq=prop.propose_seq,
        )
        ts = self.acquired.get(prop.tx_set_hash)
        if ts is None:
            ts = self.adapter.acquire_tx_set(prop.tx_set_hash)
            if ts is not None:
                self.have_tx_set(prop.tx_set_hash, ts)
        if ts is not None:
            self._update_peer_votes(peer, ts)
        return True

    def have_tx_set(self, set_hash: bytes, txset: TxSet) -> None:
        """An acquired peer tx set arrived (reference: mapComplete)."""
        self.acquired[set_hash] = txset
        if self.our_set is not None:
            self._compare_set(txset)

    def _compare_set(self, txset: TxSet) -> None:
        h = txset.hash()
        if h in self.compared or self.our_set is None:
            return
        self.compared.add(h)
        # new disputes from the symmetric difference with our set
        # (reference: createDisputes via SHAMap::compare). SORTED:
        # differences() is a Python set, and iterating it raw leaks the
        # process's string-hash seed into dispute creation and relay
        # ORDER — which reorders wire messages and thus peers' apply
        # order, breaking cross-process reproducibility of a seeded
        # simnet run (found by the scenario smoke's determinism gate)
        for txid in sorted(self.our_set.differences(txset)):
            if txid not in self.disputes:
                blob = self.our_set.get(txid) or txset.get(txid) or b""
                self.disputes[txid] = DisputedTx(
                    txid, blob, our_vote=txid in self.our_set
                )
                if blob:
                    self.adapter.relay_disputed_tx(blob)
        # (re)vote every peer whose position references a known set
        for peer, prop in self.peer_positions.items():
            ts = self.acquired.get(prop.tx_set_hash)
            if ts is not None:
                self._update_peer_votes(peer, ts)

    def _update_peer_votes(self, peer: bytes, txset: TxSet) -> None:
        for d in self.disputes.values():
            d.set_vote(peer, d.txid in txset)

    # -- ESTABLISH --------------------------------------------------------

    def _time_pct(self) -> int:
        return (self._ms_since(self.consensus_start) * 100) // self.prev_round_ms

    def _effective_close_time(self) -> tuple[int, bool]:
        """Close-time consensus: the most-voted rounded close time among
        current proposers (incl. us); agreement requires
        AV_CT_CONSENSUS_PCT percent (reference: updateOurPositions
        close-time buckets)."""
        votes: dict[int, int] = {self.our_close_time: 1}
        for prop in self.peer_positions.values():
            ct = Ledger.round_close_time(prop.close_time, self.resolution)
            votes[ct] = votes.get(ct, 0) + 1
        total = 1 + len(self.peer_positions)
        best_ct, best_n = max(votes.items(), key=lambda kv: (kv[1], kv[0]))
        if best_n * 100 >= AV_CT_CONSENSUS_PCT * total:
            return best_ct, True
        return self.our_close_time, False

    def _state_establish(self) -> None:
        """reference: stateEstablish (:713) → updateOurPositions +
        haveConsensus check."""
        if self._ms_since(self.consensus_start) < LEDGER_MIN_CONSENSUS_MS:
            return  # participation window: collect positions before judging
        self._prune_stale_positions()
        self._update_our_position()
        self._keep_proposal_fresh()
        ct, ct_agree = self._effective_close_time()
        agree = 0
        our_hash = self.our_position.tx_set_hash
        for prop in self.peer_positions.values():
            if prop.tx_set_hash == our_hash:
                agree += 1
        target = max(self.prev_proposers, len(self.peer_positions) + 1)
        if have_consensus(
            target,
            len(self.peer_positions),
            agree,
            self._ms_since(self.consensus_start),
            self.prev_round_ms,
        ):
            self.state = ConsensusState.FINISHED
            self.tracer.instant(
                "consensus.state", "consensus", seq=self.seq,
                state="FINISHED", proposers=len(self.peer_positions),
                agree=agree,
                establish_ms=self._ms_since(self.consensus_start),
            )
            self.accept(ct, ct_agree)

    def _prune_stale_positions(self) -> None:
        """Drop peer positions older than PROPOSE_FRESHNESS so a vanished
        (partitioned/crashed) proposer stops counting toward agreement
        (reference: peerPosition staleness via PROPOSE_FRESHNESS)."""
        now = self.clock()
        for peer in [
            p
            for p, t in self.position_times.items()
            if now - t > PROPOSE_FRESHNESS
        ]:
            self.peer_positions.pop(peer, None)
            self.position_times.pop(peer, None)
            for d in self.disputes.values():
                d.unvote(peer)

    def _keep_proposal_fresh(self) -> None:
        """Re-broadcast (with a bumped position number) every
        PROPOSE_INTERVAL so late-joining or re-connected peers learn our
        position — without this a healed partition can never rejoin a
        stuck round (reference: PROPOSE_INTERVAL forced re-propose)."""
        if not self.proposing or self.our_position is None:
            return
        if (
            self.last_propose is not None
            and self.clock() - self.last_propose < PROPOSE_INTERVAL
        ):
            return
        self.our_position = self.our_position.advanced(
            self.our_position.tx_set_hash, self.our_close_time
        )
        self.our_position.sign(self.key)
        self.adapter.propose(self.our_position)
        if self.our_set is not None:
            self.adapter.share_tx_set(self.our_set)
        self.last_propose = self.clock()

    def _update_our_position(self) -> None:
        """Avalanche vote switching; on any change, advance and re-propose
        (reference: updateOurPositions)."""
        if self.our_set is None:
            return
        time_pct = self._time_pct()
        changed = False
        for d in self.disputes.values():
            if d.update_vote(time_pct, self.proposing):
                changed = True
        ct, _agree = self._effective_close_time()
        if ct != self.our_close_time:
            self.our_close_time = ct
            changed = True
        if changed:
            new_set = self.our_set.copy()
            for d in self.disputes.values():
                if d.our_vote and d.txid not in new_set and d.blob:
                    new_set.add(d.txid, d.blob)
                elif not d.our_vote and d.txid in new_set:
                    new_set.remove(d.txid)
            self.our_set = new_set
            self.acquired[new_set.hash()] = new_set
            self.our_position = self.our_position.advanced(
                new_set.hash(), self.our_close_time
            )
            # avalanche vote switch: our position moved (disputed-tx
            # votes crossed a threshold and/or the close time converged)
            self.tracer.instant(
                "consensus.position_change", "consensus", seq=self.seq,
                propose_seq=self.our_position.propose_seq,
                disputes=len(self.disputes), time_pct=time_pct,
            )
            if self.proposing:
                self.our_position.sign(self.key)
                self.adapter.propose(self.our_position)
                self.last_propose = self.clock()
                self.tracer.instant(
                    "consensus.propose_out", "consensus", seq=self.seq,
                    propose_seq=self.our_position.propose_seq,
                )
            self.adapter.share_tx_set(new_set)
            self._compare_set(new_set)

    # -- accept -----------------------------------------------------------

    def accept(self, close_time: int, ct_agree: bool) -> None:
        """Build the new LCL from the agreed set, sign and broadcast our
        validation (reference: accept :931-1127)."""
        consensus_set = self.acquired.get(
            self.our_position.tx_set_hash if self.our_position else b"",
            self.our_set,
        )
        txs = consensus_set.transactions() if consensus_set else []
        # the set's blobs parse to fresh transactions: give each its
        # verdict first, so that no transactor of the close apply checks
        # a signature on the host (the JAX round checks every one that
        # does not splice, a host verify each)
        self.prefetch_sigs(txs)
        new_lcl, _results = self.lm.close_with_txset(
            txs, close_time, self.resolution, correct_close_time=ct_agree
        )
        # per-tx apply results ride on the ledger for the persistence
        # plane (txdb records real TER tokens, not a blanket tesSUCCESS)
        new_lcl.apply_results = _results
        self.round_ms = self._ms_since(self.consensus_start)

        # disputed txns that lost get another shot in the new open ledger
        # (reference: accept reapply :1050-1127). Skip those that were in
        # our own open ledger — close_with_txset already re-applied them —
        # and never skip signature checking: dispute blobs can come from a
        # peer's tx set, which is only root-hash-verified in transit.
        from ..engine.engine import TxParams
        from ..protocol.sttx import SerializedTransaction
        from ..protocol.ter import TER

        skip = {tx.txid() for tx in txs} | self._pre_close_open_ids
        # in canonical order, each account's by sequence (reference: the
        # retriable CanonicalTXSet); the JAX round takes the disputes'
        # order, where a lost run of one account's sequences meets
        # terPRE_SEQ and is held (ROADMAP Queue C)
        retriable = CanonicalTXSet(new_lcl.hash())
        for d in self.disputes.values():
            if d.txid not in skip and d.blob:
                tx = SerializedTransaction.from_bytes(d.blob)
                ok, _why = tx.passes_local_checks()
                if ok:
                    retriable.insert(tx)
        recheck = [tx for _k, tx in retriable.items_sorted()]
        # every signature checked again, in one batch
        for tx, good in zip(recheck, self.check_sigs(recheck)):
            if not good:
                continue
            ter, _ = self.lm.do_transaction(
                tx, TxParams.OPEN_LEDGER | TxParams.RETRY
            )
            if ter == TER.terPRE_SEQ:
                self.lm.add_held_transaction(tx)

        if self.voting is not None:
            self.voting.on_ledger_closed(new_lcl)
        if self.proposing and self.validations.can_sign(new_lcl.seq):
            # can_sign: never a second validation at a seq we already
            # voted (fork repair abstains; see ValidationsStore)
            extra = (
                self.voting.validation_fields(new_lcl)
                if self.voting is not None
                else {}
            )
            val = STValidation.build(
                ledger_hash=new_lcl.hash(),
                signing_time=self.network_time(),
                full=True,
                ledger_seq=new_lcl.seq,
                **extra,
            )
            val.sign(self.key)
            # count our own validation toward quorum (reference: accept
            # stores its own validation before broadcasting :1023-1045)
            self.validations.add(val, local=True)
            self.adapter.send_validation(val)
            self.tracer.instant(
                "consensus.validation_out", "consensus", seq=new_lcl.seq,
            )
        self.lm.check_accept(
            new_lcl.hash(), self.validations.trusted_count_for(new_lcl.hash())
        )
        self.state = ConsensusState.ACCEPTED
        self.tracer.instant(
            "consensus.state", "consensus", seq=self.seq,
            state="ACCEPTED", round_ms=self.round_ms,
        )
        self.adapter.on_accepted(new_lcl, self.round_ms)

    # -- introspection ----------------------------------------------------

    def get_json(self) -> dict:
        return {
            "state": self.state.name,
            "ledger_seq": self.seq,
            "prev_ledger": self.prev_hash.hex(),
            "proposers": len(self.peer_positions),
            "disputes": len(self.disputes),
            "our_position": (
                self.our_position.tx_set_hash.hex()
                if self.our_position
                else None
            ),
            "close_resolution": self.resolution,
        }
