"""SimNet: a deterministic, discrete-time, in-process validator network.

Reference: src/ripple/testoverlay (templated in-memory P2P net with
discrete time steps; SURVEY §4.2) and the peerfinder sim — the way the
reference tests multi-node behavior without sockets. Messages travel as
real wire frames (overlay.wire), so the codec and the consensus logic are
exercised together; only the transport is simulated.

Topology is a full mesh by default; links can be cut (partitions) and
given per-step latency. Time advances only via `step()`, so every run is
bit-for-bit reproducible.

Fault plane (the testkit scenario runner drives these): per-link
drop/duplicate/extra-delay/jitter probabilities from ONE seeded RNG
(`seed=` — identical seed, identical fault pattern), validator
kill/revive (a down node neither sends, receives, nor ticks — in-flight
messages to it are discarded at delivery), and per-SOURCE frame readers
so one peer's malformed bytes can never desync another peer's framing
(the TCP overlay gets this isolation from per-session sockets; the
simulated transport must provide it explicitly).
"""

from __future__ import annotations

import heapq
import itertools
import random
import struct
from typing import Callable, Optional

from ..consensus.consensus import ConsensusAdapter
from ..consensus.txset import TxSet
from ..consensus.validation import STValidation
from ..node.validator import ValidatorNode
from ..protocol.keys import KeyPair
from ..protocol.sttx import SerializedTransaction
from ..state.ledger import Ledger
from ..utils.hashes import sha512_half
from .resource import (
    FEE_BAD_DATA,
    FEE_INVALID_REQUEST,
    FEE_UNWANTED_DATA,
    Disposition,
    ResourceManager,
)
from .followertree import plan_tree, tree_stats
from .squelch import SQUELCH_ROTATE, SquelchPolicy
from .wire import (
    FrameReader,
    GetLedger,
    GetSegments,
    LedgerData,
    ProposeSet,
    SegmentData,
    TraceContext,
    TxMessage,
    TxSetData,
    ValidationMessage,
    frame,
)

__all__ = ["SimNet", "SimValidator", "RelayPeer"]

# network-epoch start time for simulations (seconds since 2000)
SIM_START_NTIME = 10_000_000


class SimValidator(ConsensusAdapter):
    """One simulated validator: a real ValidatorNode wired to the SimNet
    through the ConsensusAdapter seam."""

    def __init__(
        self,
        net: "SimNet",
        nid: int,
        key: KeyPair,
        unl: set[bytes],
        quorum: int,
        idle_interval: int,
        proposing: bool = True,
        voting=None,
        follower: bool = False,
    ):
        self.net = net
        self.nid = nid
        # one reader per SOURCE: a byzantine peer's garbage must desync
        # only its own stream, exactly like a per-session TCP socket
        self.readers: dict[int, FrameReader] = {}
        # enforced resource pricing (set by the net when enabled): one
        # decaying charge balance per SOURCE nid; DROP refuses further
        # deliveries until the balance decays (disconnect + gated
        # readmission, collapsed onto the simulated transport)
        self.resources: Optional[ResourceManager] = None
        # squelch policy (set by the net when squelch_size > 0)
        self.squelch: Optional[SquelchPolicy] = None
        # cascading follower tree: nid of the preferred upstream for
        # ledger acquisition (None = anycast over the validator core,
        # the flat-tier behavior); set by the net from plan_tree()
        self.upstream: Optional[int] = None
        self.node = ValidatorNode(
            key=key,
            unl=unl,
            adapter=self,
            quorum=quorum,
            network_time=net.network_time,
            clock=net.clock,
            idle_interval=idle_interval,
            proposing=proposing,
            voting=voting,
            follower=follower,
        )

    # -- cross-node trace propagation (no-ops while the module tracer
    # keeps propagate=0, the simnet default — wire bytes and scorecards
    # stay bit-identical) --------------------------------------------------

    def _trace_stamp(self, msg, txid=None, seq=None) -> None:
        ctx = self.node.lm.tracer.wire_context(txid=txid, seq=seq)
        if ctx is not None:
            msg.trace_ctx = TraceContext(*ctx)

    def _trace_adopt(self, msg) -> None:
        ctx = getattr(msg, "trace_ctx", None)
        if ctx is None:
            return
        tracer = self.node.lm.tracer
        if not (tracer.enabled and tracer.propagate):
            msg.trace_ctx = None  # re-relays stay legacy bytes
            return
        if ctx.sampled:
            tracer.adopt_context(tracer.trace_key(ctx.trace), ctx.parent)

    # -- ConsensusAdapter -------------------------------------------------

    def propose(self, proposal) -> None:
        msg = ProposeSet.from_proposal(proposal)
        if self.node.round is not None:
            self._trace_stamp(msg, seq=getattr(self.node.round, "seq", None))
        data = frame(msg)
        if self.squelch is not None:
            self.net.relay_validator(
                self.nid, proposal.node_public or self.node.key.public,
                data, self.squelch, kind="relay_proposal",
            )
        else:
            self.net.broadcast(self.nid, data)

    def share_tx_set(self, txset: TxSet) -> None:
        blobs = [blob for _txid, blob in txset.blobs()]
        self.net.broadcast(self.nid, frame(TxSetData(txset.hash(), blobs)))

    def acquire_tx_set(self, set_hash: bytes) -> Optional[TxSet]:
        return self.node.txset_cache.get(set_hash)

    def send_validation(self, val: STValidation) -> None:
        vmsg = ValidationMessage(val.serialize())
        self._trace_stamp(vmsg, seq=val.ledger_seq)
        data = frame(vmsg)
        if self.squelch is not None:
            self.net.relay_validator(
                self.nid, val.signer or self.node.key.public, data,
                self.squelch, kind="relay_validation",
            )
        else:
            self.net.broadcast(self.nid, data)

    def relay_disputed_tx(self, blob: bytes) -> None:
        self.net.broadcast(self.nid, frame(TxMessage(blob)))

    def request_ledger_data(self, msg: GetLedger) -> None:
        # cascading follower tree: a follower with a named upstream
        # acquires ledgers from THAT follower (leader egress stays
        # O(direct children)); when every ancestor is dead the net
        # resolves None and we re-home onto the validator anycast
        if self.upstream is not None:
            dst = self.net.upstream_for(self.nid)
            if dst is not None:
                self.net.send(self.nid, dst, frame(msg))
                return
        # anycast to one peer, rotating (reference: PeerSet picks a peer
        # per request); broadcasting would multiply reply waves by N-1
        self._acq_rr = getattr(self, "_acq_rr", 0) + 1
        n = len(self.net.validators)
        for step in range(1, n):
            dst = (self.nid + self._acq_rr + step) % n
            if dst != self.nid:
                self.net.send(self.nid, dst, frame(msg))
                return

    def on_accepted(self, ledger: Ledger, round_ms: int) -> None:
        self.net.on_ledger_accepted(self.nid, ledger)
        self.node.round_accepted(ledger, round_ms)

    # -- client side ------------------------------------------------------

    def submit_client_tx(self, tx: SerializedTransaction) -> None:
        """Client submission: apply locally, flood to peers
        (reference: NetworkOPs::processTransaction relay tail)."""
        self.node.submit(tx)
        msg = TxMessage(tx.serialize())
        self._trace_stamp(msg, txid=tx.txid())
        self.net.broadcast(self.nid, frame(msg))

    # -- delivery ---------------------------------------------------------

    def deliver(self, src: int, data: bytes) -> None:
        if self.resources is not None and not self.resources.should_admit(
            (src,)
        ):
            # endpoint above the DROP line: the session analog is a
            # disconnect + refused readmission until the balance decays
            self.resources.note_refused((src,))
            self.net.note_refusal(self.nid, src)
            return
        reader = self.readers.setdefault(src, FrameReader())
        try:
            msgs = list(reader.feed(data))
        except ValueError:
            # malformed frame / out-of-schema type: drop THIS source's
            # stream state (a real session would disconnect), count the
            # offense, keep every other peer's framing intact
            self.readers[src] = FrameReader()
            self.node.note_byzantine("malformed_frame", peer_nid=src)
            self._charge(src, FEE_INVALID_REQUEST)
            return
        if self.resources is not None and msgs and self.resources.is_throttled(
            (src,)
        ):
            # WARN throttling: shed the endpoint's tx gossip before any
            # parse/verify work; consensus traffic still flows. Shed
            # traffic still pays, so a sustained flood walks past WARN
            # to DROP instead of parking at the throttle forever.
            kept = [m for m in msgs if not isinstance(m, TxMessage)]
            if len(kept) != len(msgs):
                from .resource import Charge

                n_shed = len(msgs) - len(kept)
                self.resources.note_throttled(n_shed)
                self._charge(src, Charge(
                    FEE_UNWANTED_DATA.cost * n_shed, "throttled flood"
                ))
                msgs = kept
        # one delivery often carries several relayed txs: parse each
        # once and batch their signature verification through the plane
        # before dispatching. An unparseable tx drops only ITSELF —
        # the rest of the delivery still dispatches.
        parsed: dict[int, SerializedTransaction] = {}
        for i, m in enumerate(msgs):
            if isinstance(m, TxMessage):
                try:
                    parsed[i] = SerializedTransaction.from_bytes(m.blob)
                except Exception:  # noqa: BLE001 — malformed relay
                    self._charge(src, FEE_BAD_DATA)
        if len(parsed) > 1:
            # an error of the verify plane (a failed launch, a wedged
            # card) propagates: no per-tx path verifies in its place
            self.node.prefetch_tx_sigs(list(parsed.values()))
        for i, msg in enumerate(msgs):
            if isinstance(msg, TxMessage):
                if i in parsed:
                    self._trace_adopt(msg)
                    self.node.handle_tx(parsed[i])
            else:
                self._dispatch(src, msg)

    def _charge(self, src: int, fee) -> None:
        if self.resources is None:
            return
        if self.resources.charge((src,), fee) == Disposition.DROP:
            self.resources.note_disconnect()

    def _dispatch(self, src: int, msg) -> None:
        node = self.node
        self._trace_adopt(msg)
        # TxMessages are handled (parse-once + batched sig prefetch) in
        # deliver(), the only caller
        if isinstance(msg, ProposeSet):
            if self.squelch is not None:
                data = frame(msg)
                is_new, dup = node.router.note_peer(sha512_half(data), src)
                if dup:
                    self._charge(src, FEE_UNWANTED_DATA)
                if is_new and node.handle_proposal(msg.to_proposal()):
                    self.net.relay_validator(
                        self.nid, msg.node_public, data, self.squelch,
                        exclude=(src,), kind="relay_proposal",
                    )
            else:
                node.handle_proposal(msg.to_proposal())
        elif isinstance(msg, ValidationMessage):
            if self.squelch is not None:
                data = frame(msg)
                is_new, dup = node.router.note_peer(sha512_half(data), src)
                if dup:
                    self._charge(src, FEE_UNWANTED_DATA)
                if is_new:
                    val = STValidation.from_bytes(msg.blob)
                    if node.handle_validation(val):
                        self.net.relay_validator(
                            self.nid, val.signer or b"", data, self.squelch,
                            exclude=(src,), kind="relay_validation",
                        )
            else:
                node.handle_validation(STValidation.from_bytes(msg.blob))
        elif isinstance(msg, TxSetData):
            from ..consensus.txset import MAX_TXSET_BLOBS

            if len(msg.tx_blobs) > MAX_TXSET_BLOBS:
                # oversized candidate set: refuse before parsing a single
                # blob (a byzantine peer must not buy O(huge) parse work)
                node.note_byzantine("oversized_txset", peer_nid=src)
                self._charge(src, FEE_BAD_DATA)
                return
            ts = TxSet(node.hash_batch)
            intact = True
            for blob in msg.tx_blobs:
                try:
                    tx = SerializedTransaction.from_bytes(blob)
                except Exception:  # noqa: BLE001 — hostile blob
                    intact = False
                    break
                ts.add(tx.txid(), blob)
            if intact and ts.hash() == msg.set_hash:  # recomputed root
                node.handle_txset(ts)
            else:
                node.note_byzantine("txset_mismatch", peer_nid=src)
                self._charge(src, FEE_BAD_DATA)
        elif isinstance(msg, GetSegments):
            reply = node.serve_get_segments(msg)
            if reply is not None:
                if msg.trace_ctx is not None:
                    reply.trace_ctx = msg.trace_ctx
                self.net.send(self.nid, src, frame(reply))
        elif isinstance(msg, SegmentData):
            node.handle_segment_data(src, msg)
        elif isinstance(msg, GetLedger):
            reply = node.serve_get_ledger(msg)
            if reply is not None:
                self.net.send(self.nid, src, frame(reply))
        elif isinstance(msg, LedgerData):
            node.handle_ledger_data(msg)


class RelayPeer:
    """A lightweight non-validator overlay node for production-fan-in
    scenarios: it parses wire frames, dedups, enforces resource pricing
    on its sources, and re-relays validator messages through squelch
    subsets — WITHOUT running consensus or verifying signatures. This is
    what makes 500-1000-node simnets tractable: the validator core stays
    full ValidatorNodes, the fan-in tier costs a frame parse + k sends
    per message. Client txs are NOT re-relayed (the injection path
    already floods them to every node), so the relay tier's traffic is
    exactly the squelched proposal/validation gossip the scenario
    measures."""

    SEEN_CAP = 8192

    def __init__(self, net: "SimNet", nid: int):
        self.net = net
        self.nid = nid
        self.readers: dict[int, FrameReader] = {}
        # message hash -> set of sources that delivered it (bounded,
        # insertion-ordered eviction) — the HashRouter role
        self.seen: dict[bytes, set[int]] = {}
        self.resources: Optional[ResourceManager] = None
        self.squelch: Optional[SquelchPolicy] = None
        self.malformed = 0

    def _charge(self, src: int, fee) -> None:
        if self.resources is not None:
            self.resources.charge((src,), fee)

    def _note_seen(self, h: bytes, src: int) -> tuple[bool, bool]:
        sources = self.seen.get(h)
        if sources is None:
            if len(self.seen) >= self.SEEN_CAP:
                self.seen.pop(next(iter(self.seen)))
            self.seen[h] = {src}
            return True, False
        dup = src in sources
        sources.add(src)
        return False, dup

    def deliver(self, src: int, data: bytes) -> None:
        if self.resources is not None and not self.resources.should_admit(
            (src,)
        ):
            self.resources.note_refused((src,))
            self.net.note_refusal(self.nid, src)
            return
        reader = self.readers.setdefault(src, FrameReader())
        try:
            msgs = list(reader.feed(data))
        except ValueError:
            self.readers[src] = FrameReader()
            self.malformed += 1
            self._charge(src, FEE_INVALID_REQUEST)
            return
        throttled = (
            self.resources is not None
            and bool(msgs)
            and self.resources.is_throttled((src,))
        )
        for msg in msgs:
            if isinstance(msg, ProposeSet):
                self._relay(src, msg, msg.node_public)
            elif isinstance(msg, ValidationMessage):
                try:
                    signer = STValidation.from_bytes(msg.blob).signer or b""
                except Exception:  # noqa: BLE001 — hostile blob
                    self._charge(src, FEE_BAD_DATA)
                    continue
                self._relay(src, msg, signer)
            elif isinstance(msg, TxMessage) and throttled:
                self.resources.note_throttled()
                self._charge(src, FEE_UNWANTED_DATA)  # shed traffic pays

    def _relay(self, src: int, msg, signer: bytes) -> None:
        data = frame(msg)
        is_new, dup = self._note_seen(sha512_half(data), src)
        if dup:
            self._charge(src, FEE_UNWANTED_DATA)
        if is_new and self.squelch is not None:
            kind = (
                "relay_proposal" if isinstance(msg, ProposeSet)
                else "relay_validation"
            )
            self.net.relay_validator(
                self.nid, signer, data, self.squelch,
                exclude=(src,), kind=kind,
            )


class SimNet:
    def __init__(
        self,
        n_validators: int = 4,
        quorum: Optional[int] = None,
        latency_steps: int = 1,
        step_ms: int = 1000,
        idle_interval: int = 4,
        genesis_account: Optional[bytes] = None,
        voting_factory=None,
        seed: int = 0,
        n_peers: int = 0,
        squelch_size: int = 0,
        squelch_rotate: int = SQUELCH_ROTATE,
        resources: bool = False,
        n_followers: int = 0,
        follower_branching: int = 0,
    ):
        self.step_ms = step_ms
        self.latency_ms = latency_steps * step_ms
        self.time_ms = 0
        self._seq = itertools.count()
        # (deliver_at_ms, seq, dst, bytes)
        self._queue: list = []
        self._links_down: set[tuple[int, int]] = set()
        # fault plane: ONE seeded stream drives every probabilistic
        # fault, so a given seed replays the identical fault pattern
        self.seed = seed
        self.rng = random.Random(0x5EED ^ seed)
        # (src, dst) -> {"drop": p, "dup": p, "delay_steps": n,
        #               "jitter_steps": n} (directional)
        self._link_faults: dict[tuple[int, int], dict] = {}
        self._down: set[int] = set()
        self.net_stats = {
            "sent": 0, "dropped_link": 0, "dropped_fault": 0,
            "dropped_down": 0, "duplicated": 0, "delayed": 0,
        }
        # src nid -> set of dsts that refused its deliveries (DROP gate)
        self.refusals: dict[int, set[int]] = {}
        # src nid -> virtual ms of the FIRST refusal (drop latency: how
        # long a flooder ran before the first honest node shut the door)
        self.first_refusal_ms: dict[int, int] = {}
        self.accept_log: list[tuple[int, int, bytes]] = []  # (nid, seq, hash)

        self.keys = [
            KeyPair.from_passphrase(f"sim-validator-{i}")
            for i in range(n_validators)
        ]
        unl = {k.public for k in self.keys}
        self.unl = unl
        self.idle_interval = idle_interval
        q = quorum if quorum is not None else (n_validators * 3 + 3) // 4
        self.validators = [
            SimValidator(
                self,
                i,
                self.keys[i],
                unl,
                q,
                idle_interval,
                voting=voting_factory(i) if voting_factory else None,
            )
            for i in range(n_validators)
        ]
        # production fan-in shape: a small trusted validator core plus a
        # relay-peer tier (nids n_validators..n_validators+n_peers-1)
        self.peers = [
            RelayPeer(self, n_validators + j) for j in range(n_peers)
        ]
        # follower tier ([node] mode=follower, the read plane):
        # non-consensus full nodes (nids after the relay tier) whose
        # chains advance ONLY by ingesting trusted validations and
        # acquiring the validated ledgers — scenarios partition/kill
        # them like any node and assert they end on the honest chain
        self.followers = [
            SimValidator(
                self, n_validators + n_peers + j,
                KeyPair.from_passphrase(f"sim-follower-{j}"),
                unl, q, idle_interval, follower=True,
            )
            for j in range(n_followers)
        ]
        self.nodes: list = (
            list(self.validators) + list(self.peers) + list(self.followers)
        )
        # cascading follower tree (0 = flat tier, every follower
        # anycasts to the validator core — byte-for-byte the pre-tree
        # behavior): plan_tree assigns each follower a parent; tier-1
        # followers (parent -1) keep upstream=None (they ARE the
        # leader's direct children), deeper tiers prefer their parent
        # follower for ledger acquisition and re-home upward on kill
        self.follower_branching = int(follower_branching)
        self.tree_parents: list[int] = []
        if follower_branching > 0 and n_followers > 0:
            self.tree_parents = plan_tree(n_followers, follower_branching)
            base = n_validators + n_peers
            for j, p in enumerate(self.tree_parents):
                if p >= 0:
                    self.followers[j].upstream = base + p
            # materialized only for tree nets: legacy scorecards keep
            # their exact net_stats shape
            self.net_stats["rehomed"] = 0
        # validator-message squelching (0 = full flood, byte-for-byte
        # today's behavior — the [overlay] squelch=0 kill-switch)
        self.squelch_size = squelch_size
        self.squelch_rotate = squelch_rotate
        self.resources_enabled = resources
        if squelch_size > 0 or resources:
            # fan-out / defense evidence (only materialized when the
            # defense plane is on, so legacy scorecards stay identical)
            self.net_stats.update({
                "relay_proposal": 0, "relay_validation": 0,
                "relay_fanout_max": 0, "refused": 0,
            })
        for node in self.nodes:
            if squelch_size > 0:
                node.squelch = SquelchPolicy(
                    size=squelch_size, rotate=squelch_rotate,
                    relayer_id=struct.pack(">I", node.nid),
                )
            if resources:
                node.resources = ResourceManager(
                    key_fn=lambda a: a[0], clock=self.clock,
                )
        self.genesis_account = genesis_account

    # -- clocks -----------------------------------------------------------

    def clock(self) -> float:
        return self.time_ms / 1000.0

    def network_time(self) -> int:
        return SIM_START_NTIME + self.time_ms // 1000

    # -- topology ---------------------------------------------------------

    def cut_link(self, a: int, b: int) -> None:
        self._links_down.add((a, b))
        self._links_down.add((b, a))

    def heal_link(self, a: int, b: int) -> None:
        self._links_down.discard((a, b))
        self._links_down.discard((b, a))

    def partition(self, group_a: set[int], group_b: set[int]) -> None:
        for a in group_a:
            for b in group_b:
                self.cut_link(a, b)

    def set_link_fault(
        self,
        a: int,
        b: int,
        drop: float = 0.0,
        dup: float = 0.0,
        delay_steps: int = 0,
        jitter_steps: int = 0,
        bidirectional: bool = True,
    ) -> None:
        """Degrade a link: `drop`/`dup` are per-message probabilities,
        `delay_steps` adds fixed latency, `jitter_steps` adds a uniform
        random extra delay (which also REORDERS messages relative to the
        base-latency ones — heapq delivery is by arrival time)."""
        fault = {
            "drop": drop, "dup": dup,
            "delay_steps": delay_steps, "jitter_steps": jitter_steps,
        }
        self._link_faults[(a, b)] = fault
        if bidirectional:
            self._link_faults[(b, a)] = dict(fault)

    def clear_link_fault(self, a: int, b: int) -> None:
        self._link_faults.pop((a, b), None)
        self._link_faults.pop((b, a), None)

    # -- follower tree ----------------------------------------------------

    def upstream_for(self, nid: int) -> Optional[int]:
        """Resolve a tree follower's LIVE upstream: its parent if up,
        else walk up the ancestor chain (re-home onto the grandparent,
        then great-grandparent, ... then the leader). Returns None for
        non-tree nodes or when the walk reaches the leader tier — the
        caller falls back to the validator anycast, which IS the
        leader re-home."""
        if not self.tree_parents:
            return None
        base = len(self.validators) + len(self.peers)
        j = nid - base
        if not (0 <= j < len(self.tree_parents)):
            return None
        p = self.tree_parents[j]
        hops = 0
        while p >= 0:
            dst = base + p
            if dst not in self._down:
                if hops:
                    self.net_stats["rehomed"] += 1
                return dst
            hops += 1
            p = self.tree_parents[p]
        if hops:
            self.net_stats["rehomed"] += 1
        return None

    def tree_json(self) -> dict:
        """Tree-shape + re-home evidence for the scenario scorecard."""
        out = tree_stats(self.tree_parents, self.follower_branching)
        out["rehomed"] = self.net_stats.get("rehomed", 0)
        return out

    # -- validator kill/revive --------------------------------------------

    def kill(self, nid: int) -> None:
        """Silence a validator: no sends, no deliveries, no timer ticks.
        In-flight messages TO it are discarded at delivery time (a dead
        process loses its socket buffers)."""
        self._down.add(nid)

    def revive(self, nid: int) -> None:
        self._down.discard(nid)

    def is_down(self, nid: int) -> bool:
        return nid in self._down

    # -- transport --------------------------------------------------------

    def broadcast(self, src: int, data: bytes) -> None:
        for dst in range(len(self.nodes)):
            if dst != src:
                self.send(src, dst, data)

    def sim_seq(self) -> int:
        """Approximate ledger cadence for the squelch epoch clock: the
        deterministic virtual-time analog of 'rotate every N ledgers'."""
        return self.time_ms // max(1, self.step_ms * self.idle_interval)

    def relay_validator(
        self, src: int, signer: bytes, data: bytes, policy: SquelchPolicy,
        exclude: tuple = (), kind: str = "relay_proposal",
    ) -> None:
        """Squelched fan-out of one validator message: the deterministic
        rotating subset for (signer, epoch, relayer) plus the validator
        core; untrusted signers demoted. Fan-out evidence rides
        net_stats so scenarios can assert the bound. The subset ranks
        over ALL other nodes and the message's source is filtered from
        the RESULT (excluding it from the ranking input would alias the
        policy memo across sources — same candidate count, different
        members — echoing relays back to their sender for an epoch)."""
        n_val = len(self.validators)
        cands = [i for i in range(len(self.nodes)) if i != src]
        subset = policy.subset(
            signer, self.sim_seq(), cands,
            key_fn=lambda i: struct.pack(">I", i),
            trusted=lambda i: i < n_val,
            demoted=bool(signer) and signer not in self.unl,
        )
        targets = [dst for dst in subset if dst not in exclude]
        for dst in targets:
            self.send(src, dst, data)
        self.net_stats[kind] += 1
        if len(targets) > self.net_stats["relay_fanout_max"]:
            self.net_stats["relay_fanout_max"] = len(targets)

    def note_refusal(self, dst: int, src: int) -> None:
        self.net_stats["refused"] = self.net_stats.get("refused", 0) + 1
        self.refusals.setdefault(src, set()).add(dst)
        self.first_refusal_ms.setdefault(src, self.time_ms)

    def resource_json(self) -> dict:
        """`resource.*` evidence aggregated over every enforcing node —
        the counter block flood scenarios assert on (charges paid, WARN
        crossings, DROP crossings, shed messages, refused deliveries)."""
        agg = {
            "charged": 0, "warned": 0, "dropped": 0,
            "refused": 0, "throttled": 0,
        }
        for node in self.nodes:
            rm = node.resources
            if rm is None:
                continue
            agg["charged"] += rm.charged
            agg["warned"] += rm.warned
            agg["dropped"] += rm.dropped
            agg["refused"] += rm.refused
            agg["throttled"] += rm.throttled
        agg["refusing_nodes"] = {
            src: len(dsts) for src, dsts in sorted(self.refusals.items())
        }
        return agg

    def send(self, src: int, dst: int, data: bytes) -> None:
        if src in self._down or dst in self._down:
            self.net_stats["dropped_down"] += 1
            return
        if (src, dst) in self._links_down:
            self.net_stats["dropped_link"] += 1
            return
        self.net_stats["sent"] += 1
        delay_ms = self.latency_ms
        fault = self._link_faults.get((src, dst))
        copies = 1
        if fault is not None:
            # exposure evidence for the scenario plane's anti-vacuity
            # check: the fault was ARMED on live traffic (whether any
            # message then dropped/duplicated is probabilistic — a
            # lucky streak must not read as a silently-dead fault).
            # Key materializes lazily so legacy nets keep their shape.
            self.net_stats["fault_exposed"] = (
                self.net_stats.get("fault_exposed", 0) + 1
            )
            if fault["drop"] and self.rng.random() < fault["drop"]:
                self.net_stats["dropped_fault"] += 1
                return
            if fault["dup"] and self.rng.random() < fault["dup"]:
                copies = 2
                self.net_stats["duplicated"] += 1
            extra = fault["delay_steps"]
            if fault["jitter_steps"]:
                extra += self.rng.randrange(fault["jitter_steps"] + 1)
            if extra:
                delay_ms += extra * self.step_ms
                self.net_stats["delayed"] += 1
        for _ in range(copies):
            heapq.heappush(
                self._queue,
                (self.time_ms + delay_ms, next(self._seq), dst, src, data),
            )

    def on_ledger_accepted(self, nid: int, ledger: Ledger) -> None:
        self.accept_log.append((nid, ledger.seq, ledger.hash()))

    # -- simulation loop --------------------------------------------------

    def start(self) -> None:
        if self.genesis_account is None:
            # the well-known test genesis account (node.MASTER_PASSPHRASE)
            self.genesis_account = KeyPair.from_passphrase(
                "masterpassphrase"
            ).account_id
        root = self.genesis_account
        for v in self.validators:
            v.node.start(root, close_time=self.network_time())
        for f in self.followers:
            f.node.start(root, close_time=self.network_time())

    def step(self, n: int = 1) -> None:
        for _ in range(n):
            self.time_ms += self.step_ms
            while self._queue and self._queue[0][0] <= self.time_ms:
                _at, _seq, dst, src, data = heapq.heappop(self._queue)
                if dst in self._down:
                    # a dead process loses its socket buffers; messages
                    # already in flight FROM a freshly-killed node still
                    # arrive (they left its kernel before the crash)
                    self.net_stats["dropped_down"] += 1
                    continue
                self.nodes[dst].deliver(src, data)
            for v in self.validators:
                if v.nid not in self._down:
                    v.node.on_timer()
            for f in self.followers:
                if f.nid not in self._down:
                    f.node.on_timer()

    def run_until(
        self, pred: Callable[[], bool], max_steps: int = 200
    ) -> bool:
        for _ in range(max_steps):
            if pred():
                return True
            self.step()
        return pred()

    # -- assertions helpers ----------------------------------------------

    def validated_seqs(self) -> list[int]:
        return [
            v.node.lm.validated.seq if v.node.lm.validated else 0
            for v in self.validators
        ]

    def validated_hashes_at(self, seq: int) -> set[bytes]:
        out = set()
        for v in self.validators:
            h = v.node.lm.ledger_history.get(seq)
            if h is not None:
                out.add(h)
        return out

    def all_validated_at_least(self, seq: int) -> bool:
        return all(s >= seq for s in self.validated_seqs())
