"""ByzantineValidator: a trusted-but-hostile simnet validator slot.

It runs a REAL ValidatorNode (so its equivocations carry valid
signatures from a key every honest node trusts — the dangerous case)
and corrupts its outputs per behavior profile:

    equivocate       sign a second, conflicting proposal per position
                     and send both to a subset of peers
    duplicate        re-send every proposal and validation frame
    forge            emit validations signed by a NON-UNL rogue key and
                     validations with corrupted signatures
    stale            emit trusted-key validations with signing times far
                     outside the currency window (replayed history)
    garbage          send malformed frames (absurd length prefixes,
                     out-of-schema message types)
    oversized        send candidate tx sets past MAX_TXSET_BLOBS

Honest nodes must (a) keep converging on one chain and (b) prove via
``defense`` counters + tracer events that each hostile input was seen
and neutralized — the anti-vacuity half of every byzantine scenario.
"""

from __future__ import annotations

import random

from ..consensus.proposal import LedgerProposal
from ..consensus.txset import MAX_TXSET_BLOBS
from ..consensus.validation import STValidation
from ..overlay.simnet import RelayPeer, SimValidator
from ..overlay.wire import ProposeSet, TxSetData, ValidationMessage, frame
from ..protocol.keys import KeyPair

__all__ = ["ByzantineValidator", "BEHAVIORS", "FlooderPeer",
           "FLOOD_BEHAVIORS"]

BEHAVIORS = (
    "equivocate", "duplicate", "forge", "stale", "garbage", "oversized",
)


class ByzantineValidator(SimValidator):
    def __init__(self, net, nid, key, unl, quorum, idle_interval,
                 behaviors=BEHAVIORS, seed: int = 0, **kw):
        super().__init__(net, nid, key, unl, quorum, idle_interval, **kw)
        self.behaviors = frozenset(behaviors)
        self.rng = random.Random(0xB42 ^ seed ^ nid)
        self.rogue = KeyPair.from_passphrase(f"byz-rogue-{seed}-{nid}")
        self.emitted: dict[str, int] = {b: 0 for b in self.behaviors}
        self._sent_validations: list[bytes] = []

    def _others(self) -> list[int]:
        return [i for i in range(len(self.net.validators)) if i != self.nid]

    def _emit(self, behavior: str) -> None:
        self.emitted[behavior] = self.emitted.get(behavior, 0) + 1

    # -- corrupted adapter outputs ----------------------------------------

    def propose(self, proposal) -> None:
        data = frame(ProposeSet.from_proposal(proposal))
        for dst in self._others():
            self.net.send(self.nid, dst, data)
        if "duplicate" in self.behaviors:
            self._emit("duplicate")
            self.net.send(self.nid, self._others()[0], data)
        if "equivocate" in self.behaviors:
            # a SIGNED conflicting position at the same propose_seq —
            # sent to peers that also saw the real one, so the
            # conflicting-proposal defense actually fires
            fake = LedgerProposal(
                prev_ledger=proposal.prev_ledger,
                propose_seq=proposal.propose_seq,
                tx_set_hash=bytes([proposal.propose_seq & 0xFF] * 32),
                close_time=proposal.close_time,
            )
            fake.sign(self.node.key)
            fdata = frame(ProposeSet.from_proposal(fake))
            self._emit("equivocate")
            for dst in self._others()[: max(1, len(self._others()) // 2)]:
                self.net.send(self.nid, dst, fdata)

    def send_validation(self, val) -> None:
        data = frame(ValidationMessage(val.serialize()))
        self.net.broadcast(self.nid, data)
        self._sent_validations.append(val.serialize())
        if "duplicate" in self.behaviors:
            self._emit("duplicate")
            self.net.send(self.nid, self._others()[0], data)
        if "forge" in self.behaviors:
            self._emit("forge")
            # same statement signed by a key nobody trusts
            rogue = STValidation.from_bytes(val.serialize())
            rogue.sign(self.rogue)
            self.net.broadcast(
                self.nid, frame(ValidationMessage(rogue.serialize()))
            )
            # and a trusted-key statement with a corrupted signature
            broken = STValidation.from_bytes(val.serialize())
            sig = bytearray(broken.signature)
            sig[0] ^= 0xFF
            from ..protocol.sfields import sfSignature

            broken.obj[sfSignature] = bytes(sig)
            broken.set_sig_verdict(None)
            self.net.broadcast(
                self.nid, frame(ValidationMessage(broken.serialize()))
            )

    # -- per-step active hostility ----------------------------------------

    def act(self, step: int) -> None:
        """Called by the scenario runner once per step, BEFORE net.step().
        Deterministic: all randomness rides this validator's seeded rng."""
        others = self._others()
        if "garbage" in self.behaviors and step % 7 == 3:
            self._emit("garbage")
            dst = others[self.rng.randrange(len(others))]
            if self.rng.random() < 0.5:
                # absurd length prefix: FrameReader raises "oversized"
                self.net.send(self.nid, dst, b"\xff\xff\xff\xff\x00\x1e")
            else:
                # out-of-schema message type (mt 99)
                self.net.send(
                    self.nid, dst,
                    (3).to_bytes(4, "big") + (99).to_bytes(2, "big")
                    + b"\x00\x01\x02",
                )
        if "oversized" in self.behaviors and step % 11 == 5:
            self._emit("oversized")
            dst = others[self.rng.randrange(len(others))]
            msg = TxSetData(
                bytes(32), [b"j"] * (MAX_TXSET_BLOBS + 1)
            )
            self.net.send(self.nid, dst, frame(msg))
        if "stale" in self.behaviors and step % 9 == 4:
            self._emit("stale")
            from ..consensus.timing import LEDGER_VAL_INTERVAL

            lcl = self.node.lm.closed_ledger()
            old = STValidation.build(
                lcl.hash(),
                signing_time=max(
                    1, self.net.network_time() - LEDGER_VAL_INTERVAL - 30
                ),
                ledger_seq=lcl.seq,
            )
            old.sign(self.node.key)
            self.net.broadcast(
                self.nid, frame(ValidationMessage(old.serialize()))
            )


FLOOD_BEHAVIORS = ("garbage_flood", "dup_flood", "junk_tx_flood")


class FlooderPeer(RelayPeer):
    """A hostile relay-tier peer for the production-fan-in scenarios:
    it floods honest nodes at a configurable burst rate with

        garbage_flood    malformed frames — absurd length prefixes and
                         out-of-schema message types (FEE_INVALID_REQUEST
                         per frame at every receiver)
        dup_flood        the SAME fabricated proposal frame re-sent to
                         the same targets every step — the same-source
                         duplicate signature the resource plane prices
                         (FEE_UNWANTED_DATA per re-send)
        junk_tx_flood    TxMessage frames carrying unparseable blobs
                         (FEE_BAD_DATA at every validator that tries)

    The defense contract the scenarios assert: every honest node's
    ResourceManager walks this peer's balance to DROP, deliveries from
    it are then REFUSED (disconnect + gated readmission, visible in
    ``net.refusals``/`resource.*` counters), and honest consensus close
    cadence holds within budget of the no-flooder run of the same seed.
    Deterministic: all randomness rides one seeded rng.
    """

    def __init__(self, net, nid: int, behaviors=FLOOD_BEHAVIORS,
                 seed: int = 0, burst: int = 8, fan: int = 16):
        super().__init__(net, nid)
        self.behaviors = frozenset(behaviors)
        self.rng = random.Random(0xF700D ^ seed ^ nid)
        self.burst = burst  # frames per target per step
        self.fan = fan      # targets per step
        self.emitted: dict[str, int] = {b: 0 for b in self.behaviors}
        # one fabricated proposal frame, re-sent forever (the dup flood)
        fake = LedgerProposal(
            prev_ledger=bytes(32), propose_seq=1,
            tx_set_hash=bytes([0xF1] * 32), close_time=1,
        )
        fake.sign(KeyPair.from_passphrase(f"flooder-{seed}-{nid}"))
        self._dup_frame = frame(ProposeSet.from_proposal(fake))
        # a STABLE neighbor set, like a real overlay session list: a
        # flooder hammers the peers it is connected to, which is what
        # walks those endpoints' balances to DROP (spraying one frame
        # across 1000 nodes never crosses any threshold — that shape is
        # the tx-flood economics TxQ already prices). Two validators
        # are always among the victims so the defense evidence lands on
        # the consensus core too.
        self._neighbors: list[int] = []

    def _targets(self) -> list[int]:
        if not self._neighbors:
            n = len(self.net.nodes)
            n_val = len(self.net.validators)
            picks = [v for v in range(min(2, n_val)) if v != self.nid]
            while len(picks) < min(self.fan, n - 1):
                dst = self.rng.randrange(n)
                if dst != self.nid and dst not in picks:
                    picks.append(dst)
            self._neighbors = picks
        return self._neighbors

    def act(self, step: int) -> None:
        """Called by the scenario runner once per step."""
        targets = self._targets()
        if "garbage_flood" in self.behaviors:
            for dst in targets:
                for _ in range(self.burst):
                    self.emitted["garbage_flood"] += 1
                    if self.rng.random() < 0.5:
                        # absurd length prefix: FrameReader raises
                        self.net.send(
                            self.nid, dst, b"\xff\xff\xff\xff\x00\x1e"
                        )
                    else:
                        # out-of-schema message type (mt 99)
                        self.net.send(
                            self.nid, dst,
                            (3).to_bytes(4, "big") + (99).to_bytes(2, "big")
                            + b"\x00\x01\x02",
                        )
        if "dup_flood" in self.behaviors:
            for dst in targets:
                for _ in range(self.burst):
                    self.emitted["dup_flood"] += 1
                    self.net.send(self.nid, dst, self._dup_frame)
        if "junk_tx_flood" in self.behaviors:
            from ..overlay.wire import TxMessage

            for dst in targets:
                for _ in range(self.burst):
                    self.emitted["junk_tx_flood"] += 1
                    blob = bytes(
                        self.rng.randrange(256) for _ in range(24)
                    )
                    self.net.send(self.nid, dst, frame(TxMessage(blob)))
