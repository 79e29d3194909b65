"""LedgerProposal: a validator's signed consensus position — "building on
ledger P, my proposed tx set is T, close time C, position number N".

Reference: src/ripple_app/ledger/LedgerProposal.{h,cpp} — signing hash is
the PRP-prefixed hash over (proposeSeq, closeTime, previousLedger,
txSetHash); checkSign at LedgerProposal.h:48.
"""

from __future__ import annotations

from typing import Optional

from ..protocol.keys import KeyPair, verify_signature
from ..protocol.serializer import Serializer
from ..utils.hashes import HP_PROPOSAL, prefix_hash

__all__ = ["LedgerProposal", "BOWOUT_SEQ"]

# a proposer that leaves the round broadcasts this sequence
# (reference: LedgerProposal::seqLeave)
BOWOUT_SEQ = 0xFFFFFFFF


class LedgerProposal:
    def __init__(
        self,
        prev_ledger: bytes,
        propose_seq: int,
        tx_set_hash: bytes,
        close_time: int,
        node_public: bytes = b"",
        signature: bytes = b"",
    ):
        self.prev_ledger = prev_ledger
        self.propose_seq = propose_seq
        self.tx_set_hash = tx_set_hash
        self.close_time = close_time
        self.node_public = node_public
        self.signature = signature
        self._sig_good: Optional[bool] = None

    # -- hashing / signing ------------------------------------------------

    def signing_payload(self) -> bytes:
        s = Serializer()
        s.add32(self.propose_seq)
        s.add32(self.close_time)
        s.add_raw(self.prev_ledger)
        s.add_raw(self.tx_set_hash)
        return s.data()

    def signing_hash(self) -> bytes:
        return prefix_hash(HP_PROPOSAL, self.signing_payload())

    def sign(self, key: KeyPair) -> None:
        self.node_public = key.public
        self.signature = key.sign(self.signing_hash())
        self._sig_good = None

    def check_sign(self) -> bool:
        if self._sig_good is None:
            self._sig_good = verify_signature(
                self.node_public, self.signing_hash(), self.signature
            )
        return self._sig_good

    def set_sig_verdict(self, good: bool) -> None:
        self._sig_good = good

    # -- position updates -------------------------------------------------

    def is_bowout(self) -> bool:
        return self.propose_seq == BOWOUT_SEQ

    def advanced(self, tx_set_hash: bytes, close_time: int) -> "LedgerProposal":
        """Our next position in the same round (reference:
        LedgerProposal::changePosition)."""
        return LedgerProposal(
            self.prev_ledger, self.propose_seq + 1, tx_set_hash, close_time
        )

    def bowout(self) -> "LedgerProposal":
        return LedgerProposal(
            self.prev_ledger, BOWOUT_SEQ, self.tx_set_hash, self.close_time
        )

    def suppression_id(self) -> bytes:
        """Relay dedup key: hash over position *and* signer
        (reference: proposal suppression in NetworkOPs::processProposal)."""
        s = Serializer()
        s.add_raw(self.signing_payload())
        s.add_vl(self.node_public)
        s.add_vl(self.signature)
        return prefix_hash(HP_PROPOSAL, s.data())

    def __repr__(self):
        return (
            f"LedgerProposal(prev={self.prev_ledger.hex()[:8]} "
            f"seq={self.propose_seq} set={self.tx_set_hash.hex()[:8]} "
            f"ct={self.close_time})"
        )
