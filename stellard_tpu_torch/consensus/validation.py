"""STValidation: a validator's signed statement that it built/accepted a
specific ledger.

Reference: src/ripple_app/ledger/SerializedValidation.{h,cpp} — format
(:134-160), getSigningHash with the VAL prefix (:70-73), sign (:54-68),
isValid Ed25519 verify (:90-108, north-star hot call #2).
"""

from __future__ import annotations

from typing import Optional

from ..protocol.keys import KeyPair, verify_signature
from ..protocol.sfields import (
    sfAmendments,
    sfBaseFee,
    sfFlags,
    sfLedgerHash,
    sfLedgerSequence,
    sfLoadFee,
    sfReserveBase,
    sfReserveIncrement,
    sfSignature,
    sfSigningPubKey,
    sfSigningTime,
)
from ..protocol.stobject import STObject
from ..utils.hashes import HP_VALIDATION, prefix_hash

__all__ = ["STValidation", "VF_FULL"]

# flag: this is a full validation (the signer built the ledger through
# consensus), not a partial/catch-up one (reference:
# SerializedValidation.h kFullFlag)
VF_FULL = 0x0001


class STValidation:
    def __init__(self, obj: STObject):
        self.obj = obj
        self._sig_good: Optional[bool] = None
        # set by the receiver, not the wire: did a trusted UNL key sign it
        self.trusted = False

    @classmethod
    def build(
        cls,
        ledger_hash: bytes,
        signing_time: int,
        full: bool = True,
        ledger_seq: Optional[int] = None,
        load_fee: Optional[int] = None,
        base_fee: Optional[int] = None,
        reserve_base: Optional[int] = None,
        reserve_increment: Optional[int] = None,
        amendments: Optional[list[bytes]] = None,
    ) -> "STValidation":
        obj = STObject()
        obj[sfFlags] = VF_FULL if full else 0
        obj[sfLedgerHash] = ledger_hash
        obj[sfSigningTime] = signing_time
        if ledger_seq is not None:
            obj[sfLedgerSequence] = ledger_seq
        if load_fee is not None:
            obj[sfLoadFee] = load_fee
        if base_fee is not None:
            obj[sfBaseFee] = base_fee
        if reserve_base is not None:
            obj[sfReserveBase] = reserve_base
        if reserve_increment is not None:
            obj[sfReserveIncrement] = reserve_increment
        if amendments:
            obj[sfAmendments] = list(amendments)
        return cls(obj)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "STValidation":
        return cls(STObject.from_bytes(blob))

    # -- accessors --------------------------------------------------------

    @property
    def ledger_hash(self) -> bytes:
        return self.obj[sfLedgerHash]

    @property
    def ledger_seq(self) -> Optional[int]:
        return self.obj.get(sfLedgerSequence)

    @property
    def signing_time(self) -> int:
        return self.obj[sfSigningTime]

    @property
    def flags(self) -> int:
        return self.obj.get(sfFlags, 0)

    @property
    def is_full(self) -> bool:
        return bool(self.flags & VF_FULL)

    @property
    def load_fee(self) -> Optional[int]:
        return self.obj.get(sfLoadFee)

    @property
    def base_fee(self) -> Optional[int]:
        return self.obj.get(sfBaseFee)

    @property
    def reserve_base(self) -> Optional[int]:
        return self.obj.get(sfReserveBase)

    @property
    def reserve_increment(self) -> Optional[int]:
        return self.obj.get(sfReserveIncrement)

    @property
    def amendments(self) -> Optional[list[bytes]]:
        return self.obj.get(sfAmendments)

    @property
    def signer(self) -> bytes:
        """The validator's node public key (raw Ed25519)."""
        return self.obj.get(sfSigningPubKey, b"")

    @property
    def signature(self) -> bytes:
        return self.obj.get(sfSignature, b"")

    # -- signing ----------------------------------------------------------

    def serialize(self) -> bytes:
        return self.obj.serialize()

    def signing_hash(self) -> bytes:
        """VAL-prefixed hash of the signing fields
        (reference: SerializedValidation.cpp:70-73)."""
        return self.obj.signing_hash(HP_VALIDATION)

    def sign(self, key: KeyPair) -> None:
        self.obj[sfSigningPubKey] = key.public
        self.obj[sfSignature] = key.sign(self.signing_hash())
        self._sig_good = None

    def is_valid(self) -> bool:
        """reference: SerializedValidation::isValid (:90-108) — the hot
        Ed25519 verify the VerifyPlane batches per consensus round."""
        if self._sig_good is None:
            self._sig_good = verify_signature(
                self.signer, self.signing_hash(), self.signature
            )
        return self._sig_good

    def set_sig_verdict(self, good: bool) -> None:
        self._sig_good = good

    def validation_id(self) -> bytes:
        """Suppression/dedup key for relay (hash of the full blob)."""
        return prefix_hash(HP_VALIDATION, self.serialize())

    def __repr__(self):
        return (
            f"STValidation(ledger={self.ledger_hash.hex()[:8]} "
            f"seq={self.ledger_seq} signer={self.signer.hex()[:8]} "
            f"full={self.is_full})"
        )
