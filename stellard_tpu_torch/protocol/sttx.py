"""SerializedTransaction (STTx): a signed, typed transaction.

Reference: src/ripple_app/misc/SerializedTransaction.{h,cpp} —
getSigningHash (:162-165, HP_TX_SIGN prefix over the no-signature
serialization), sign (:185-190), checkSign (:192-230, the #1 north-star
hot call, memoized), getTransactionID (HP_TXN_ID over the full blob),
passesLocalChecks (:350-369).
"""

from __future__ import annotations

from typing import Optional

from ..utils.hashes import HP_TXN_ID, HP_TX_SIGN, prefix_hash
from .formats import TX_FORMATS, TxType, validate_against
from .keys import KeyPair, verify_signature
from .serializer import BinaryParser
from .sfields import (
    sfAccount,
    sfFee,
    sfFlags,
    sfSequence,
    sfSigningPubKey,
    sfTransactionType,
    sfTxnSignature,
)
from .stamount import STAmount
from .stobject import STObject
from ..utils.hashes import hash160

__all__ = ["SerializedTransaction"]


class SerializedTransaction:
    """Wraps the tx STObject with signing/verification and typed access."""

    def __init__(self, obj: STObject):
        self.obj = obj
        # memoized signature verdict (reference: mSigGood/mSigBad flags,
        # SerializedTransaction.h — the HashRouter SF_SIGGOOD seam)
        self._sig_good: Optional[bool] = None
        # (version, value) memos — txid/blob are recomputed several
        # times per tx along the submit->open-apply->close-apply path;
        # STObject._version keeps the cache safe across mutations
        self._blob_memo: Optional[tuple[int, bytes]] = None
        self._txid_memo: Optional[tuple[int, bytes]] = None
        self._tx_type_memo: Optional[tuple[int, TxType]] = None
        # passes_local_checks is a pure function of the object bytes and
        # runs once per apply — which, with the delta-replay close, is
        # twice per submit (open check pass + speculative close run)
        self._local_memo: Optional[tuple[int, tuple[bool, str]]] = None

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, tx_type: TxType, account: bytes, sequence: int,
              fee: int, fields: Optional[dict] = None) -> "SerializedTransaction":
        obj = STObject()
        obj[sfTransactionType] = int(tx_type)
        obj[sfAccount] = account
        obj[sfSequence] = sequence
        obj[sfFee] = STAmount.from_drops(fee)
        for f, v in (fields or {}).items():
            obj[f] = v
        return cls(obj)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "SerializedTransaction":
        tx = cls(STObject.from_bytes(blob))
        # the received bytes ARE the serialization: the reference keeps
        # the raw Serializer and hashes getTransactionID over it, so a
        # parsed tx must never re-serialize (and txid must cover exactly
        # the wire bytes, even for a non-canonical peer encoding)
        tx._blob_memo = (tx.obj._version, blob)
        return tx

    @classmethod
    def from_parser(cls, p: BinaryParser) -> "SerializedTransaction":
        return cls(STObject.deserialize(p))

    # -- typed accessors --------------------------------------------------

    @property
    def tx_type(self) -> TxType:
        # enum construction is measurable at flood rates; version-guarded
        # like _blob_memo/_txid_memo (the public obj is mutable)
        memo = self._tx_type_memo
        ver = self.obj._version
        if memo is not None and memo[0] == ver:
            return memo[1]
        t = TxType(self.obj[sfTransactionType])
        self._tx_type_memo = (ver, t)
        return t

    @property
    def account(self) -> bytes:
        return self.obj[sfAccount]

    @property
    def sequence(self) -> int:
        return self.obj[sfSequence]

    @property
    def fee(self) -> STAmount:
        return self.obj.get(sfFee) or STAmount.from_drops(0)

    @property
    def flags(self) -> int:
        return self.obj.get(sfFlags, 0)

    @property
    def signing_pub_key(self) -> bytes:
        return self.obj.get(sfSigningPubKey, b"")

    @property
    def signature(self) -> bytes:
        return self.obj.get(sfTxnSignature, b"")

    # -- hashing / signing ------------------------------------------------

    def serialize(self) -> bytes:
        memo = self._blob_memo
        if memo is not None and memo[0] == self.obj._version:
            return memo[1]
        blob = self.obj.serialize()
        self._blob_memo = (self.obj._version, blob)
        return blob

    def signing_hash(self) -> bytes:
        """HP_TX_SIGN prefix hash over the signature-less serialization
        (reference: SerializedTransaction.cpp:162-165 via
        STObject::getSigningHash)."""
        return self.obj.signing_hash(HP_TX_SIGN)

    def txid(self) -> bytes:
        """HP_TXN_ID over the full (signed) blob
        (reference: getTransactionID — memoized here, versioned against
        object mutation)."""
        memo = self._txid_memo
        if memo is not None and memo[0] == self.obj._version:
            return memo[1]
        h = prefix_hash(HP_TXN_ID, self.serialize())
        self._txid_memo = (self.obj._version, h)
        return h

    def sign(self, key: KeyPair) -> None:
        """reference: SerializedTransaction::sign (:185-190)"""
        self.obj[sfSigningPubKey] = key.public
        self.obj[sfTxnSignature] = key.sign(self.signing_hash())
        self._sig_good = None

    def check_sign(self) -> bool:
        """Ed25519 verify of TxnSignature by SigningPubKey over the signing
        hash, canonical-S enforced; memoized (reference:
        SerializedTransaction::checkSign :192-230)."""
        if self._sig_good is None:
            self._sig_good = verify_signature(
                self.signing_pub_key, self.signing_hash(), self.signature
            )
        return self._sig_good

    def set_sig_verdict(self, good: bool) -> None:
        """Inject an externally-computed verdict (the batched TPU verifier
        path — same role as HashRouter SF_SIGGOOD memoization)."""
        self._sig_good = good

    # -- validity ---------------------------------------------------------

    def passes_local_checks(self) -> tuple[bool, str]:
        """Cheap structural checks before any state access
        (reference: passesLocalChecks, SerializedTransaction.cpp:350-369);
        memoized, versioned against object mutation."""
        memo = self._local_memo
        if memo is not None and memo[0] == self.obj._version:
            return memo[1]
        verdict = self._local_checks()
        self._local_memo = (self.obj._version, verdict)
        return verdict

    def _local_checks(self) -> tuple[bool, str]:
        fee = self.obj.get(sfFee)
        if fee is None or not fee.is_native or fee.negative:
            return False, "invalid fee"
        if sfAccount not in self.obj:
            return False, "no source account"
        if self.obj[sfAccount] == b"\x00" * 20:
            return False, "bad source account"
        fmt = TX_FORMATS.get(self.tx_type)
        if fmt is None:
            return False, "unknown transaction type"
        problems = validate_against(self.obj, fmt)
        if problems:
            return False, "; ".join(problems)
        return True, ""

    def __repr__(self):
        return (
            f"STTx({self.tx_type.name} acct={self.account.hex()[:8]} "
            f"seq={self.sequence})"
        )
