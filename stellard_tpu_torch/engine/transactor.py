"""Transactor base: the common apply pipeline and the type registry.

Reference: src/ripple_app/transactors/Transactor.cpp —
makeTransactor (:34-84, here a decorator registry instead of the switch),
apply() = preCheck (:256-287) → account load → checkSeq (:182-253) →
payFee (:112-149) → checkSig (:151-180) → precheckAgainstLedger →
doApply.

Open-ledger semantics follow the reference exactly: in open mode apply()
returns after the checks, BEFORE doApply — the open ledger only records
the transaction; state changes happen when the close re-applies it
(Transactor.cpp:345-347).
"""

from __future__ import annotations

from typing import Callable, Optional, Type

from ..protocol.formats import LedgerEntryType, TxType
from ..protocol.sfields import (
    sfAccountTxnID,
    sfBalance,
    sfLastLedgerSequence,
    sfRegularKey,
    sfSequence,
)
from ..protocol.stamount import STAmount
from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from ..state import indexes
from ..utils.hashes import hash160
from .flags import lsfDisableMaster

__all__ = ["Transactor", "register_transactor", "make_transactor"]

_REGISTRY: dict[TxType, Type["Transactor"]] = {}

# TxParams flag values as plain ints: `int & IntFlag` falls into
# IntFlag.__rand__ (enum-member construction), measurable at flood rates
from .engine import TxParams as _TP  # no cycle: engine imports this module lazily

_OPEN_LEDGER = int(_TP.OPEN_LEDGER)
_RETRY = int(_TP.RETRY)
_ADMIN = int(_TP.ADMIN)
_NO_CHECK_SIGN = int(_TP.NO_CHECK_SIGN)
del _TP


def register_transactor(tx_type: TxType) -> Callable:
    def deco(cls: Type["Transactor"]) -> Type["Transactor"]:
        _REGISTRY[tx_type] = cls
        return cls

    return deco


def make_transactor(tx: SerializedTransaction, params: int, engine) -> Optional["Transactor"]:
    """reference: Transactor::makeTransactor (Transactor.cpp:34-84)"""
    cls = _REGISTRY.get(tx.tx_type)
    if cls is None:
        return None
    return cls(tx, params, engine)


class Transactor:
    """One transaction application. Subclasses implement do_apply()
    and may override check hooks."""

    def __init__(self, tx: SerializedTransaction, params: int, engine):
        self.tx = tx
        self.params = int(params)  # keep flag tests on the int fast path
        self.engine = engine
        self.les = engine.les
        self.account_id: bytes = b""
        self.account = None  # source account SLE working copy
        self.prior_balance = STAmount.from_drops(0)
        self.source_balance = STAmount.from_drops(0)
        self.has_auth_key = False
        self.sig_master = False
        # ledger-header mutations requested by do_apply; the engine applies
        # them only after the invariant gate passes (keys: tot_coins_delta,
        # inflation_seq_delta, fee_pool, base_fee, reference_fee_units,
        # reserve_base, reserve_increment)
        self.header_changes: dict = {}

    # -- hooks ------------------------------------------------------------

    def calculate_base_fee(self) -> int:
        """reference: Transactor::calculateBaseFee"""
        return self.engine.ledger.base_fee

    def must_have_valid_account(self) -> bool:
        return True

    def precheck_against_ledger(self) -> TER:
        return TER.tesSUCCESS

    def do_apply(self) -> TER:
        raise NotImplementedError

    # -- pipeline ---------------------------------------------------------

    def pre_check(self) -> TER:
        """reference: Transactor::preCheck (:256-287)"""
        self.account_id = self.tx.account
        if self.account_id == b"\x00" * 20 or not self.account_id:
            return TER.temBAD_SRC_ACCOUNT
        if not (self.params & _NO_CHECK_SIGN):
            if not self.tx.check_sign():
                return TER.temINVALID
        return TER.tesSUCCESS

    def check_seq(self) -> TER:
        """reference: Transactor::checkSeq (:182-253) — in open-ledger mode
        the account seq is predicted by walking the open tx map."""
        t_seq = self.tx.sequence
        a_seq = self.account[sfSequence]

        if self.params & _OPEN_LEDGER:
            # predicted seq from the open ledger's per-account cache —
            # O(1), maintained by add_open_transaction (the reference
            # walks the open tx map per tx, which is quadratic)
            cached = self.engine.ledger.open_tx_seqs.get(self.account_id)
            if cached is not None and cached + 1 > a_seq:
                a_seq = cached + 1

        if t_seq != a_seq:
            if a_seq < t_seq:
                return TER.terPRE_SEQ
            if self.engine.ledger.tx_map.get(self.tx.txid()) is not None:
                return TER.tefALREADY
            return TER.tefPAST_SEQ

        if sfAccountTxnID in self.tx.obj and (
            self.account.get(sfAccountTxnID) != self.tx.obj[sfAccountTxnID]
        ):
            return TER.tefWRONG_PRIOR
        if sfLastLedgerSequence in self.tx.obj and (
            self.engine.ledger.seq > self.tx.obj[sfLastLedgerSequence]
        ):
            return TER.tefMAX_LEDGER

        self.account[sfSequence] = t_seq + 1
        if sfAccountTxnID in self.account:
            self.account[sfAccountTxnID] = self.tx.txid()
        return TER.tesSUCCESS

    def pay_fee(self) -> TER:
        """reference: Transactor::payFee (:112-149)"""
        paid = self.tx.fee
        fee_due = STAmount.from_drops(
            self.engine.ledger.scale_fee_load(
                self.calculate_base_fee(), bool(self.params & _ADMIN)
            )
        )
        if not paid.is_native or paid.negative:
            return TER.temBAD_FEE
        if (self.params & _OPEN_LEDGER) and paid < fee_due:
            return TER.telINSUF_FEE_P
        if paid.is_zero():
            return TER.tesSUCCESS
        if self.source_balance < paid:
            return TER.terINSUF_FEE_B
        self.source_balance = self.source_balance - paid
        self.account[sfBalance] = self.source_balance
        return TER.tesSUCCESS

    def check_sig(self) -> TER:
        """Signing-key authority: master key vs regular key
        (reference: Transactor::checkSig :151-180)."""
        from ..protocol.sfields import sfFlags

        signer_id = hash160(self.tx.signing_pub_key)
        if signer_id == self.account_id:
            self.sig_master = True
            if (self.account.get(sfFlags, 0) & lsfDisableMaster) != 0:
                return TER.tefMASTER_DISABLED
            return TER.tesSUCCESS
        if self.has_auth_key and signer_id == self.account.get(sfRegularKey):
            return TER.tesSUCCESS
        if self.has_auth_key:
            return TER.tefBAD_AUTH
        return TER.temBAD_AUTH_MASTER

    def apply(self) -> TER:
        """reference: Transactor::apply (:294-353)"""
        ter = self.pre_check()
        if ter != TER.tesSUCCESS:
            return ter

        idx = indexes.account_root_index(self.account_id)
        self.account = self.les.peek(idx)
        if self.account is None:
            if self.must_have_valid_account():
                return TER.terNO_ACCOUNT
        else:
            self.prior_balance = self.account[sfBalance]
            self.source_balance = self.prior_balance
            self.has_auth_key = sfRegularKey in self.account

        ter = self.check_seq()
        if ter != TER.tesSUCCESS:
            return ter
        ter = self.pay_fee()
        if ter != TER.tesSUCCESS:
            return ter
        ter = self.check_sig()
        if ter != TER.tesSUCCESS:
            return ter
        ter = self.precheck_against_ledger()
        if ter != TER.tesSUCCESS:
            return ter

        if self.params & _OPEN_LEDGER:
            # open ledger: checks only; the close re-applies for real
            # (reference: Transactor.cpp:345-347)
            return TER.tesSUCCESS

        if self.account is not None:
            self.les.modify(idx)
        return self.do_apply()
