"""Change pseudo-transactions: EnableAmendment, SetFee.

Reference: src/ripple_app/transactors/Change.cpp — only valid in a closing
ledger, source account zero, no fee, no signature; applies amendment and
fee-settings ledger entries.
"""

from __future__ import annotations

from ..protocol.formats import LedgerEntryType, TxType
from ..protocol.sfields import (
    sfAmendment,
    sfAmendments,
    sfBaseFee,
    sfReferenceFeeUnits,
    sfReserveBase,
    sfReserveIncrement,
)
from ..protocol.ter import TER
from ..protocol.stamount import ACCOUNT_ZERO
from ..state import indexes
from .transactor import Transactor, register_transactor


class _ChangeBase(Transactor):
    """Shared pseudo-tx pipeline overrides (reference: Change.cpp
    applyChange — skips account/seq/fee/sig machinery)."""

    def must_have_valid_account(self) -> bool:
        return False

    def pre_check(self) -> TER:
        from .engine import TxParams

        if self.params & TxParams.OPEN_LEDGER:
            return TER.temINVALID  # only in closing ledgers
        if self.tx.account != ACCOUNT_ZERO:
            return TER.temBAD_SRC_ACCOUNT
        self.account_id = self.tx.account
        return TER.tesSUCCESS

    def check_seq(self) -> TER:
        return TER.tesSUCCESS

    def pay_fee(self) -> TER:
        return TER.tesSUCCESS

    def check_sig(self) -> TER:
        return TER.tesSUCCESS

    def apply(self) -> TER:
        ter = self.pre_check()
        if ter != TER.tesSUCCESS:
            return ter
        return self.do_apply()


@register_transactor(TxType.ttAMENDMENT)
class EnableAmendmentTransactor(_ChangeBase):
    def do_apply(self) -> TER:
        """Append the amendment hash to the ltAMENDMENTS singleton
        (reference: Change.cpp applyAmendment)."""
        idx = indexes.amendment_index()
        sle = self.les.peek(idx)
        created = False
        if sle is None:
            sle = self.les.create(LedgerEntryType.ltAMENDMENTS, idx)
            sle[sfAmendments] = []
            created = True
        amendments = list(sle.get(sfAmendments, []))
        amendment = self.tx.obj[sfAmendment]
        if amendment in amendments:
            return TER.tefALREADY
        amendments.append(amendment)
        sle[sfAmendments] = amendments
        if not created:
            self.les.modify(idx)
        return TER.tesSUCCESS


@register_transactor(TxType.ttFEE)
class SetFeeTransactor(_ChangeBase):
    def do_apply(self) -> TER:
        """Write the ltFEE_SETTINGS singleton and update the ledger's fee
        schedule (reference: Change.cpp applyFee)."""
        idx = indexes.fee_index()
        sle = self.les.peek(idx)
        created = False
        if sle is None:
            sle = self.les.create(LedgerEntryType.ltFEE_SETTINGS, idx)
            created = True
        tx = self.tx.obj
        sle[sfBaseFee] = tx[sfBaseFee]
        sle[sfReferenceFeeUnits] = tx[sfReferenceFeeUnits]
        sle[sfReserveBase] = tx[sfReserveBase]
        sle[sfReserveIncrement] = tx[sfReserveIncrement]
        if not created:
            self.les.modify(idx)
        # fee-schedule switch is deferred to the engine's header_changes
        # application (post-invariants) like Inflation's header writes
        self.header_changes = {
            "base_fee": tx[sfBaseFee],
            "reference_fee_units": tx[sfReferenceFeeUnits],
            "reserve_base": tx[sfReserveBase],
            "reserve_increment": tx[sfReserveIncrement],
        }
        return TER.tesSUCCESS
