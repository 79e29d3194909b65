"""TransactionEngine: applies one transaction to a ledger.

Reference: src/ripple_app/tx/TransactionEngine.cpp:94-253 —
applyTransaction dispatches to a transactor, handles the tec
claim-fee-only reprocess, checks invariants, records the tx into the
ledger's tx map (open: blob only; closing: blob + metadata + fee burn).
"""

from __future__ import annotations

from enum import IntFlag

from ..protocol.formats import TxType
from ..protocol.sfields import sfBalance, sfSequence
from ..protocol.stamount import STAmount
from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from ..state import LedgerEntrySet, indexes
from ..state.ledger import Ledger

__all__ = ["TransactionEngine", "TxParams"]


class TxParams(IntFlag):
    """reference: TransactionEngineParams (TransactionEngine.h)"""

    NONE = 0
    OPEN_LEDGER = 0x10  # tapOPEN_LEDGER
    RETRY = 0x20  # tapRETRY
    ADMIN = 0x400  # tapADMIN
    NO_CHECK_SIGN = 0x01  # tapNO_CHECK_SIGN


# int mirrors of TxParams (enum & is slow in the apply hot path); derived
# from the enum so they can never drift from it
_OPEN_LEDGER_I = int(TxParams.OPEN_LEDGER)
_RETRY_I = int(TxParams.RETRY)


def _is_tec(ter: TER) -> bool:
    return 100 <= int(ter) < 300


class TransactionEngine:
    def __init__(self, ledger: Ledger):
        self.ledger = ledger
        self.les: LedgerEntrySet | None = None
        self.tx_seq = 0  # metadata TransactionIndex within the closing ledger
        # raw transactor outcome of the last apply, BEFORE the tec
        # claim-fee reprocess may replace it — the delta-replay close
        # needs it to mirror non-final-pass (RETRY) semantics exactly
        self.last_raw_ter: TER | None = None

    def apply_transaction(
        self, tx: SerializedTransaction, params: TxParams
    ) -> tuple[TER, bool]:
        """-> (TER, did_apply). reference: applyTransaction
        (TransactionEngine.cpp:94-253)."""
        from .transactor import make_transactor

        # plain int from here down: IntFlag.__and__ builds a new enum
        # member per test, which is measurable at flood rates; int &
        # IntFlag stays on the C fast path
        params = int(params)
        self.les = LedgerEntrySet(self.ledger)

        # pseudo-transactions (zero account, no fee/signature) only enter
        # through a consensus set; their own pre_check enforces the
        # closing-ledger + zero-account rules, but the required-field
        # template must still hold or do_apply would crash the close.
        # Client/peer intake paths call passes_local_checks themselves and
        # still reject pseudo-txs (reference: passesLocalChecks runs in
        # Transaction::checkCoherent, not TransactionEngine::applyTransaction).
        if tx.tx_type in (TxType.ttAMENDMENT, TxType.ttFEE):
            from ..protocol.formats import TX_FORMATS, validate_against

            fmt = TX_FORMATS.get(tx.tx_type)
            if fmt is None or validate_against(tx.obj, fmt):
                return TER.temINVALID, False
        else:
            ok, _why = tx.passes_local_checks()
            if not ok:
                return TER.temINVALID, False

        transactor = make_transactor(tx, params, self)
        if transactor is None:
            return TER.temUNKNOWN, False

        ter = transactor.apply()
        self.last_raw_ter = ter
        did_apply = False

        if ter == TER.tesSUCCESS:
            did_apply = True
        elif _is_tec(ter) and not (params & _RETRY_I):
            # claim only the fee (reference: TransactionEngine.cpp:146-185)
            self.les = LedgerEntrySet(self.ledger)
            idx = indexes.account_root_index(tx.account)
            acct = self.les.peek(idx)
            if acct is None:
                ter = TER.terNO_ACCOUNT
            else:
                t_seq, a_seq = tx.sequence, acct[sfSequence]
                if a_seq < t_seq:
                    ter = TER.terPRE_SEQ
                elif a_seq > t_seq:
                    ter = TER.tefPAST_SEQ
                else:
                    fee = tx.fee
                    balance = acct[sfBalance]
                    if balance < fee:
                        ter = TER.terINSUF_FEE_B
                    else:
                        acct[sfBalance] = balance - fee
                        acct[sfSequence] = t_seq + 1
                        self.les.modify(idx)
                        did_apply = True

        if did_apply:
            minted = getattr(transactor, "minted_coins", 0)
            if not self._check_invariants(tx, params, minted):
                return TER.tefINTERNAL, False
            blob = tx.serialize()
            if params & _OPEN_LEDGER_I:
                txid, added = self.ledger.add_open_transaction(blob)
                if not added:
                    return TER.tefALREADY, False
                # open ledger records the tx only; no state write
                # (the transactor returned before do_apply)
                self.ledger.note_open_tx(tx.account, tx.sequence)
            else:
                meta = self.les.calc_meta(ter, self.tx_seq, self.ledger.seq, tx.txid())
                self.tx_seq += 1
                self.ledger.record_transaction(blob, meta)
                # deferred header mutations (Inflation/SetFee), applied
                # only now that the invariant gate has passed
                hc = getattr(transactor, "header_changes", {})
                if hc and ter == TER.tesSUCCESS:
                    self.ledger.tot_coins += hc.get("tot_coins_delta", 0)
                    self.ledger.inflation_seq += hc.get("inflation_seq_delta", 0)
                    if "fee_pool" in hc:
                        self.ledger.fee_pool = hc["fee_pool"]
                    for k in ("base_fee", "reference_fee_units",
                              "reserve_base", "reserve_increment"):
                        if k in hc:
                            setattr(self.ledger, k, hc[k])
                # burn the fee (reference: destroyCoins)
                self.ledger.tot_coins -= tx.fee.mantissa
                self.ledger.fee_pool += tx.fee.mantissa
                self.les.apply()

        return ter, did_apply

    def _check_invariants(self, tx: SerializedTransaction, params: TxParams,
                          minted: int = 0) -> bool:
        """Native-coin conservation across the entry set: total STR balance
        change must equal minted coins minus the fee. The reference's
        checkInvariants is an empty stub (TransactionCheck.cpp:26-32); this
        enforces the conservation law it gestures at."""
        if params & _OPEN_LEDGER_I:
            return True
        from ..protocol.sfields import sfBalance as _bal
        from ..state.entryset import Action

        delta = 0
        for idx, sle, action in self.les.entries():
            cur = sle.get(_bal) if sle is not None else None
            e = self.les._entries[idx]
            old = e.orig.get(_bal) if e.orig is not None else None

            def drops(v):
                if v is None or not isinstance(v, STAmount) or not v.is_native:
                    return 0
                return -v.mantissa if v.negative else v.mantissa

            if action == Action.CREATED:
                delta += drops(cur)
            elif action == Action.DELETED:
                delta -= drops(old)
            elif action == Action.MODIFIED:
                delta += drops(cur) - drops(old)
        return delta == minted - tx.fee.mantissa
