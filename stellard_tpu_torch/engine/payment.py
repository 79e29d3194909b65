"""Payment transactor.

Reference: src/ripple_app/transactors/Payment.cpp (299 LoC) — malformed
checks (:55-140), destination-account creation with reserve minimum
(:141-180), direct STR transfer with reserve floor (:250-280), and
ripple/IOU payments via RippleCalc (:185-248).

IOU scope: direct rippling through the default path — sender↔issuer↔
receiver (rippleSend semantics). Deliveries that need the path engine
(`_flow_payment`) raise NotImplementedError until paths/ is ported.
"""

from __future__ import annotations

from ..protocol.formats import LedgerEntryType, TxType
from ..protocol.sfields import (
    sfAccount,
    sfAmount,
    sfBalance,
    sfDestination,
    sfDestinationTag,
    sfFlags,
    sfOwnerCount,
    sfPaths,
    sfSendMax,
    sfSequence,
)
from ..protocol.stamount import ACCOUNT_ZERO, STAmount
from ..protocol.ter import TER
from ..state import indexes
from .flags import (
    lsfRequireDestTag,
    tfLimitQuality,
    tfNoRippleDirect,
    tfPaymentMask,
)
from .transactor import Transactor, register_transactor
from . import views



@register_transactor(TxType.ttPAYMENT)
class PaymentTransactor(Transactor):
    def do_apply(self) -> TER:
        tx = self.tx
        flags = tx.flags
        dst_id = tx.obj[sfDestination]
        dst_amount: STAmount = tx.obj[sfAmount]
        has_max = sfSendMax in tx.obj
        has_paths = sfPaths in tx.obj and len(tx.obj[sfPaths]) > 0
        if has_max:
            max_amount = tx.obj[sfSendMax]
        elif dst_amount.is_native:
            max_amount = dst_amount
        else:
            max_amount = STAmount.from_iou(
                dst_amount.currency, self.account_id,
                dst_amount.mantissa, dst_amount.offset, dst_amount.negative,
            )
        str_direct = max_amount.is_native and dst_amount.is_native

        # malformed checks (reference: Payment.cpp:55-140)
        if flags & tfPaymentMask:
            return TER.temINVALID_FLAG
        if not dst_id or dst_id == ACCOUNT_ZERO:
            return TER.temDST_NEEDED
        if has_max and max_amount.signum() <= 0:
            return TER.temBAD_AMOUNT
        if dst_amount.signum() <= 0:
            return TER.temBAD_AMOUNT
        if (
            self.account_id == dst_id
            and max_amount.currency == dst_amount.currency
            and not has_paths
        ):
            return TER.temREDUNDANT
        if has_max and max_amount == dst_amount:
            return TER.temREDUNDANT_SEND_MAX
        if str_direct and has_max:
            return TER.temBAD_SEND_STR_MAX
        if str_direct and has_paths:
            return TER.temBAD_SEND_STR_PATHS
        if str_direct and (flags & tfLimitQuality):
            return TER.temBAD_SEND_STR_LIMIT
        if str_direct and (flags & tfNoRippleDirect):
            return TER.temBAD_SEND_STR_NO_DIRECT

        dst_idx = indexes.account_root_index(dst_id)
        dst = self.les.peek(dst_idx)
        if dst is None:
            # destination does not exist (reference: Payment.cpp:141-180)
            if not dst_amount.is_native:
                return TER.tecNO_DST
            if dst_amount.mantissa < self.engine.ledger.reserve(0):
                return TER.tecNO_DST_INSUF_STR
            dst = self.les.create(LedgerEntryType.ltACCOUNT_ROOT, dst_idx)
            dst[sfAccount] = dst_id
            dst[sfSequence] = 1
            dst[sfBalance] = STAmount.from_drops(0)
        else:
            if (dst.get(sfFlags, 0) & lsfRequireDestTag) and (
                sfDestinationTag not in tx.obj
            ):
                return TER.tefDST_TAG_NEEDED
            self.les.modify(dst_idx)

        if has_paths or has_max or not dst_amount.is_native:
            return self._ripple_payment(dst_id, dst_amount, max_amount, flags)

        # direct STR (reference: Payment.cpp:250-280)
        owner_count = self.account.get(sfOwnerCount, 0)
        reserve = self.engine.ledger.reserve(owner_count)
        need = dst_amount + STAmount.from_drops(
            max(reserve, self.tx.fee.mantissa)
        )
        if self.prior_balance < need:
            return TER.tecUNFUNDED_PAYMENT
        self.account[sfBalance] = self.source_balance - dst_amount
        dst[sfBalance] = dst[sfBalance] + dst_amount
        return TER.tesSUCCESS

    def _ripple_payment(self, dst_id: bytes, dst_amount: STAmount,
                        max_amount: STAmount, flags: int) -> TER:
        """IOU / cross-currency delivery. Explicit paths and currency
        conversions run through the flow engine (paths.flow — the
        RippleCalc replacement); the plain same-currency default path
        keeps the direct rippleSend fast path below."""
        has_paths = sfPaths in self.tx.obj and len(self.tx.obj[sfPaths]) > 0
        if (
            self.account_id == dst_id
            and not has_paths
            and max_amount.currency == dst_amount.currency
        ):
            # same-currency self-payment is a no-op; cross-currency
            # self-payment is a legitimate conversion (reference:
            # Payment.cpp redundancy check keys on currency too)
            return TER.temREDUNDANT
        if has_paths or max_amount.currency != dst_amount.currency or (
            self.account_id == dst_id
        ):
            return self._flow_payment(dst_id, dst_amount, max_amount, flags)

        # funds check: what can the sender actually deliver?
        funds = views.account_funds(self.les, self.account_id, max_amount)
        if funds.signum() <= 0:
            return TER.tecUNFUNDED_PAYMENT

        issuer = dst_amount.issuer
        if issuer != self.account_id and issuer != dst_id:
            # third-party issuer: the default path is a real two-hop
            # ripple (sender -> issuer -> destination) whose legality
            # depends on line state BOTH ways — the sender may redeem
            # held IOUs or ISSUE into a line the intermediary trusts,
            # and the intermediary's transfer rate and line qualities
            # apply. That is the flow engine's job (reference: Payment
            # routes every non-direct case through RippleCalc,
            # Payment.cpp:185-248); a held-balance precheck here
            # wrongly rejected issue-along-line deliveries.
            return self._flow_payment(dst_id, dst_amount, max_amount, flags)
        if issuer == self.account_id:
            # issuing own IOUs: delivery must fit the destination's trust
            # limit (the RippleCalc credit-limit rule on the default path)
            line_idx = indexes.ripple_state_index(
                dst_id, self.account_id, dst_amount.currency
            )
            line = self.les.peek(line_idx)
            if line is None:
                return TER.tecPATH_DRY
            held = views.ripple_balance(
                self.les, dst_id, self.account_id, dst_amount.currency
            )
            from ..protocol.sfields import sfHighLimit, sfLowLimit

            dst_high = dst_id > self.account_id
            limit = line[sfHighLimit if dst_high else sfLowLimit]
            new_bal = held + STAmount.from_iou(
                held.currency, held.issuer, dst_amount.mantissa,
                dst_amount.offset, dst_amount.negative,
            )
            if new_bal > STAmount.from_iou(
                new_bal.currency, new_bal.issuer, limit.mantissa,
                limit.offset, limit.negative,
            ):
                return TER.tecPATH_DRY
        elif issuer == dst_id:
            # redemption: sender must hold the destination's IOUs
            held = views.ripple_balance(
                self.les, self.account_id, dst_id, dst_amount.currency
            )
            if held.signum() <= 0 or held < STAmount.from_iou(
                held.currency, held.issuer, dst_amount.mantissa,
                dst_amount.offset, dst_amount.negative,
            ):
                return TER.tecPATH_PARTIAL

        ter, _actual = views.ripple_send(
            self.les, self.account_id, dst_id, dst_amount
        )
        if ter in (TER.terRETRY,):
            ter = TER.tecPATH_DRY
        return ter

    def _flow_payment(self, dst_id: bytes, dst_amount: STAmount,
                      max_amount: STAmount, flags: int) -> TER:
        """Path-engine delivery (reference: Payment.cpp:185-248 calling
        RippleCalc::rippleCalc with the tx's paths/flags)."""
        raise NotImplementedError(
            "Payment through the path engine (explicit paths, SendMax "
            "conversions, third-party issuers): paths/flow.py is not ported "
            "yet (ROADMAP Queue A, item 9)"
        )
