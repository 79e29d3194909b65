"""TrustSet transactor.

Reference: src/ripple_app/transactors/SetTrust.cpp (406 LoC) — the full
limit/quality/flags update with per-side reserve accounting, default-state
deletion, and line creation with reserve check.
"""

from __future__ import annotations

from ..protocol.formats import TxType
from ..protocol.sfields import (
    sfFlags,
    sfHighLimit,
    sfHighQualityIn,
    sfHighQualityOut,
    sfLimitAmount,
    sfLowLimit,
    sfLowQualityIn,
    sfLowQualityOut,
    sfOwnerCount,
    sfQualityIn,
    sfQualityOut,
)
from ..protocol.stamount import ACCOUNT_ZERO, STAmount
from ..protocol.ter import TER
from ..state import indexes
from .flags import (
    lsfHighAuth,
    lsfHighNoRipple,
    lsfHighReserve,
    lsfLowAuth,
    lsfLowNoRipple,
    lsfLowReserve,
    lsfRequireAuth,
    tfClearAuth,
    tfClearNoRipple,
    tfSetNoRipple,
    tfSetfAuth,
    tfTrustSetMask,
)
from .transactor import Transactor, register_transactor
from .views import ACCOUNT_ONE, QUALITY_ONE, trust_create, trust_delete



@register_transactor(TxType.ttTRUST_SET)
class TrustSetTransactor(Transactor):
    def do_apply(self) -> TER:
        tx = self.tx
        limit_amount: STAmount = tx.obj.get(sfLimitAmount)
        if limit_amount is None:
            limit_amount = STAmount.from_drops(0)
        has_qin = sfQualityIn in tx.obj
        has_qout = sfQualityOut in tx.obj
        quality_in = tx.obj.get(sfQualityIn, 0)
        quality_out = tx.obj.get(sfQualityOut, 0)
        if quality_in == QUALITY_ONE:
            quality_in = 0
        if quality_out == QUALITY_ONE:
            quality_out = 0

        currency = limit_amount.currency
        dst_id = limit_amount.issuer
        high = self.account_id > dst_id
        flags = tx.flags

        if flags & tfTrustSetMask:
            return TER.temINVALID_FLAG
        set_auth = bool(flags & tfSetfAuth)
        clear_auth = bool(flags & tfClearAuth)
        set_no_ripple = bool(flags & tfSetNoRipple)
        clear_no_ripple = bool(flags & tfClearNoRipple)

        if set_auth and not (self.account.get(sfFlags, 0) & lsfRequireAuth):
            return TER.tefNO_AUTH_REQUIRED
        if limit_amount.is_native:
            return TER.temBAD_LIMIT
        if limit_amount.negative:
            return TER.temBAD_LIMIT
        if not dst_id or dst_id == ACCOUNT_ZERO or dst_id == ACCOUNT_ONE:
            return TER.temDST_NEEDED

        line_idx = indexes.ripple_state_index(self.account_id, dst_id, currency)

        if self.account_id == dst_id:
            # clearing a redundant self-line (reference: SetTrust.cpp:104-123)
            line = self.les.peek(line_idx)
            if line is not None:
                return trust_delete(self.les, line_idx, self.account_id, dst_id)
            return TER.temDST_IS_SRC

        dst = self.les.account_root(dst_id)
        if dst is None:
            return TER.tecNO_DST

        owner_count = self.account.get(sfOwnerCount, 0)
        # reserve needed to add a line (reference: SetTrust.cpp:135-141)
        reserve_create = (
            0 if owner_count < 2
            else self.engine.ledger.reserve(owner_count + 1)
        )

        limit_allow = STAmount.from_iou(
            currency, self.account_id, limit_amount.mantissa,
            limit_amount.offset, limit_amount.negative,
        )

        line = self.les.peek(line_idx)
        if line is not None:
            return self._modify_line(
                line, line_idx, dst_id, high, limit_allow,
                has_qin, quality_in, has_qout, quality_out,
                set_auth, clear_auth, set_no_ripple, clear_no_ripple,
                reserve_create,
            )

        # line does not exist (reference: SetTrust.cpp:357-405)
        if (
            limit_allow.is_zero()
            and (not has_qin or not quality_in)
            and (not has_qout or not quality_out)
            and not set_auth
            and not clear_auth
        ):
            return TER.tecNO_LINE_REDUNDANT
        if self.prior_balance.mantissa < reserve_create:
            return TER.tecNO_LINE_INSUF_RESERVE

        balance = STAmount.zero_like(currency, ACCOUNT_ONE)
        return trust_create(
            self.les,
            high,
            self.account_id,
            dst_id,
            line_idx,
            auth=set_auth,
            no_ripple=set_no_ripple and not clear_no_ripple,
            balance=balance,
            limit=limit_allow,
            quality_in=quality_in,
            quality_out=quality_out,
        )

    def _modify_line(self, line, line_idx, dst_id, high, limit_allow,
                     has_qin, quality_in, has_qout, quality_out,
                     set_auth, clear_auth, set_no_ripple, clear_no_ripple,
                     reserve_create) -> TER:
        """reference: SetTrust.cpp:149-356"""
        from ..protocol.sfields import sfBalance
        low_balance = line[sfBalance]
        high_balance = -low_balance
        my_balance = high_balance if high else low_balance

        line[sfHighLimit if high else sfLowLimit] = limit_allow
        low_limit = line[sfLowLimit]
        high_limit = line[sfHighLimit]

        # qualities (set / clear / keep)
        if has_qin:
            f = sfHighQualityIn if high else sfLowQualityIn
            if quality_in:
                line[f] = quality_in
            else:
                line.pop(f)
        if has_qout:
            f = sfHighQualityOut if high else sfLowQualityOut
            if quality_out:
                line[f] = quality_out
            else:
                line.pop(f)

        low_qin = line.get(sfLowQualityIn, 0)
        low_qout = line.get(sfLowQualityOut, 0)
        high_qin = line.get(sfHighQualityIn, 0)
        high_qout = line.get(sfHighQualityOut, 0)
        if low_qin == QUALITY_ONE:
            low_qin = 0
        if low_qout == QUALITY_ONE:
            low_qout = 0
        if high_qin == QUALITY_ONE:
            high_qin = 0
        if high_qout == QUALITY_ONE:
            high_qout = 0

        flags_in = line.get(sfFlags, 0)
        flags_out = flags_in

        if set_no_ripple and not clear_no_ripple and my_balance.signum() >= 0:
            flags_out |= lsfHighNoRipple if high else lsfLowNoRipple
        elif clear_no_ripple and not set_no_ripple:
            flags_out &= ~(lsfHighNoRipple if high else lsfLowNoRipple)
        if set_auth:
            flags_out |= lsfHighAuth if high else lsfLowAuth
        if clear_auth:
            flags_out &= ~(lsfHighAuth if high else lsfLowAuth)

        low_reserve_set = bool(
            low_qin or low_qout or (flags_out & lsfLowNoRipple)
            or not low_limit.is_zero() or low_balance.signum() > 0
        )
        high_reserve_set = bool(
            high_qin or high_qout or (flags_out & lsfHighNoRipple)
            or not high_limit.is_zero() or high_balance.signum() > 0
        )
        default = not low_reserve_set and not high_reserve_set
        low_reserved = bool(flags_in & lsfLowReserve)
        high_reserved = bool(flags_in & lsfHighReserve)
        reserve_increase = False

        low_id = dst_id if high else self.account_id
        high_id = self.account_id if high else dst_id

        if low_reserve_set and not low_reserved:
            self.les.adjust_owner_count(low_id, 1)
            flags_out |= lsfLowReserve
            if not high:
                reserve_increase = True
        if not low_reserve_set and low_reserved:
            self.les.adjust_owner_count(low_id, -1)
            flags_out &= ~lsfLowReserve
        if high_reserve_set and not high_reserved:
            self.les.adjust_owner_count(high_id, 1)
            flags_out |= lsfHighReserve
            if high:
                reserve_increase = True
        if not high_reserve_set and high_reserved:
            self.les.adjust_owner_count(high_id, -1)
            flags_out &= ~lsfHighReserve

        if flags_in != flags_out:
            line[sfFlags] = flags_out

        if default:
            return trust_delete(self.les, line_idx, low_id, high_id)
        if reserve_increase and self.prior_balance.mantissa < reserve_create:
            return TER.tecINSUF_RESERVE_LINE
        self.les.modify(line_idx)
        return TER.tesSUCCESS
