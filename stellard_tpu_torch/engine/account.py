"""Account transactors: AccountSet, SetRegularKey, AccountMerge.

Reference: src/ripple_app/transactors/{SetAccount,SetRegularKey,
AccountMergeTransactor}.cpp.
"""

from __future__ import annotations

from ..protocol.formats import LedgerEntryType, TxType
from ..protocol.sfields import (
    sfBalance,
    sfClearFlag,
    sfDestination,
    sfDestinationTag,
    sfFlags,
    sfHighLimit,
    sfInflationDest,
    sfLowLimit,
    sfRegularKey,
    sfSetAuthKey,
    sfSetFlag,
    sfTransferRate,
)
from ..protocol.stamount import ACCOUNT_ZERO, STAmount
from ..protocol.ter import TER
from ..state import indexes
from .flags import (
    asfDisableMaster,
    asfRequireAuth,
    asfRequireDest,
    lsfDisableMaster,
    lsfHighAuth,
    lsfLowAuth,
    lsfRequireAuth,
    lsfRequireDestTag,
    tfAccountSetMask,
    tfOptionalAuth,
    tfOptionalDestTag,
    tfRequireAuth,
    tfRequireDestTag,
    tfUniversalMask,
)
from .transactor import Transactor, register_transactor
from .views import QUALITY_ONE, offer_delete, trust_delete



@register_transactor(TxType.ttACCOUNT_SET)
class AccountSetTransactor(Transactor):
    """reference: SetAccount.cpp"""

    def do_apply(self) -> TER:
        tx = self.tx
        flags = tx.flags
        set_flag = tx.obj.get(sfSetFlag, 0)
        clear_flag = tx.obj.get(sfClearFlag, 0)

        set_require_dest = bool(flags & tfRequireDestTag) or set_flag == asfRequireDest
        clear_require_dest = bool(flags & tfOptionalDestTag) or clear_flag == asfRequireDest
        set_require_auth = bool(flags & tfRequireAuth) or set_flag == asfRequireAuth
        clear_require_auth = bool(flags & tfOptionalAuth) or clear_flag == asfRequireAuth

        if flags & tfAccountSetMask:
            return TER.temINVALID_FLAG

        flags_in = self.account.get(sfFlags, 0)
        flags_out = flags_in

        if set_require_auth and clear_require_auth:
            return TER.temINVALID_FLAG
        if set_require_auth and not (flags_in & lsfRequireAuth):
            # only allowed while the owner directory is empty
            owner_dir = self.les.peek(indexes.owner_dir_index(self.account_id))
            if owner_dir is not None:
                from .engine import TxParams

                return (
                    TER.terOWNERS
                    if self.params & TxParams.RETRY
                    else TER.tecOWNERS
                )
            flags_out |= lsfRequireAuth
        if clear_require_auth and (flags_in & lsfRequireAuth):
            flags_out &= ~lsfRequireAuth

        if set_require_dest and clear_require_dest:
            return TER.temINVALID_FLAG
        if set_require_dest and not (flags_in & lsfRequireDestTag):
            flags_out |= lsfRequireDestTag
        if clear_require_dest and (flags_in & lsfRequireDestTag):
            flags_out &= ~lsfRequireDestTag

        if set_flag == asfDisableMaster and clear_flag == asfDisableMaster:
            return TER.temINVALID_FLAG
        if set_flag == asfDisableMaster and not (flags_in & lsfDisableMaster):
            if sfRegularKey not in self.account:
                return TER.tecNO_REGULAR_KEY
            flags_out |= lsfDisableMaster
        if clear_flag == asfDisableMaster and (flags_in & lsfDisableMaster):
            flags_out &= ~lsfDisableMaster

        # InflationDest (Stellar-specific; reference: SetAccount.cpp:127-148)
        if sfInflationDest in tx.obj:
            dest = tx.obj[sfInflationDest]
            if dest == ACCOUNT_ZERO:
                self.account.pop(sfInflationDest)
            else:
                if self.les.account_root(dest) is None:
                    return TER.tecNO_DST
                self.account[sfInflationDest] = dest

        if sfSetAuthKey in tx.obj:
            auth_key = tx.obj[sfSetAuthKey]
            if auth_key == ACCOUNT_ZERO:
                self.account.pop(sfSetAuthKey)
            else:
                self.account[sfSetAuthKey] = auth_key

        # TransferRate (reference: SetAccount.cpp:175-195)
        if sfTransferRate in tx.obj:
            rate = tx.obj[sfTransferRate]
            if not rate or rate == QUALITY_ONE:
                self.account.pop(sfTransferRate)
            elif rate > QUALITY_ONE:
                self.account[sfTransferRate] = rate
            else:
                return TER.temBAD_TRANSFER_RATE

        if flags_in != flags_out:
            self.account[sfFlags] = flags_out
        return TER.tesSUCCESS


@register_transactor(TxType.ttREGULAR_KEY_SET)
class SetRegularKeyTransactor(Transactor):
    """reference: SetRegularKey.cpp"""

    def do_apply(self) -> TER:
        if self.tx.flags & tfUniversalMask:
            return TER.temINVALID_FLAG
        if sfRegularKey in self.tx.obj:
            self.account[sfRegularKey] = self.tx.obj[sfRegularKey]
        else:
            if self.account.get(sfFlags, 0) & lsfDisableMaster:
                return TER.tecMASTER_DISABLED
            self.account.pop(sfRegularKey)
        return TER.tesSUCCESS


@register_transactor(TxType.ttACCOUNT_MERGE)
class AccountMergeTransactor(Transactor):
    """Stellar-specific: move all balances/IOUs to destination, delete the
    source account (reference: AccountMergeTransactor.cpp)."""

    def precheck_against_ledger(self) -> TER:
        # master signature only (reference: :48-54)
        if not self.sig_master:
            return TER.temBAD_AUTH_MASTER
        if sfDestination not in self.tx.obj:
            return TER.temDST_NEEDED
        dst_id = self.tx.obj[sfDestination]
        if dst_id == self.account_id:
            return TER.temDST_IS_SRC
        dst = self.les.account_root(dst_id)
        if dst is None:
            return TER.tecNO_DST
        if (dst.get(sfFlags, 0) & lsfRequireDestTag) and (
            sfDestinationTag not in self.tx.obj
        ):
            return TER.tefDST_TAG_NEEDED
        return TER.tesSUCCESS

    def do_apply(self) -> TER:
        dst_id = self.tx.obj[sfDestination]
        dst_idx = indexes.account_root_index(dst_id)
        dst = self.les.peek(dst_idx)
        if dst is None:
            return TER.tecNO_DST

        # transfer every trust-line balance (reference: :100-196)
        from ..protocol.sfields import sfLedgerEntryType

        owner_dir = indexes.owner_dir_index(self.account_id)
        lines = []
        offers = []
        for entry_idx in list(self.les.dir_entries(owner_dir)):
            sle = self.les.peek(entry_idx)
            if sle is None:
                continue
            t = sle.get(sfLedgerEntryType)
            if t == int(LedgerEntryType.ltRIPPLE_STATE):
                lines.append(entry_idx)
            elif t == int(LedgerEntryType.ltOFFER):
                offers.append(entry_idx)

        for line_idx in lines:
            line = self.les.peek(line_idx)
            low_limit = line[sfLowLimit]
            high_limit = line[sfHighLimit]
            low_id_is_me = low_limit.issuer == self.account_id
            peer_id = high_limit.issuer if low_id_is_me else low_limit.issuer
            currency = low_limit.currency
            bal = line[sfBalance]
            my_bal = bal if low_id_is_me else -bal  # my perspective

            if my_bal.signum() < 0:
                return TER.temBAD_AMOUNT
            if my_bal.signum() > 0:
                # move to destination's line with the same issuer (:133-178)
                dst_line_idx = indexes.ripple_state_index(dst_id, peer_id, currency)
                dst_line = self.les.peek(dst_line_idx)
                if dst_line is None:
                    return TER.terNO_AUTH
                # auth propagation: if the peer required auth on the source
                # line, the destination line must be authed too (:144-151)
                src_line = self.les.peek(line_idx)
                peer_high_on_src = peer_id > self.account_id
                peer_auth_flag = lsfHighAuth if peer_high_on_src else lsfLowAuth
                if src_line.get(sfFlags, 0) & peer_auth_flag:
                    peer_high_on_dst = peer_id > dst_id
                    dst_auth_flag = (
                        lsfHighAuth if peer_high_on_dst else lsfLowAuth
                    )
                    if not (dst_line.get(sfFlags, 0) & dst_auth_flag):
                        return TER.terNO_AUTH
                dst_high = dst_id > peer_id
                dst_bal = dst_line[sfBalance]
                final = dst_bal - my_bal if dst_high else dst_bal + my_bal
                limit = dst_line[sfHighLimit if dst_high else sfLowLimit]
                # limit check in the destination's perspective (:160-166)
                if (dst_high and final < -limit) or (
                    not dst_high and final > limit
                ):
                    return TER.terNO_AUTH
                dst_line[sfBalance] = final
                self.les.modify(dst_line_idx)

            low_id = self.account_id if low_id_is_me else peer_id
            high_id = peer_id if low_id_is_me else self.account_id
            ter = trust_delete(self.les, line_idx, low_id, high_id)
            if ter != TER.tesSUCCESS:
                return TER.tefINTERNAL

        # delete offers (reference: :212-227)
        for offer_idx in offers:
            ter = offer_delete(self.les, offer_idx)
            if ter != TER.tesSUCCESS:
                return TER.tefINTERNAL

        # move native balance, delete source account (reference: :199-231)
        move = self.source_balance
        self.account[sfBalance] = STAmount.from_drops(0)
        dst[sfBalance] = dst[sfBalance] + move
        self.les.modify(dst_idx)
        self.les.erase(indexes.account_root_index(self.account_id))
        return TER.tesSUCCESS
