"""Ledger view helpers: trust lines, rippling credit, balances, offers.

Reference: the transactional helpers on LedgerEntrySet
(src/ripple_app/ledger/LedgerEntrySet.cpp): trustCreate (:1239-1312),
trustDelete (:1314-1350), rippleCredit (:1570-1650), rippleSend
(:1652-1696), accountSend (:1698-1760), rippleTransferFee,
accountHolds/accountFunds, offerDelete. Implemented as free functions over
our LedgerEntrySet.

Conventions (identical to the reference):
- a trust line (ltRIPPLE_STATE) is keyed by {low account, high account,
  currency}; sfBalance is from the LOW account's perspective with neutral
  issuer ACCOUNT_ONE; sfLowLimit/sfHighLimit carry each side's limit with
  that side as issuer.
- transfer fees: sending third-party IOUs costs amount * TransferRate
  (rate stored in the issuer's account root, 1e9 = no fee).
"""

from __future__ import annotations

from typing import Optional

from ..protocol.formats import LedgerEntryType
from ..protocol.sfields import (
    sfBalance,
    sfFlags,
    sfHighLimit,
    sfHighNode,
    sfHighQualityIn,
    sfHighQualityOut,
    sfLowLimit,
    sfLowNode,
    sfLowQualityIn,
    sfLowQualityOut,
    sfOwnerCount,
    sfTransferRate,
)
from ..protocol.stamount import STAmount
from ..protocol.ter import TER
from ..state import indexes
from ..state.entryset import LedgerEntrySet
from .flags import (
    lsfHighAuth,
    lsfHighNoRipple,
    lsfHighReserve,
    lsfLowAuth,
    lsfLowNoRipple,
    lsfLowReserve,
    lsfRequireAuth,
)

__all__ = [
    "ACCOUNT_ONE",
    "QUALITY_ONE",
    "trust_create",
    "trust_delete",
    "ripple_balance",
    "ripple_credit",
    "ripple_send",
    "account_send",
    "ripple_transfer_rate",
    "ripple_transfer_fee",
    "account_holds",
    "account_funds",
    "offer_delete",
]

ACCOUNT_ONE = (0).to_bytes(19, "big") + b"\x01"  # neutral issuer marker
QUALITY_ONE = 1_000_000_000  # 1e9 == parity (reference QUALITY_ONE)


def owner_count_adjust(les: LedgerEntrySet, account_id: bytes, delta: int) -> None:
    les.adjust_owner_count(account_id, delta)


# --------------------------------------------------------------------------
# trust lines


def trust_create(
    les: LedgerEntrySet,
    src_high: bool,
    src_id: bytes,
    dst_id: bytes,
    index: bytes,
    auth: bool,
    no_ripple: bool,
    balance: STAmount,  # balance of the account being set, issuer ACCOUNT_ONE
    limit: STAmount,  # limit for the account being charged (its issuer = that account)
    quality_in: int = 0,
    quality_out: int = 0,
) -> TER:
    """reference: LedgerEntrySet::trustCreate (LedgerEntrySet.cpp:1239)"""
    low_id = dst_id if src_high else src_id
    high_id = src_id if src_high else dst_id

    line = les.create(LedgerEntryType.ltRIPPLE_STATE, index)

    ter, low_node = les.dir_add(indexes.owner_dir_index(low_id), index)
    if ter != TER.tesSUCCESS:
        return ter
    ter, high_node = les.dir_add(indexes.owner_dir_index(high_id), index)
    if ter != TER.tesSUCCESS:
        return ter

    set_dst = limit.issuer == dst_id
    set_high = src_high ^ set_dst  # which side the limit belongs to

    line[sfLowNode] = low_node
    line[sfHighNode] = high_node
    line[sfHighLimit if set_high else sfLowLimit] = limit
    other = src_id if set_dst else dst_id
    line[sfLowLimit if set_high else sfHighLimit] = STAmount.zero_like(
        balance.currency, other
    )
    if quality_in:
        line[sfHighQualityIn if set_high else sfLowQualityIn] = quality_in
    if quality_out:
        line[sfHighQualityOut if set_high else sfLowQualityOut] = quality_out

    flags = lsfHighReserve if set_high else lsfLowReserve
    if auth:
        flags |= lsfHighAuth if set_high else lsfLowAuth
    if no_ripple:
        flags |= lsfHighNoRipple if set_high else lsfLowNoRipple
    line[sfFlags] = flags

    owner_count_adjust(les, dst_id if set_dst else src_id, 1)

    # stored balance is low-perspective
    stored = -balance if set_high else balance
    line[sfBalance] = STAmount.from_iou(
        balance.currency, ACCOUNT_ONE, stored.mantissa, stored.offset, stored.negative
    )
    return TER.tesSUCCESS


def trust_delete(les: LedgerEntrySet, line_index: bytes,
                 low_id: bytes, high_id: bytes) -> TER:
    """reference: LedgerEntrySet::trustDelete (LedgerEntrySet.cpp:1314)"""
    line = les.peek(line_index)
    if line is None:
        return TER.tefBAD_LEDGER
    low_node = line.get(sfLowNode, 0)
    high_node = line.get(sfHighNode, 0)
    ter = les.dir_delete(indexes.owner_dir_index(low_id), low_node, line_index)
    if ter != TER.tesSUCCESS:
        return ter
    ter = les.dir_delete(indexes.owner_dir_index(high_id), high_node, line_index)
    if ter != TER.tesSUCCESS:
        return ter
    les.erase(line_index)
    return TER.tesSUCCESS


def ripple_balance(les: LedgerEntrySet, account_id: bytes, issuer_id: bytes,
                   currency: bytes) -> STAmount:
    """Balance of `account_id` on its line with `issuer_id`, from the
    account's perspective (reference: rippleHolds/rippleBalance)."""
    line = les.peek(indexes.ripple_state_index(account_id, issuer_id, currency))
    if line is None:
        return STAmount.zero_like(currency, issuer_id)
    bal = line[sfBalance]
    if account_id > issuer_id:
        bal = -bal
    return STAmount.from_iou(currency, issuer_id, bal.mantissa, bal.offset,
                             bal.negative)


def ripple_credit(les: LedgerEntrySet, sender_id: bytes, receiver_id: bytes,
                  amount: STAmount, check_issuer: bool = True) -> TER:
    """Move `amount` of IOU credit from sender to receiver on their mutual
    line, creating the line if absent and deleting it when it returns to
    default (reference: rippleCredit, LedgerEntrySet.cpp:1570-1650)."""
    assert sender_id != receiver_id
    currency = amount.currency
    sender_high = sender_id > receiver_id
    index = indexes.ripple_state_index(sender_id, receiver_id, currency)
    line = les.peek(index)

    if line is None:
        balance = STAmount.from_iou(
            currency, ACCOUNT_ONE, amount.mantissa, amount.offset, amount.negative
        )
        return trust_create(
            les,
            sender_high,
            sender_id,
            receiver_id,
            index,
            auth=False,
            no_ripple=False,
            balance=balance,
            limit=STAmount.zero_like(currency, receiver_id),
        )

    balance = line[sfBalance]
    if sender_high:
        balance = -balance  # sender terms
    before = balance
    balance = balance - amount

    # RequireAuth gate (reference: PathState::pushNode:309 — "can't
    # receive IOUs from issuer without auth", terNO_AUTH): ANY movement
    # whose SENDER set lsfRequireAuth across a line lacking the
    # sender-side auth flag is refused, unconditionally of balances
    # (the reference checks the edge at path-expansion time).
    if amount.signum() > 0:
        sender_root = les.peek(indexes.account_root_index(sender_id))
        if sender_root is not None and (
            sender_root.get(sfFlags, 0) & lsfRequireAuth
        ):
            sender_auth = lsfHighAuth if sender_high else lsfLowAuth
            if not (line.get(sfFlags, 0) & sender_auth):
                return TER.terNO_AUTH

    # line returned to default on the sender's side? clear reserve/delete
    # (reference: LedgerEntrySet.cpp:1620-1650)
    flags = line.get(sfFlags, 0)
    sender_reserve = lsfHighReserve if sender_high else lsfLowReserve
    sender_no_ripple = lsfHighNoRipple if sender_high else lsfLowNoRipple
    sender_limit = line.get(sfHighLimit if sender_high else sfLowLimit)
    sender_qin = line.get(sfHighQualityIn if sender_high else sfLowQualityIn, 0)
    sender_qout = line.get(sfHighQualityOut if sender_high else sfLowQualityOut, 0)

    delete_line = False
    if (
        before.signum() > 0
        and balance.signum() <= 0
        and (flags & sender_reserve)
        and not (flags & sender_no_ripple)
        and (sender_limit is None or sender_limit.is_zero())
        and not sender_qin
        and not sender_qout
    ):
        owner_count_adjust(les, sender_id, -1)
        line[sfFlags] = flags & ~sender_reserve
        receiver_reserve = lsfLowReserve if sender_high else lsfHighReserve
        if balance.is_zero() and not (line[sfFlags] & receiver_reserve):
            delete_line = True

    if sender_high:
        balance = -balance  # back to low terms
    line[sfBalance] = STAmount.from_iou(
        currency, ACCOUNT_ONE, balance.mantissa, balance.offset, balance.negative
    )
    les.modify(index)

    if delete_line:
        low_id = receiver_id if sender_high else sender_id
        high_id = sender_id if sender_high else receiver_id
        return trust_delete(les, index, low_id, high_id)
    return TER.tesSUCCESS


def ripple_transfer_rate(les: LedgerEntrySet, issuer_id: bytes) -> int:
    """Issuer's TransferRate, 1e9 = parity
    (reference: rippleTransferRate)."""
    acct = les.account_root(issuer_id)
    if acct is None:
        return QUALITY_ONE
    rate = acct.get(sfTransferRate, 0)
    return rate if rate else QUALITY_ONE


def ripple_quality(
    les: LedgerEntrySet,
    to_id: bytes,
    from_id: bytes,
    currency: bytes,
    inbound: bool,
) -> int:
    """`to_id`'s QualityIn (inbound=True) or QualityOut on its line with
    `from_id`, 1e9 = parity; parity when absent / no line / self
    (reference: LedgerEntrySet::rippleQualityIn/Out,
    LedgerEntrySet.cpp:1225 — field picked from to_id's side of the
    line, zero clamped to 1 against divide-by-zero)."""
    from ..protocol.sfields import (
        sfHighQualityIn,
        sfHighQualityOut,
        sfLowQualityIn,
        sfLowQualityOut,
    )
    from ..state import indexes as _ix

    if to_id == from_id:
        return QUALITY_ONE
    line = les.peek(_ix.ripple_state_index(to_id, from_id, currency))
    if line is None:
        return QUALITY_ONE
    is_low = to_id < from_id
    if inbound:
        field = sfLowQualityIn if is_low else sfHighQualityIn
    else:
        field = sfLowQualityOut if is_low else sfHighQualityOut
    q = line.get(field, 0)
    if not q:
        q = QUALITY_ONE if field not in line else 1
    return q


def ripple_transfer_fee(les: LedgerEntrySet, sender_id: bytes,
                        receiver_id: bytes, issuer_id: bytes,
                        amount: STAmount) -> STAmount:
    """Fee charged by the issuer for third-party transfer
    (reference: rippleTransferFee)."""
    if sender_id != issuer_id and receiver_id != issuer_id:
        rate = ripple_transfer_rate(les, issuer_id)
        if rate != QUALITY_ONE:
            total = STAmount.multiply(
                amount,
                STAmount.from_iou(amount.currency, ACCOUNT_ONE, rate, -9),
                amount.currency,
                issuer_id,
            )
            return total - amount
    return STAmount.zero_like(amount.currency, issuer_id)


def ripple_send(les: LedgerEntrySet, sender_id: bytes, receiver_id: bytes,
                amount: STAmount) -> tuple[TER, STAmount]:
    """-> (TER, actual cost to sender). reference: rippleSend
    (LedgerEntrySet.cpp:1652-1696)."""
    issuer_id = amount.issuer
    if sender_id == issuer_id or receiver_id == issuer_id or issuer_id == ACCOUNT_ONE:
        ter = ripple_credit(les, sender_id, receiver_id, amount, check_issuer=False)
        return ter, amount
    fee = ripple_transfer_fee(les, sender_id, receiver_id, issuer_id, amount)
    actual = amount + fee if not fee.is_zero() else amount
    actual = STAmount.from_iou(actual.currency, issuer_id, actual.mantissa,
                               actual.offset, actual.negative)
    ter = ripple_credit(les, issuer_id, receiver_id, amount)
    if ter == TER.tesSUCCESS:
        ter = ripple_credit(les, sender_id, issuer_id, actual)
    return ter, actual


def account_send(les: LedgerEntrySet, sender_id: bytes, receiver_id: bytes,
                 amount: STAmount) -> TER:
    """Native or IOU transfer between accounts
    (reference: accountSend, LedgerEntrySet.cpp:1698-1760)."""
    if not amount.is_native:
        ter, _ = ripple_send(les, sender_id, receiver_id, amount)
        return ter
    sender_idx = indexes.account_root_index(sender_id)
    receiver_idx = indexes.account_root_index(receiver_id)
    sender = les.peek(sender_idx)
    receiver = les.peek(receiver_idx)
    if sender is not None:
        if sender[sfBalance] < amount:
            return TER.tecFAILED_PROCESSING
        sender[sfBalance] = sender[sfBalance] - amount
        les.modify(sender_idx)
    if receiver is not None:
        receiver[sfBalance] = receiver[sfBalance] + amount
        les.modify(receiver_idx)
    return TER.tesSUCCESS


# --------------------------------------------------------------------------
# balances / funds


def account_holds(les: LedgerEntrySet, account_id: bytes, currency: bytes,
                  issuer_id: bytes) -> STAmount:
    """Spendable balance of one asset (reference: accountHolds — native:
    balance minus reserve; IOU: line balance)."""
    if currency == b"\x00" * 20:  # native
        acct = les.account_root(account_id)
        if acct is None:
            return STAmount.from_drops(0)
        reserve = les.ledger.reserve(acct.get(sfOwnerCount, 0))
        bal = acct[sfBalance]
        avail = bal.mantissa - reserve
        return STAmount.from_drops(max(0, avail))
    bal = ripple_balance(les, account_id, issuer_id, currency)
    if bal.negative:
        return STAmount.zero_like(currency, issuer_id)
    return bal


def account_funds(les: LedgerEntrySet, account_id: bytes,
                  amount: STAmount) -> STAmount:
    """Funds available to deliver `amount` (reference: accountFunds —
    issuers of their own IOU are unlimited)."""
    if not amount.is_native and account_id == amount.issuer:
        return amount
    return account_holds(les, account_id, amount.currency, amount.issuer)


# --------------------------------------------------------------------------
# offers


def offer_delete(les: LedgerEntrySet, offer_index: bytes) -> TER:
    """Remove an offer and its directory entries
    (reference: offerDelete, LedgerEntrySet.cpp)."""
    from ..protocol.sfields import sfAccount, sfBookDirectory, sfBookNode, sfOwnerNode

    offer = les.peek(offer_index)
    if offer is None:
        return TER.tesSUCCESS
    owner = offer[sfAccount]
    ter = les.dir_delete(
        indexes.owner_dir_index(owner), offer.get(sfOwnerNode, 0), offer_index
    )
    if ter != TER.tesSUCCESS:
        return ter
    ter = les.dir_delete(
        offer[sfBookDirectory], offer.get(sfBookNode, 0), offer_index
    )
    if ter != TER.tesSUCCESS:
        return ter
    owner_count_adjust(les, owner, -1)
    les.erase(offer_index)
    return TER.tesSUCCESS
