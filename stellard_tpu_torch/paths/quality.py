"""Flattening candidate paths into fixed-shape Q16.16 rate matrices.

The device plane (crypto.backend.PathQualityEvaluator) ranks thousands
of candidate paths per close by composing per-hop rates. This module is
the host-side flattener: each candidate becomes one row of MAX_HOPS
uint32 Q16.16 rates, padded with the identity rate —

* a book hop's rate is the book's best-tier directory quality (the
  64-bit STAmount rate encoded in the directory key — reference:
  Ledger::getQuality on the page getBookBase points at), i.e. what one
  unit out costs in units in at the tip of the book;
* an account hop's rate is the hop account's TransferRate (1e9 =
  parity), the fee a gateway charges for rippling through it.

Lower composite = cheaper path. This is a *ranking pre-pass* feeding
candidate pruning, not execution: exact liquidity still comes from the
flow engine's trial execution of whatever survives the cut.
"""

from __future__ import annotations

import numpy as np

from ..ops.pathq import Q16_MAX, Q16_ONE
from ..protocol.sfields import sfTransferRate
from ..protocol.stamount import ACCOUNT_ZERO
from ..state import indexes
from .orderbook import CURRENCY_XRP, Book

__all__ = [
    "MAX_HOPS",
    "book_quality_q16",
    "build_rate_matrix",
    "rate_u64_to_q16",
]

MAX_HOPS = 8  # matches the pathfinder's deepest shape

_QUALITY_ONE_PPB = 1_000_000_000  # TransferRate parity


DROPS_PER_XRP = 1_000_000


def rate_u64_to_q16(q: int, num: int = 1, den: int = 1) -> int:
    """Decode a directory-key 64-bit rate ((offset+100)<<56 | mantissa,
    value = mantissa * 10^offset) into saturated Q16.16, rescaled by
    num/den (exact integer math — the rescale must not round before
    the final fixed-point truncation)."""
    if q == 0:
        return Q16_ONE
    exp = (q >> 56) - 100
    mantissa = q & ((1 << 56) - 1)
    if exp >= 0:
        v = (mantissa << 16) * (10 ** exp) * num // den
    else:
        v = (mantissa << 16) * num // ((10 ** (-exp)) * den)
    return max(1, min(Q16_MAX, v))


def book_quality_q16(ledger, book: Book) -> int:
    """Best-tier quality of `book` in Q16.16 from the first populated
    page of its directory — one ordered-successor probe, no offer
    reads. An empty book rates Q16_MAX (prune-worthy, not an error).

    Directory qualities price XRP in DROPS (an XRP/IOU book's raw rate
    is ~1e6, far past Q16.16's 65535 ceiling), so XRP legs rescale to
    natural units: rates stay O(1) and comparable across book kinds."""
    base = indexes.book_base(
        book.in_currency, book.in_issuer,
        book.out_currency, book.out_issuer,
    )
    end = indexes.quality_next(base)
    item = ledger.state_map.succ(base)
    if item is None or item.tag >= end:
        return Q16_MAX
    num = DROPS_PER_XRP if book.out_currency == CURRENCY_XRP else 1
    den = DROPS_PER_XRP if book.in_currency == CURRENCY_XRP else 1
    return rate_u64_to_q16(indexes.get_quality(item.tag), num, den)


def _transfer_q16(ledger, account: bytes, memo: dict) -> int:
    q = memo.get(account)
    if q is None:
        acct = ledger.read_entry(indexes.account_root_index(account))
        ppb = acct.get(sfTransferRate, 0) if acct is not None else 0
        ppb = ppb or _QUALITY_ONE_PPB
        q = max(1, min(Q16_MAX, (ppb << 16) // _QUALITY_ONE_PPB))
        memo[account] = q
    return q


def build_rate_matrix(ledger, candidates) -> np.ndarray:
    """[B, MAX_HOPS] uint32 rate matrix for `candidates`, the
    pathfinder's [(path_elems, (src_currency, src_issuer))] list. Hops
    beyond MAX_HOPS saturate the row (over-deep paths rank last rather
    than rank wrong); unused columns pad with the identity rate."""
    books_memo: dict[Book, int] = {}
    xfer_memo: dict[bytes, int] = {}
    rows = np.full((len(candidates), MAX_HOPS), Q16_ONE, dtype=np.uint32)
    for r, (path, (src_c, src_i)) in enumerate(candidates):
        cur_c, cur_i = src_c, src_i
        col = 0
        for el in path:
            if el.currency is not None:
                new_c = el.currency
                new_i = (
                    ACCOUNT_ZERO if new_c == CURRENCY_XRP
                    else (el.issuer if el.issuer is not None else cur_i)
                )
                book = Book(cur_c, cur_i, new_c, new_i)
                q = books_memo.get(book)
                if q is None:
                    q = book_quality_q16(ledger, book)
                    books_memo[book] = q
                cur_c, cur_i = new_c, new_i
            elif el.account is not None:
                q = _transfer_q16(ledger, el.account, xfer_memo)
            else:
                continue
            if col >= MAX_HOPS:
                rows[r, :] = Q16_MAX
                break
            rows[r, col] = q
            col += 1
    return rows
