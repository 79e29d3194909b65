"""Ledger-entry index calculators.

Each state-tree key is the SHA-512-half of a 2-byte namespace tag plus the
identifying fields (reference: src/ripple_app/ledger/Ledger.cpp:1497-1790,
namespace chars at src/ripple_data/protocol/LedgerFormats.h:80-93).
"""

from __future__ import annotations

from ..utils.hashes import sha512_half

__all__ = [
    "account_root_index",
    "offer_index",
    "owner_dir_index",
    "ripple_state_index",
    "dir_node_index",
    "book_base",
    "quality_index",
    "get_quality",
    "quality_next",
    "fee_index",
    "amendment_index",
    "skip_list_index",
    "skip_list_index_for",
]

# namespace tags (LedgerFormats.h:80-93)
_ACCOUNT = ord("a")
_DIR_NODE = ord("d")
_RIPPLE = ord("r")
_OFFER = ord("o")
_OWNER_DIR = ord("O")
_BOOK_DIR = ord("B")
_SKIP_LIST = ord("s")
_AMENDMENT = ord("f")
_FEE = ord("e")


def _idx(space: int, *parts: bytes) -> bytes:
    return sha512_half(space.to_bytes(2, "big") + b"".join(parts))


def account_root_index(account_id: bytes) -> bytes:
    """reference: Ledger::getAccountRootIndex (Ledger.cpp:1527)"""
    return _idx(_ACCOUNT, account_id)


def offer_index(account_id: bytes, sequence: int) -> bytes:
    """reference: Ledger::getOfferIndex (Ledger.cpp:1751)"""
    return _idx(_OFFER, account_id, sequence.to_bytes(4, "big"))


def owner_dir_index(account_id: bytes) -> bytes:
    """reference: Ledger::getOwnerDirIndex (Ledger.cpp:1762)"""
    return _idx(_OWNER_DIR, account_id)


def ripple_state_index(a: bytes, b: bytes, currency: bytes) -> bytes:
    """Trust-line key: low account first (reference:
    Ledger::getRippleStateIndex, Ledger.cpp:1772)."""
    lo, hi = (a, b) if a < b else (b, a)
    return _idx(_RIPPLE, lo, hi, currency)


def dir_node_index(dir_root: bytes, node_index: int) -> bytes:
    """reference: Ledger::getDirNodeIndex (Ledger.cpp:1733)"""
    if node_index == 0:
        return dir_root
    return _idx(_DIR_NODE, dir_root, node_index.to_bytes(8, "big"))


def quality_index(base: bytes, node_dir: int = 0) -> bytes:
    """Base index with the low 8 bytes replaced by big-endian `node_dir`
    (reference: Ledger::getQualityIndex, Ledger.cpp:1497)."""
    return base[:24] + node_dir.to_bytes(8, "big")


def get_quality(index: bytes) -> int:
    """reference: Ledger::getQuality (Ledger.cpp:1510)"""
    return int.from_bytes(index[24:32], "big")


def quality_next(base: bytes) -> bytes:
    """Smallest index with a strictly larger quality prefix
    (reference: Ledger::getQualityNext, Ledger.cpp:1515)."""
    v = int.from_bytes(base, "big") + (1 << 64)
    return v.to_bytes(32, "big")


def book_base(pays_currency: bytes, pays_issuer: bytes,
              gets_currency: bytes, gets_issuer: bytes) -> bytes:
    """Order-book directory base, quality zeroed (reference:
    Ledger::getBookBase, Ledger.cpp — note currency,currency,issuer,issuer
    field order)."""
    h = _idx(_BOOK_DIR, pays_currency, gets_currency, pays_issuer, gets_issuer)
    return quality_index(h, 0)


def fee_index() -> bytes:
    """reference: Ledger::getLedgerFeeIndex (Ledger.cpp:1537)"""
    return _idx(_FEE)


def amendment_index() -> bytes:
    """reference: Ledger::getLedgerAmendmentIndex (Ledger.cpp:1545)"""
    return _idx(_AMENDMENT)


def skip_list_index() -> bytes:
    """reference: Ledger::getLedgerHashIndex (Ledger.cpp:1553)"""
    return _idx(_SKIP_LIST)


def skip_list_index_for(ledger_seq: int) -> bytes:
    """Skip-list page holding hashes around `ledger_seq`
    (reference: Ledger::getLedgerHashIndex(seq), Ledger.cpp:1561)."""
    return _idx(_SKIP_LIST, (ledger_seq >> 16).to_bytes(4, "big"))
