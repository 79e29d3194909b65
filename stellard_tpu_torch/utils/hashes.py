"""Protocol hash primitives.

The reference derives every tree hash from **SHA-512-half**: the first
256 bits of SHA-512 over the payload, with an optional 4-byte big-endian
domain-separation prefix (reference: src/ripple_data/protocol/
Serializer.cpp:342-390, HashPrefix.cpp:25-32).
"""

from __future__ import annotations

import hashlib

__all__ = [
    "sha512_half",
    "prefix_hash",
    "HP_TXN_ID",
    "HP_TX_NODE",
    "HP_LEAF_NODE",
    "HP_INNER_NODE",
    "HP_LEDGER_MASTER",
    "HP_TX_SIGN",
    "HP_VALIDATION",
    "HP_PROPOSAL",
]


def _hp(a: str, b: str, c: str) -> int:
    """4-byte hash prefix: three ASCII chars then a zero byte
    (reference: src/ripple_data/protocol/HashPrefix.h:48-55)."""
    return (ord(a) << 24) | (ord(b) << 16) | (ord(c) << 8)


# Domain-separation prefixes (reference: HashPrefix.cpp:25-32). Protocol
# constants — these exact values are part of the wire/hash format.
HP_TXN_ID = _hp("T", "X", "N")  # transaction plus signature -> txn ID
HP_TX_NODE = _hp("S", "N", "D")  # tx-tree leaf (tx plus metadata)
HP_LEAF_NODE = _hp("M", "L", "N")  # state-tree leaf
HP_INNER_NODE = _hp("M", "I", "N")  # inner tree node
HP_LEDGER_MASTER = _hp("L", "W", "R")  # ledger header
HP_TX_SIGN = _hp("S", "T", "X")  # transaction signing
HP_VALIDATION = _hp("V", "A", "L")  # validation signing
HP_PROPOSAL = _hp("P", "R", "P")  # proposal signing


def sha512_half(data: bytes) -> bytes:
    """First 32 bytes of SHA-512 (reference: Serializer.cpp:356-365)."""
    return hashlib.sha512(data).digest()[:32]


def prefix_hash(prefix: int, data: bytes) -> bytes:
    """SHA-512-half of (4-byte BE prefix || data)
    (reference: Serializer.cpp:380-390, getPrefixHash)."""
    return hashlib.sha512(prefix.to_bytes(4, "big") + data).digest()[:32]
