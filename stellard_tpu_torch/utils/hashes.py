"""Protocol hash primitives.

The reference derives every identity and tree hash from two constructions
(reference: src/ripple_data/protocol/Serializer.cpp:342-390,
src/ripple/sslutil/api/HashUtilities.h:32-54):

- **SHA-512-half**: the first 256 bits of SHA-512 over the payload, with an
  optional 4-byte big-endian domain-separation prefix
  (src/ripple_data/protocol/HashPrefix.cpp:25-32).
- **Hash160**: RIPEMD160(SHA256(payload)) — account IDs from public keys.
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
    "hash160",
    "sha256d_checksum",
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


def hash160(data: bytes) -> bytes:
    """RIPEMD160(SHA256(data)) — 20-byte account ID from a public key
    (reference: sslutil HashUtilities Hash160; StellarPublicKey.cpp:37-40).
    OpenSSL 3 builds may lack ripemd160; the pure-Python digest is then
    used."""
    inner = hashlib.sha256(data).digest()
    try:
        h = hashlib.new("ripemd160")
    except ValueError:
        from .ripemd160 import ripemd160

        return ripemd160(inner)
    h.update(inner)
    return h.digest()


def sha256d_checksum(data: bytes) -> bytes:
    """First 4 bytes of SHA256(SHA256(data)) — Base58Check checksum
    (reference: src/ripple/types/impl/Base58.cpp encodeWithCheck)."""
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()[:4]
