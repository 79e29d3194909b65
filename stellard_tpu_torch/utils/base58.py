"""Base58 / Base58Check with the Stellar alphabet.

The reference uses a custom alphabet beginning with 'g' (so version-0
account IDs render as g...) — reference:
src/ripple/types/impl/Base58.cpp:43-49.  Check encoding appends the first
4 bytes of double-SHA256 (Base58.cpp:52-88, 212-233).
"""

from __future__ import annotations

from .hashes import sha256d_checksum

# Protocol constant (reference: Base58.cpp:46)
STELLAR_ALPHABET = "gsphnaf39wBUDNEGHJKLM4PQRST7VWXYZ2bcdeCr65jkm8oFqi1tuvAxyz"
_INDEX = {c: i for i, c in enumerate(STELLAR_ALPHABET)}


def b58_encode(data: bytes, alphabet: str = STELLAR_ALPHABET) -> str:
    n = int.from_bytes(data, "big")
    out = []
    while n > 0:
        n, r = divmod(n, 58)
        out.append(alphabet[r])
    # each leading zero byte encodes as the zero character
    for b in data:
        if b == 0:
            out.append(alphabet[0])
        else:
            break
    return "".join(reversed(out))


def b58_decode(s: str, alphabet: str = STELLAR_ALPHABET) -> bytes:
    index = _INDEX if alphabet is STELLAR_ALPHABET else {c: i for i, c in enumerate(alphabet)}
    n = 0
    for c in s:
        if c not in index:
            raise ValueError(f"invalid base58 character {c!r}")
        n = n * 58 + index[c]
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    pad = 0
    for c in s:
        if c == alphabet[0]:
            pad += 1
        else:
            break
    return b"\x00" * pad + raw


def b58check_encode(version: int, payload: bytes) -> str:
    """Version byte + payload + 4-byte double-SHA256 checksum."""
    data = bytes([version]) + payload
    return b58_encode(data + sha256d_checksum(data))


def b58check_decode(s: str, expected_version: int | None = None) -> tuple[int, bytes]:
    raw = b58_decode(s)
    if len(raw) < 5:
        raise ValueError("base58check string too short")
    data, check = raw[:-4], raw[-4:]
    if sha256d_checksum(data) != check:
        raise ValueError("base58check checksum mismatch")
    version = data[0]
    if expected_version is not None and version != expected_version:
        raise ValueError(f"base58check version {version} != expected {expected_version}")
    return version, data[1:]
