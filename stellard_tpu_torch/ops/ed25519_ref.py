"""Pure-Python Ed25519 reference (big ints) — oracle for the JAX kernels
and generator for the fixed-base comb table.

Implements the same verification equation as libsodium's 2014-era
crypto_sign_verify_detached used by the reference
(reference: src/ripple_data/crypto/StellarPublicKey.cpp:67-77):
R' = [S]B + [h](-A), accept iff encode(R') == R_bytes, with h =
SHA512(R || A || M) mod l. Written from the RFC 8032 / curve equations,
not ported code.
"""

from __future__ import annotations

import hashlib

P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# base point
_BY = (4 * pow(5, P - 2, P)) % P
_BX = None  # recovered below


def _recover_x(y: int, sign: int) -> int | None:
    y2 = (y * y) % P
    u = (y2 - 1) % P
    v = (D * y2 + 1) % P
    # candidate root of u/v via (u/v)^((p+3)/8) = u v^3 (u v^7)^((p-5)/8)
    x = (u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P)) % P
    if (v * x * x) % P == u:
        pass
    elif (v * x * x) % P == (-u) % P:
        x = (x * SQRT_M1) % P
    else:
        return None
    if x == 0 and sign:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
BASE = (_BX, _BY, 1, (_BX * _BY) % P)  # extended coords
IDENTITY = (0, 1, 1, 0)


def pt_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = ((y1 - x1) * (y2 - x2)) % P
    b = ((y1 + x1) * (y2 + x2)) % P
    c = (t1 * 2 * D * t2) % P
    d = (z1 * 2 * z2) % P
    e, f, g, h = (b - a) % P, (d - c) % P, (d + c) % P, (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def pt_double(p):
    return pt_add(p, p)


def scalar_mult(s: int, p):
    q = IDENTITY
    while s:
        if s & 1:
            q = pt_add(q, p)
        p = pt_double(p)
        s >>= 1
    return q


def pt_encode(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = (x * zi) % P, (y * zi) % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def pt_decompress(data: bytes):
    val = int.from_bytes(data, "little")
    y = val & ((1 << 255) - 1)
    sign = val >> 255
    x = _recover_x(y % P, sign)
    if x is None:
        return None
    return (x, y % P, 1, (x * (y % P)) % P)


# -- fixed-base path (key derivation + signing) -----------------------------
#
# RFC 8032 key derivation and signing, so the pure-Python path is
# byte-identical with the host library (cryptography / libsodium):
# a = clamp(SHA512(seed)[:32]), A = [a]B, r = SHA512(prefix || M) mod l,
# R = [r]B, S = (r + SHA512(R||A||M)·a) mod l. Base-point multiples are
# comb-precomputed (64 radix-16 windows) so a sign is ~64 point adds
# instead of a full double-and-add ladder.

_BASE_COMB: list | None = None


def _base_comb() -> list:
    """[window][digit] -> [digit * 16^window]B (digit 0 = identity)."""
    global _BASE_COMB
    if _BASE_COMB is None:
        comb = []
        step = BASE
        for _ in range(64):
            row = [IDENTITY]
            for _d in range(15):
                row.append(pt_add(row[-1], step))
            comb.append(row)
            step = pt_add(row[-1], step)  # 16^(w+1) * B
        _BASE_COMB = comb
    return _BASE_COMB


def scalar_mult_base(s: int):
    """[s]B via the fixed-base comb (≈64 adds; sign/derive hot path)."""
    comb = _base_comb()
    q = IDENTITY
    for w in range(64):
        d = (s >> (4 * w)) & 0xF
        if d:
            q = pt_add(q, comb[w][d])
    return q


def _clamp(h32: bytes) -> int:
    a = int.from_bytes(h32, "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def secret_expand(seed: bytes) -> tuple[int, bytes]:
    """seed -> (clamped secret scalar, 32-byte nonce prefix)."""
    h = hashlib.sha512(seed).digest()
    return _clamp(h[:32]), h[32:]


def derive_public(seed: bytes) -> bytes:
    """crypto_sign_seed_keypair's public half: encode([clamp(h)]B)."""
    a, _ = secret_expand(seed)
    return pt_encode(scalar_mult_base(a))


def sign(seed: bytes, public: bytes, msg: bytes) -> bytes:
    """Detached RFC 8032 signature (byte-identical with the host lib)."""
    a, prefix = secret_expand(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    r_bytes = pt_encode(scalar_mult_base(r))
    h = int.from_bytes(
        hashlib.sha512(r_bytes + public + msg).digest(), "little"
    ) % L
    s = (r + h * a) % L
    return r_bytes + s.to_bytes(32, "little")


def key_is_canonical(public: bytes) -> bool:
    """Whether a key's y encoding (sign bit masked) is below p: libsodium's
    ge25519_is_canonical, which the reference's verify relies on. Every
    verifier of this package rejects a key that is not, so that no two
    of them (K1, its plain version, this oracle, the host library, the
    C++ host verifier) split on a crafted key whose y is decoded mod p."""
    return int.from_bytes(public, "little") & ((1 << 255) - 1) < P


def verify(public: bytes, msg: bytes, sig: bytes) -> bool:
    if len(public) != 32 or len(sig) != 64:
        return False
    if not key_is_canonical(public):
        return False
    a = pt_decompress(public)
    if a is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:  # canonical-S (reference signatureIsCanonical)
        return False
    h = int.from_bytes(hashlib.sha512(sig[:32] + public + msg).digest(), "little") % L
    neg_a = ((P - a[0]) % P, a[1], a[2], (P - a[3]) % P)
    rp = pt_add(scalar_mult(s, BASE), scalar_mult(h, neg_a))
    return pt_encode(rp) == sig[:32]
