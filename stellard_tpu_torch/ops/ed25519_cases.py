"""Adversarial Ed25519 signature corpus, made from a seed.

Consensus splits on any verdict divergence, so every verify path (the
CUDA kernel, the plain PyTorch version, the oracle) is held to the same
verdicts on these cases: malformed and small-order keys, non-canonical
encodings of R and A, S >= l, the small-order forgery that ref10
semantics accept, and random bit flips.
"""

from __future__ import annotations

import numpy as np

from . import ed25519_ref as ref


def keypair(seed: bytes) -> tuple[bytes, bytes]:
    return seed, ref.derive_public(seed)


def adversarial_cases(seed: int = 11, n_random: int = 21) -> list[tuple]:
    """-> [(kind, public, message, signature)]: the fixed edge cases,
    then n_random signatures of which about two thirds are corrupted
    (one bit of the signature, or a different message)."""
    rng = np.random.default_rng(seed)
    sk, pk = keypair(rng.bytes(32))
    m = rng.bytes(32)
    good = ref.sign(sk, pk, m)
    ident = (1).to_bytes(32, "little")  # canonical identity encoding
    zero_s = bytes(32)
    x0_sign1 = bytearray(ident)
    x0_sign1[31] |= 0x80
    s_plus_l = int.from_bytes(good[32:], "little") + ref.L
    cases = [
        ("key_y0", bytes(32), m, good),
        ("key_identity", ident, m, good),
        ("key_invalid", b"\xff" * 32, m, good),
        ("key_noncanonical_y", (ref.P + 1).to_bytes(32, "little"), m, good),
        ("bad_r", pk, m, b"\xff" * 32 + good[32:]),
        ("valid", pk, m, good),
        ("r_noncanonical", ident, m, (1 + ref.P).to_bytes(32, "little") + zero_s),
        ("r_x0_sign1", ident, m, bytes(x0_sign1) + zero_s),
        ("small_order_forgery", ident, m, ident + zero_s),  # ref10 accepts
        ("noncanonical_key_forgery", (ref.P + 1).to_bytes(32, "little"), m,
         ident + zero_s),
        ("r_off_curve", pk, m, b"\x17" * 32 + zero_s),
        ("wrong_key", keypair(rng.bytes(32))[1], m, good),
        ("short_signature", pk, m, good[:63]),
    ]
    if s_plus_l < 1 << 256:
        cases.append(("s_ge_l", pk, m, good[:32] + s_plus_l.to_bytes(32, "little")))
    for i in range(n_random):
        sk_i, pk_i = keypair(rng.bytes(32))
        mm = rng.bytes(32)
        sig = bytearray(ref.sign(sk_i, pk_i, mm))
        kind = "random_valid"
        if i % 3 == 1:
            sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
            kind = "random_bitflip"
        elif i % 3 == 2:
            mm = rng.bytes(32)
            kind = "random_other_message"
        cases.append((kind, pk_i, mm, bytes(sig)))
    return cases
