"""Field arithmetic mod p = 2^255 - 19 in plain PyTorch.

The same representation as the JAX package's fe25519, so intermediates
compare limb for limb: 20 limbs x 13 bits in int32, little-endian limb
order, LIMB-MAJOR layout [20, *batch] (the batch axes trail).

Invariant maintained by every op: limbs in [0, 9500] ("bounded
redundant"; mul-safe since 20 * 9500^2 < 2^31). A value is brought into
canonical [0, p) form only where bytes / equality / parity are produced
(``fe_reduce_full``).

This module is the arithmetic of the plain verify (``ops.ed25519``), the
reference the CUDA kernel is held against; the kernel itself uses
radix-2^51 limbs (``csrc/ed25519_verify.cu``).

Multiply: the 20 x 20 limb products are formed as one outer product and
the 39 column sums are taken by a skewed reshape (row i shifted right by
i) and one sum — a handful of tensor ops instead of one per product. The
column sums are exact integers below 2^31, so they equal the reference's
in any summation order; squaring is the same product (the symmetric
halving of the reference yields identical column sums).
"""

from __future__ import annotations

import numpy as np
import torch

NLIMB = 20
BITS = 13
MASK = (1 << BITS) - 1
P = (1 << 255) - 19
FOLD = 608  # 2^260 mod p = 19 * 2^5

D = (-121665 * pow(121666, P - 2, P)) % P  # Edwards d
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)
L = (1 << 252) + 27742317777372353535851937790883648493  # group order l

BOUND = 9500


def int_to_limbs_np(x: int, n: int = NLIMB) -> np.ndarray:
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & MASK
        x >>= BITS
    if x:
        raise ValueError("value does not fit in limbs")
    return out


def limbs_to_int(limbs) -> int:
    limbs = np.asarray(limbs)
    return sum(int(v) << (BITS * i) for i, v in enumerate(limbs))


_P_LIMBS = int_to_limbs_np(P)
# Subtraction bias 38p, limb-wise 38 * (limbs of p): every bias limb
# (min 38*255 = 9690) dominates any invariant limb (<= 9500), so
# a + bias - b is limb-wise non-negative, and bias ≡ 0 (mod p).
_BIAS_LIMBS = (38 * _P_LIMBS).astype(np.int32)


def _col(limbs_np: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """[20] constant -> [20, 1, ...] int32 on like's device, broadcasting
    against a limb-major tensor of like's rank."""
    t = torch.as_tensor(np.asarray(limbs_np, np.int32), device=like.device)
    return t.reshape((NLIMB,) + (1,) * (like.dim() - 1))


def _align2(a: torch.Tensor, b: torch.Tensor):
    """Limb-major rank alignment: a [20] constant aligns with
    [20, *batch] by APPENDING singleton batch axes."""
    if a.dim() < b.dim():
        a = a.reshape(tuple(a.shape) + (1,) * (b.dim() - a.dim()))
    elif b.dim() < a.dim():
        b = b.reshape(tuple(b.shape) + (1,) * (a.dim() - b.dim()))
    return a, b


def fe_const(x: int, batch_shape=(), device="cpu") -> torch.Tensor:
    limbs = torch.as_tensor(int_to_limbs_np(x % P), device=device)
    out = limbs.reshape((NLIMB,) + (1,) * len(batch_shape))
    return out.expand((NLIMB,) + tuple(batch_shape))


def _shift_up(hi: torch.Tensor) -> torch.Tensor:
    """Limb k's carry lands on limb k+1; limb 0 gets zero."""
    return torch.cat([torch.zeros_like(hi[:1]), hi[:-1]], dim=0)


def _carry(c: torch.Tensor, steps: int) -> torch.Tensor:
    """Global carry-propagation steps (arithmetic shifts, so signed values
    borrow correctly). Value-preserving; callers size buffers so the top
    limb's carry-out is never dropped."""
    for _ in range(steps):
        c = (c & MASK) + _shift_up(c >> BITS)
    return c


def _carry20_fold(c: torch.Tensor) -> torch.Tensor:
    """One carry sweep over a 20-limb value with limbs < 2^18.3, folding
    the limb-19 carry-out (weight 2^260) onto limb 0 as * FOLD."""
    hi = c >> BITS
    out = (c & MASK) + _shift_up(hi)
    return torch.cat([(out[0] + FOLD * hi[19])[None], out[1:]], dim=0)


def _finish_mul_t(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Shared tail of multiply/square: fold the 19 high columns
    (weights 2^260..) onto the 20 low ones via 2^260 ≡ FOLD, then carry.

    lo: [20, *batch] column sums < 2^31. hi: [19, *batch] column sums."""
    hi = torch.cat([hi, hi.new_zeros((2,) + tuple(hi.shape[1:]))], dim=0)
    hi = _carry(hi, 2)  # limbs <= MASK + 33
    c = lo + FOLD * hi[:20]  # < 2^31
    c0 = c[0] + (FOLD * FOLD) * hi[20]
    c = torch.cat(
        [c0[None], c[1:], c.new_zeros((2,) + tuple(c.shape[1:]))], dim=0
    )
    c = _carry(c, 2)
    h = c[19] >> 8  # bits >= 2^255 in limb 19
    c0 = c[0] + 19 * h + FOLD * (c[20] + (c[21] << BITS))
    c = torch.cat([c0[None], c[1:19], (c[19] & 0xFF)[None]], dim=0)
    return _carry(c, 2)  # limbs <= MASK + 33 < BOUND


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 20x20 product -> 39 column sums + fold."""
    a, b = torch.broadcast_tensors(*_align2(a, b))
    batch = tuple(a.shape[1:])
    prod = a[:, None] * b[None, :]  # [20, 20, *batch]; prod[i, j] = a_i b_j
    # skew: pad each row to 40 columns, flatten, drop the last 20 entries
    # and view as [20, 39] — row i then starts at column i (proof: entry
    # (r, c) is flat 39r + c = 40r + (c - r))
    padded = torch.cat([prod, prod.new_zeros((NLIMB, NLIMB) + batch)], dim=1)
    skew = padded.reshape((2 * NLIMB * NLIMB,) + batch)[: NLIMB * 39]
    cols = skew.reshape((NLIMB, 39) + batch).sum(dim=0, dtype=torch.int32)
    return _finish_mul_t(cols[:NLIMB], cols[NLIMB:])


def fe_square(a: torch.Tensor) -> torch.Tensor:
    return fe_mul(a, a)


def fe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _align2(a, b)
    return _carry20_fold(a + b)


def fe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _align2(a, b)
    like = a if a.dim() >= b.dim() else b
    return _carry20_fold(a + _col(_BIAS_LIMBS, like) - b)


def fe_neg(a: torch.Tensor) -> torch.Tensor:
    return fe_sub(torch.zeros_like(a), a)


def fe_reduce_full(a: torch.Tensor) -> torch.Tensor:
    """Exact canonical form: value in [0, p), limbs < 2^13.

    Folding limb 19's bits >= 2^255 FIRST (2^255 ≡ 19) brings the value
    under 2p before any carry sweep; the conditional subtract then
    handles the last excess."""
    h = a[19] >> 8
    c = torch.cat([(a[0] + 19 * h)[None], a[1:19], (a[19] & 0xFF)[None]], dim=0)
    c = _carry(c, NLIMB + 1)
    ge = (c[19] >= 0x100) | (
        (c[19] == 0xFF)
        & torch.all(c[1:19] == MASK, dim=0)
        & (c[0] >= MASK - 18)
    )
    p_col = _col(_P_LIMBS, c)
    c = c - torch.where(ge, p_col, torch.zeros_like(p_col))
    return _carry(c, NLIMB + 1)


def limbs_lt_p(a: torch.Tensor) -> torch.Tensor:
    """[20, *batch] canonical-per-limb value -> [*batch] bool: value < p
    (most-significant-first compare)."""
    p_col = _col(_P_LIMBS, a)
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    all_eq = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    for k in range(NLIMB - 1, -1, -1):
        lt = lt | (all_eq & (a[k] < p_col[k]))
        all_eq = all_eq & (a[k] == p_col[k])
    return lt


def _sqn(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = fe_square(a)
    return a


def _chain_250(a: torch.Tensor):
    """Core of the curve25519 inversion/sqrt addition chains: returns
    (a^(2^250 - 1), a^11)."""
    z2 = fe_square(a)
    z9 = fe_mul(_sqn(z2, 2), a)
    z11 = fe_mul(z9, z2)
    z2_5_0 = fe_mul(fe_square(z11), z9)
    z2_10_0 = fe_mul(_sqn(z2_5_0, 5), z2_5_0)
    z2_20_0 = fe_mul(_sqn(z2_10_0, 10), z2_10_0)
    z2_40_0 = fe_mul(_sqn(z2_20_0, 20), z2_20_0)
    z2_50_0 = fe_mul(_sqn(z2_40_0, 10), z2_10_0)
    z2_100_0 = fe_mul(_sqn(z2_50_0, 50), z2_50_0)
    z2_200_0 = fe_mul(_sqn(z2_100_0, 100), z2_100_0)
    z2_250_0 = fe_mul(_sqn(z2_200_0, 50), z2_50_0)
    return z2_250_0, z11


def fe_invert(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) = a^(2^255 - 21): 254 squarings + 11 multiplies."""
    z2_250_0, z11 = _chain_250(a)
    return fe_mul(_sqn(z2_250_0, 5), z11)


def fe_pow_p58(a: torch.Tensor) -> torch.Tensor:
    """a^((p-5)/8) = a^(2^252 - 3): 252 squarings + 11 multiplies."""
    z2_250_0, _ = _chain_250(a)
    return fe_mul(_sqn(z2_250_0, 2), a)


def fe_is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(fe_reduce_full(a) == 0, dim=0)


def fe_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ra, rb = _align2(fe_reduce_full(a), fe_reduce_full(b))
    return torch.all(ra == rb, dim=0)


def fe_is_odd(a: torch.Tensor) -> torch.Tensor:
    return (fe_reduce_full(a)[0] & 1) == 1


def fe_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where cond else b; cond is [*batch], a/b are [20, *batch]."""
    a, b = _align2(a, b)
    return torch.where(cond, a, b)


def limbs_from_words_le(words: torch.Tensor, mask_high: bool = True) -> torch.Tensor:
    """[8, *batch] little-endian u32 words (any integer dtype holding the
    32-bit pattern) -> [20, *batch] int32 limbs. With mask_high, bit 255
    (the point-compression sign bit) is dropped."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    out = []
    for k in range(NLIMB):
        bit = BITS * k
        a, r = divmod(bit, 32)
        lo = w[a] >> r
        if r + BITS > 32 and a + 1 < 8:
            lo = lo | (w[a + 1] << (32 - r))
        lo = lo & MASK
        if mask_high and k == NLIMB - 1:
            lo = lo & 0xFF
        out.append(lo.to(torch.int32))
    return torch.stack(out, dim=0)


def limbs_to_words_le(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical [20, *batch] limbs -> [8, *batch] int64 holding the u32
    little-endian words."""
    l = limbs.to(torch.int64)
    words = []
    for wi in range(8):
        bit0 = 32 * wi
        w = torch.zeros(limbs.shape[1:], dtype=torch.int64, device=limbs.device)
        for k in range(NLIMB):
            lb = BITS * k
            if lb + BITS <= bit0 or lb >= bit0 + 32:
                continue
            sh = lb - bit0
            w = w | ((l[k] << sh) if sh >= 0 else (l[k] >> (-sh)))
        words.append(w & 0xFFFFFFFF)
    return torch.stack(words, dim=0)
