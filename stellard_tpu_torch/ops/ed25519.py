"""Batched Ed25519 verification: host prep and the plain PyTorch verify.

Accept iff encode([S]B + [h](-A)) == R, S < l and A's y < p, with
h = SHA512(R || A || M) mod l computed on the host (reference:
SerializedTransaction::checkSign -> libsodium crypto_sign_verify_detached,
src/ripple_app/misc/SerializedTransaction.cpp:192-230): in one native call
(``native.Ed25519HostPrep``) where the host library builds, else in Python
(``_h_scalars``), byte for byte the same.

``prepare_batch`` packs a batch into the raw 32-byte wire that the CUDA
kernel (``ops.ed25519_cuda``) takes: public keys and R as [B, 8] u32
little-endian words, S and h as [B, 32] u8 scalar bytes, and the
host-checked ``s_canonical`` flag (129 bytes a signature).

``verify_kernel_ref`` is the plain version the kernel is held against:
the JAX package's verify_kernel in PyTorch over ``ops.fe25519`` (13-bit
limbs, limb-major [20, B]): decompress A, a 9-entry cached table of -A
walked with signed 4-bit digits, and a 64-window fixed-base comb for
[S]B, one shared loop; then the final check of ``VERIFY_CHECK``.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from . import ed25519_ref as ref
from .fe25519 import (
    D,
    D2,
    L,
    NLIMB,
    P,
    SQRT_M1,
    fe_add,
    fe_const,
    fe_eq,
    fe_invert,
    fe_is_odd,
    fe_is_zero,
    fe_mul,
    fe_neg,
    fe_pow_p58,
    fe_reduce_full,
    fe_select,
    fe_square,
    fe_sub,
    int_to_limbs_np,
    limbs_from_words_le,
    limbs_lt_p,
    limbs_to_words_le,
)

WINDOW = 4
NWINDOWS = 64  # ceil(256/4); scalars are < l < 2^253

# the final check, read once at import as the JAX package reads it
# (stellard_tpu/ops/ed25519_jax.py:122-127), with the same two values:
#   bytes - encode [S]B + [h](-A) and byte-compare it with R (ref10
#           crypto_sign_open), which costs an inversion;
#   point - decode R as A is decoded and compare projectively (R's Z is
#           1: X3 == Xr*Z3 and Y3 == Yr*Z3), with y_r < p tested
#           explicitly, as the byte compare rejects a non-canonical R.
# Both give the same verdicts (tests/test_torch_verify_check_modes.py).
CHECKS = ("bytes", "point")
VERIFY_CHECK = os.environ.get("STELLARD_VERIFY_CHECK", "bytes")
if VERIFY_CHECK not in CHECKS:
    raise ValueError(
        f"STELLARD_VERIFY_CHECK={VERIFY_CHECK!r}: expected 'bytes' or "
        "'point'"
    )


def check_mode(check=None) -> str:
    """``check``, or the process's ``VERIFY_CHECK`` when None; any other
    value than the two raises."""
    check = VERIFY_CHECK if check is None else check
    if check not in CHECKS:
        raise ValueError(f"check={check!r}: expected 'bytes' or 'point'")
    return check

# --------------------------------------------------------------------------
# point helpers (limb-major)
#
# extended point: [4, 20, *batch] stack of (X, Y, Z, T)
# cached point:   [4, 20, *batch] stack of (Y+X, Y-X, 2d*T, 2Z)
# niels point:    [3, 20, *batch] stack of (y+x, y-x, 2d*x*y), Z = 1


def pt_identity(batch_shape, device) -> torch.Tensor:
    return torch.stack(
        [fe_const(v, batch_shape, device) for v in (0, 1, 1, 0)], dim=0
    )


def pt_to_cached(p):
    x, y, z, t = p[0], p[1], p[2], p[3]
    return torch.stack(
        [fe_add(y, x), fe_sub(y, x),
         fe_mul(t, fe_const(D2, device=t.device)), fe_add(z, z)],
        dim=0,
    )


def _add_tail(a, b, c, d):
    e = fe_sub(b, a)
    f = fe_sub(d, c)
    g = fe_add(d, c)
    h = fe_add(b, a)
    return torch.stack(
        [fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)], dim=0
    )


def pt_add_cached(p, q):
    """Complete unified addition, q in cached form: 8M."""
    x1, y1, z1, t1 = p[0], p[1], p[2], p[3]
    a = fe_mul(fe_sub(y1, x1), q[1])
    b = fe_mul(fe_add(y1, x1), q[0])
    c = fe_mul(t1, q[2])
    d = fe_mul(z1, q[3])
    return _add_tail(a, b, c, d)


def pt_add_mixed(p, q):
    """Complete unified addition, q in niels form (Z2 = 1): 7M."""
    x1, y1, z1, t1 = p[0], p[1], p[2], p[3]
    a = fe_mul(fe_sub(y1, x1), q[1])
    b = fe_mul(fe_add(y1, x1), q[0])
    c = fe_mul(t1, q[2])
    return _add_tail(a, b, c, fe_add(z1, z1))


def pt_double(p, need_t: bool = True):
    """dbl-2008-hwcd (a=-1): 4S + 4M, or 4S + 3M with ``need_t=False``
    (the T slot of such a result is a placeholder that is never read)."""
    x1, y1, z1 = p[0], p[1], p[2]
    a = fe_square(x1)
    b = fe_square(y1)
    zz = fe_square(z1)
    sq = fe_square(fe_add(x1, y1))
    c = fe_add(zz, zz)
    e = fe_sub(fe_sub(sq, a), b)
    g = fe_sub(b, a)
    f = fe_sub(g, c)
    h = fe_sub(fe_neg(a), b)
    z3 = fe_mul(f, g)
    t3 = fe_mul(e, h) if need_t else z3
    return torch.stack([fe_mul(e, f), fe_mul(g, h), z3, t3], dim=0)


def pt_neg(p):
    return torch.stack([fe_neg(p[0]), p[1], p[2], fe_neg(p[3])], dim=0)


def pt_encode_words(p):
    """-> [8, *batch] int64 holding the u32 LE words of the canonical
    compressed encoding."""
    zi = fe_invert(p[2])
    x = fe_reduce_full(fe_mul(p[0], zi))
    y = fe_reduce_full(fe_mul(p[1], zi))
    words = limbs_to_words_le(y)
    sign = (x[0] & 1).to(torch.int64)
    return torch.cat([words[:7], (words[7] | (sign << 31))[None]], dim=0)


def pt_decompress(words):
    """[8, *batch] LE u32 words -> (point [4, 20, *batch], valid [*batch])."""
    dev = words.device
    y = limbs_from_words_le(words, mask_high=True)
    sign = ((words.to(torch.int64) >> 31) & 1)[7]
    one = fe_const(1, device=dev)
    y2 = fe_square(y)
    u = fe_sub(y2, one)
    v = fe_add(fe_mul(y2, fe_const(D, device=dev)), one)
    v3 = fe_mul(fe_square(v), v)
    v7 = fe_mul(fe_square(v3), v)
    x = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)))
    vxx = fe_mul(fe_square(x), v)
    ok1 = fe_eq(vxx, u)
    ok2 = fe_eq(vxx, fe_neg(u))
    x = fe_select(ok1, x, fe_mul(x, fe_const(SQRT_M1, device=dev)))
    valid = ok1 | ok2
    valid = valid & ~(fe_is_zero(x) & (sign == 1))
    flip = fe_is_odd(x) != (sign == 1)
    x = fe_select(flip, fe_neg(x), x)
    z = fe_const(1, tuple(x.shape[1:]), dev)
    return torch.stack([x, y, z, fe_mul(x, y)], dim=0), valid


def _build_cached_table(p):
    """p extended [4, 20, *batch] -> [9, 4, 20, *batch] cached multiples
    0..8P (4 doublings + 3 cached adds + 8 cached conversions)."""
    batch = tuple(p.shape[2:])
    ident = torch.stack(
        [fe_const(v, batch, p.device) for v in (1, 1, 0, 2)], dim=0
    )
    c1 = pt_to_cached(p)
    m2 = pt_double(p)
    c2 = pt_to_cached(m2)
    m3 = pt_add_cached(m2, c1)
    c3 = pt_to_cached(m3)
    m4 = pt_double(m2)
    c4 = pt_to_cached(m4)
    m5 = pt_add_cached(m4, c1)
    m6 = pt_double(m3)
    m7 = pt_add_cached(m6, c1)
    m8 = pt_double(m4)
    cached = [ident, c1, c2, c3, c4] + [pt_to_cached(m) for m in (m5, m6, m7, m8)]
    return torch.stack(cached, dim=0)


def _select_cached(tbl, digit):
    """tbl [9, 4, 20, B], digit [B] in [-8, 7] -> cached entry
    [4, 20, B]; a negative digit swaps (Y+X)/(Y-X) and negates 2dT."""
    mag = digit.abs().to(torch.int64)
    neg = digit < 0
    idx = mag.reshape(1, 1, 1, -1).expand(1, 4, NLIMB, mag.shape[0])
    entry = torch.gather(tbl, 0, idx)[0]
    ypx, ymx, t2d, z2 = entry[0], entry[1], entry[2], entry[3]
    return torch.stack(
        [fe_select(neg, ymx, ypx), fe_select(neg, ypx, ymx),
         fe_select(neg, fe_neg(t2d), t2d), z2],
        dim=0,
    )


# --------------------------------------------------------------------------
# fixed-base comb table for B (host-side, Python ints, computed once)

_COMB_NP: np.ndarray | None = None


def _comb_table_np() -> np.ndarray:
    """[NWINDOWS, 60, 16] f32: column (j, :, w) = niels form
    (y+x, y-x, 2dxy) of (w * 16^j) * B, limb-major — the JAX package's
    table, value for value (f32 is exact for 13-bit limbs)."""
    global _COMB_NP
    if _COMB_NP is None:
        out = np.zeros((NWINDOWS, 16, 3, NLIMB), np.int32)
        step = ref.BASE  # 16^j * B
        for j in range(NWINDOWS):
            acc = ref.IDENTITY
            for w in range(16):
                x, y, z, _t = acc
                zi = pow(z, P - 2, P)
                xa, ya = x * zi % P, y * zi % P
                out[j, w, 0] = int_to_limbs_np((ya + xa) % P)
                out[j, w, 1] = int_to_limbs_np((ya - xa) % P)
                out[j, w, 2] = int_to_limbs_np(D2 * xa % P * ya % P)
                acc = ref.pt_add(acc, step)
            for _ in range(4):
                step = ref.pt_double(step)
        _COMB_NP = (
            out.reshape(NWINDOWS, 16, 3 * NLIMB)
            .transpose(0, 2, 1)
            .astype(np.float32)
            .copy()
        )
    return _COMB_NP


# --------------------------------------------------------------------------
# wire expansion (raw 32-byte scalars -> digit arrays)


def expand_s_windows(s_bytes: torch.Tensor) -> torch.Tensor:
    """[B, 32] u8 LE scalar bytes -> [B, 64] int32 unsigned 4-bit windows
    (LSB first)."""
    b = s_bytes.to(torch.int32)
    return torch.stack([b & 0xF, b >> 4], dim=-1).reshape(b.shape[0], 64)


def expand_h_digits(h_bytes: torch.Tensor) -> torch.Tensor:
    """[B, 32] u8 LE scalar bytes -> [B, 64] int32 signed digits in
    [-8, 7] (LSB first), equal to ``_signed_digits_le``. The carry ripple
    runs as a generate/propagate scan over the 64 digits. Valid for
    scalars < 2^253."""
    nib = expand_s_windows(h_bytes)
    g = nib >= 8
    p = nib == 7
    # Hillis-Steele inclusive scan of the (generate, propagate) pairs:
    # combining an earlier prefix (ga, pa) with a later one (gb, pb)
    # gives (gb | pb & ga, pb & pa); (0, 1) is the identity
    shift = 1
    while shift < 64:
        g_prev = torch.cat([torch.zeros_like(g[:, :shift]), g[:, :-shift]], dim=1)
        p_prev = torch.cat([torch.ones_like(p[:, :shift]), p[:, :-shift]], dim=1)
        g = g | (p & g_prev)
        p = p & p_prev
        shift *= 2
    carry_in = torch.cat([torch.zeros_like(g[:, :1]), g[:, :-1]], dim=1)
    v = nib + carry_in.to(torch.int32)
    return v - ((v >= 8).to(torch.int32) << 4)


def _nibbles_le(b: np.ndarray) -> np.ndarray:
    """[B, 32] uint8 LE scalar bytes -> [B, 64] int8 4-bit windows, LSB
    window first."""
    lo = b & 0xF
    hi = b >> 4
    return np.stack([lo, hi], axis=-1).reshape(b.shape[0], 64).astype(np.int8)


def _signed_digits_le(b: np.ndarray) -> np.ndarray:
    """[B, 32] uint8 LE scalar bytes -> [B, 64] int8 signed 4-bit digits
    in [-8, 7], LSB first. Valid for scalars < 2^253."""
    nib = _nibbles_le(b)
    out = np.empty_like(nib)
    carry = np.zeros(nib.shape[0], np.int32)
    for i in range(64):
        v = nib[:, i] + carry
        ge = v >= 8
        out[:, i] = v - (ge << 4)
        carry = ge.astype(np.int32)
    return out


# --------------------------------------------------------------------------
# the plain batched verify


def verify_kernel_ref(a_words, r_words, s_bytes, h_bytes, s_canonical, check=None):
    """Plain PyTorch batched verify, on whichever device the inputs lie.

    a_words, r_words: [B, 8] uint32 LE words; s_bytes, h_bytes: [B, 32]
    uint8 LE scalars (h < l); s_canonical: [B] bool. -> [B] bool.
    ``check``: the final check, "bytes" or "point" (``VERIFY_CHECK``
    when None).
    """
    check = check_mode(check)
    dev = a_words.device
    b = a_words.shape[0]
    aw = a_words.view(torch.int32).t()  # [8, B]
    rw = r_words.view(torch.int32).t()
    sw = expand_s_windows(s_bytes).t()  # [64, B]
    hd = expand_h_digits(h_bytes).t()

    a_point, valid = pt_decompress(aw)
    htbl = _build_cached_table(pt_neg(a_point))  # [9, 4, 20, B]
    comb = torch.from_numpy(_comb_table_np()).to(dev, torch.int32)  # [64, 60, 16]

    acc_h = pt_identity((b,), dev)
    acc_s = pt_identity((b,), dev)
    for j in range(NWINDOWS):
        # [h](-A): MSB-first windows, 4 doublings + 1 cached add
        for i in range(WINDOW):
            acc_h = pt_double(acc_h, need_t=(i == WINDOW - 1))
        acc_h = pt_add_cached(acc_h, _select_cached(htbl, hd[NWINDOWS - 1 - j]))
        # [S]B: comb window j, mixed add of the selected niels entry
        entry = comb[j][:, sw[j].to(torch.int64)]  # [60, B]
        acc_s = pt_add_mixed(acc_s, entry.reshape(3, NLIMB, b))
    rp = pt_add_cached(acc_s, pt_to_cached(acc_h))
    return final_check(rp, rw, valid, s_canonical, check)


def final_check(rp, rw, valid, s_canonical, check: str = "bytes"):
    """The JAX package's final check of P3 = [S]B + [h](-A) against R
    (rw: [8, B] words). ``bytes``: encode P3 and byte-compare it with R
    (ref10 crypto_sign_open), so a non-canonical R never matches.
    ``point``: R decoded as A is (x = 0 with the sign bit rejected, x's
    parity set by it), then X3 == Xr*Z3 and Y3 == Yr*Z3, and y_r (sign
    bit masked) < p, where the byte compare rejected a non-canonical R."""
    if check == "point":
        r_point, r_valid = pt_decompress(rw)
        r_canon = limbs_lt_p(limbs_from_words_le(rw))
        ex = fe_eq(rp[0], fe_mul(r_point[0], rp[2]))
        ey = fe_eq(rp[1], fe_mul(r_point[1], rp[2]))
        return ex & ey & r_valid & r_canon & valid & s_canonical
    eq = torch.all(pt_encode_words(rp) == (rw.to(torch.int64) & 0xFFFFFFFF), dim=0)
    return eq & valid & s_canonical


# --------------------------------------------------------------------------
# host-side preparation

_L_BYTES = np.frombuffer(L.to_bytes(32, "little"), np.uint8)


def _native_prep():
    """The native h prep (``native.Ed25519HostPrep``: native/src/
    ed25519_host.cc, threaded, the GIL released), or None where the
    host library does not build; then ``_h_scalars`` computes the same
    bytes."""
    from ..native import Ed25519HostPrep, load_host

    return Ed25519HostPrep() if load_host() is not None else None


def _h_scalars(r_packed: bytes, publics, messages) -> np.ndarray:
    """h = SHA512(R || A || M) mod l for every signature -> [B, 32] u8:
    the Python mirror of ``_native_prep``.

    One Python pass, joined once. Not threaded: hashlib holds the GIL
    for messages this short (96 bytes), and so does the int mod l, so
    threads would only take turns."""
    sha, from_le = hashlib.sha512, int.from_bytes
    scalars = [
        (from_le(sha(r_packed[32 * i : 32 * i + 32] + pk + msg).digest(), "little") % L)
        .to_bytes(32, "little")
        for i, (pk, msg) in enumerate(zip(publics, messages))
    ]
    return np.frombuffer(b"".join(scalars), np.uint8).reshape(len(scalars), 32).copy()


def prepare_batch(publics, messages, signatures) -> dict:
    """Host prep -> dict of numpy arrays on the raw wire:
    a_words/r_words [B, 8] u32, s_bytes/h_bytes [B, 32] u8,
    s_canonical [B] bool: S < l and the key's y < p
    (``ed25519_ref.key_is_canonical``), the lanes K1 may accept.
    Malformed entries (key not 32 bytes, signature not 64) become zero
    rows with s_canonical False."""
    B = len(publics)
    bad = []
    if set(map(len, publics)) != {32} or set(map(len, signatures)) != {64}:
        bad = [
            i
            for i, (pk, sig) in enumerate(zip(publics, signatures))
            if len(pk) != 32 or len(sig) != 64
        ]
    if bad:
        publics = list(publics)
        signatures = list(signatures)
        for i in bad:
            publics[i] = b"\x00" * 32
            signatures[i] = b"\x00" * 64
    pk_packed = b"".join(publics)
    sig_arr = np.frombuffer(b"".join(signatures), np.uint8).reshape(B, 64)
    a_words = np.frombuffer(pk_packed, np.uint8).reshape(B, 32)
    a_words = np.ascontiguousarray(a_words).view("<u4").astype(np.uint32)
    r_bytes = np.ascontiguousarray(sig_arr[:, :32])
    s_bytes = np.ascontiguousarray(sig_arr[:, 32:])
    r_words = r_bytes.view("<u4").astype(np.uint32)

    # canonical S < l: lexicographic compare from the most significant byte
    rev_diff = (s_bytes != _L_BYTES)[:, ::-1]
    any_diff = rev_diff.any(axis=1)
    msb = 31 - np.argmax(rev_diff, axis=1)
    s_canonical = any_diff & (s_bytes[np.arange(B), msb] < _L_BYTES[msb])
    # canonical key y < p: with the sign bit masked, y >= p only where
    # byte 31 is 0x7f, bytes 1-30 are 0xff and byte 0 is at least 0xed
    a_bytes = np.frombuffer(pk_packed, np.uint8).reshape(B, 32)
    s_canonical &= ~(((a_bytes[:, 31] & 0x7F) == 0x7F)
                     & (a_bytes[:, 1:31] == 0xFF).all(axis=1)
                     & (a_bytes[:, 0] >= 0xED))
    if bad:
        s_canonical[bad] = False

    native = _native_prep()
    if native is not None:
        h_bytes = native.h_batch(r_bytes.tobytes(), pk_packed, messages, B)
    else:
        h_bytes = _h_scalars(r_bytes.tobytes(), publics, messages)
    return dict(
        a_words=a_words,
        r_words=r_words,
        s_bytes=s_bytes,
        h_bytes=h_bytes,
        s_canonical=s_canonical,
    )


def to_tensors(batch: dict, device) -> dict:
    """prepare_batch's numpy arrays -> tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
