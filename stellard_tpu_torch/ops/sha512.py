"""Batched SHA-512 in plain PyTorch, and host-side FIPS 180-4 padding.

The plain version the CUDA SHA-512 kernels (``csrc/sha512.cu``) are held
against (reference seam: Serializer::getSHA512Half, SHAMapTreeNode::
updateHash — src/ripple_data/protocol/Serializer.cpp:342-390,
src/ripple_app/shamap/SHAMapTreeNode.cpp:253-295).

Layout as in the JAX package: a message block is [..., 32] u32 = 16
big-endian 64-bit words as (hi, lo) pairs; state is [..., 16] u32 = 8
words. Inside, each 64-bit word is one int64 (additions wrap mod 2^64;
logical right shifts are masked), so a round is a few dozen tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch

# SHA-512 round constants and initial state (FIPS 180-4)
_K = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]
_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]


def _s64(v: int) -> int:
    """u64 -> the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_K64 = [_s64(k) for k in _K]
_IV64 = [_s64(v) for v in _IV]


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of the int64's 64-bit pattern."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def words_to_u64(w: torch.Tensor) -> torch.Tensor:
    """[..., 2k] u32 (hi, lo) pairs (any 32-bit integer dtype) ->
    [..., k] int64."""
    w = w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (w[..., 0::2] << 32) | w[..., 1::2]


def u64_to_words(x: torch.Tensor) -> torch.Tensor:
    """[..., k] int64 -> [..., 2k] uint32 (hi, lo) pairs."""
    hi = (x >> 32) & 0xFFFFFFFF
    lo = x & 0xFFFFFFFF
    pairs = torch.stack([hi, lo], dim=-1).reshape(tuple(x.shape[:-1]) + (-1,))
    return pairs.to(torch.int32).view(torch.uint32)


def _compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One compression. state: [..., 8] int64; block: [..., 16] int64."""
    w = [block[..., t] for t in range(16)]
    for t in range(16, 80):
        s0 = _rotr(w[t - 15], 1) ^ _rotr(w[t - 15], 8) ^ _shr(w[t - 15], 7)
        s1 = _rotr(w[t - 2], 19) ^ _rotr(w[t - 2], 61) ^ _shr(w[t - 2], 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, b, c, d, e, f, g, h = [state[..., i] for i in range(8)]
    for t in range(80):
        s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K64[t] + w[t]
        s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
    return state + torch.stack([a, b, c, d, e, f, g, h], dim=-1)


def initial_state(batch_shape, device) -> torch.Tensor:
    iv = torch.tensor(_IV64, dtype=torch.int64, device=device)
    return iv.expand(tuple(batch_shape) + (8,)).clone()


def sha512_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """SHA-512 over pre-padded blocks: [..., nblocks, 32] u32 ->
    [..., 16] u32 digest state (64 bytes)."""
    words = words_to_u64(blocks)  # [..., nblocks, 16]
    state = initial_state(blocks.shape[:-2], blocks.device)
    for i in range(blocks.shape[-2]):
        state = _compress(state, words[..., i, :])
    return u64_to_words(state)


def padded_block_count(length: int) -> int:
    """Number of 128-byte blocks after FIPS 180-4 padding."""
    return (length + 17 + 127) // 128


def pad_message_np(data: bytes) -> np.ndarray:
    """Host-side FIPS 180-4 padding -> [nblocks, 32] uint32 array."""
    length = len(data)
    padded = data + b"\x80"
    while (len(padded) + 16) % 128:
        padded += b"\x00"
    padded += (length * 8).to_bytes(16, "big")
    return np.frombuffer(padded, dtype=">u4").astype(np.uint32).reshape(-1, 32)


def digest_to_bytes(state) -> bytes:
    """[16] u32 digest state -> 64 raw bytes."""
    return np.asarray(state).astype(">u4").tobytes()
