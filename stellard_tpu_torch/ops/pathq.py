"""Batched path-quality composition in Q16.16 fixed point: K4
``path_quality`` and its plain versions.

A candidate payment path is flattened to a fixed-width row of per-hop
rates (hop-padded with the identity rate 1.0): book hops carry the
book's best-tier quality, account hops the issuer's transfer rate
(``paths.quality.build_rate_matrix``). The composite rate of a path is
the saturating product of its hops — lower is better (fewer units in
per unit delivered). Three arms give the same bytes:

* ``path_quality_host`` — NumPy, the sequential reference arm;
* ``path_quality_ref``  — plain PyTorch, on any device;
* ``path_quality``      — the wrapper: K4 (``csrc/path_quality.cu``) on
  CUDA tensors, ``path_quality_ref`` on CPU tensors.

The NumPy and PyTorch arms build each Q16.16 product from 16-bit limbs
with explicit carry and saturation checks (int64 would overflow on a
full 64-bit product), as the JAX package's ``ops/pathq_jax.py`` does;
K4 uses one 64-bit product, which is the same function.

Layout: rates is [B, H] uint32; output is [B] uint32 composites.
Replaces stellard_tpu/ops/pathq_jax.py::path_quality_kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

__all__ = [
    "Q16_ONE",
    "Q16_MAX",
    "path_quality",
    "path_quality_host",
    "path_quality_ref",
    "launcher",
    "launches",
]

LIB = "path_quality"

Q16_ONE = 1 << 16  # 1.0 in Q16.16
Q16_MAX = (1 << 32) - 1  # saturation rail

# launches of the CUDA kernel in this process (never counts plain runs)
launches = 0

_launch = None


def launcher():
    """K4's C entry point ``path_quality_launch(rates, out, n, hops, vec4,
    stream) -> cudaError_t``, from the library built at first use, its
    argument and result types set once."""
    global _launch
    if _launch is None:
        fn = build.load(LIB).path_quality_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _qmul(xp, a, b, u32):
    """Saturating Q16.16 multiply via 16-bit limbs: the true product is
    (a*b) >> 16 over 64 bits; build it from the four 32-bit partials and
    saturate when the high word or any partial sum overflows uint32.
    `a`, `b` hold u32 values; `u32` masks a sum back to 32 bits."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    hh = a_hi * b_hi  # contributes << 16 after the global >> 16
    m1 = a_hi * b_lo
    m2 = a_lo * b_hi
    ll = (a_lo * b_lo) >> 16
    sat = hh > 0xFFFF
    r = u32((hh & 0xFFFF) << 16)
    r1 = u32(r + m1)
    sat = sat | (r1 < m1)
    r2 = u32(r1 + m2)
    sat = sat | (r2 < m2)
    r3 = u32(r2 + ll)
    sat = sat | (r3 < ll)
    return xp.where(sat, Q16_MAX, r3)


def path_quality_host(rates: np.ndarray) -> np.ndarray:
    """NumPy reference arm: [B, H] uint32 -> [B] uint32. Identity-seeded
    left fold of the limb multiply over the hop columns, in column
    order (the order is part of the byte-identity contract)."""
    rates = np.asarray(rates, dtype=np.uint32)
    acc = np.full(rates.shape[:-1], Q16_ONE, dtype=np.uint32)
    for h in range(rates.shape[-1]):
        acc = _qmul(np, acc, rates[..., h], lambda x: x).astype(np.uint32)
    return acc


def path_quality_ref(rates: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: [B, H] uint32 -> [B] uint32, in int64
    lanes masked to 32 bits and the reference's limb form."""
    mask = lambda x: x & 0xFFFFFFFF  # noqa: E731
    r = mask(rates.view(torch.int32).to(torch.int64))
    acc = torch.full(r.shape[:-1], Q16_ONE, dtype=torch.int64, device=r.device)
    for h in range(r.shape[-1]):
        acc = _qmul(torch, acc, r[..., h], mask)
    return acc.to(torch.int32).view(torch.uint32)


def path_quality(rates: torch.Tensor) -> torch.Tensor:
    """[B, H] uint32 -> [B] uint32 composites. K4 on CUDA tensors (any B,
    no padding; B = 0 gives an empty tensor), the plain version on CPU
    tensors; any other device raises."""
    if rates.dtype != torch.uint32:
        raise TypeError(f"rates: expected torch.uint32, got {rates.dtype}")
    if rates.dim() != 2:
        raise ValueError(f"rates: expected [B, H], got {tuple(rates.shape)}")
    if not rates.is_contiguous():
        raise ValueError("rates: must be contiguous")
    dev = rates.device
    if dev.type == "cpu":
        return path_quality_ref(rates)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, hops = rates.shape
    out = torch.empty(n, dtype=torch.uint32, device=dev)
    if n == 0:
        return out
    vec4 = int(hops % 4 == 0 and rates.data_ptr() % 16 == 0)
    fn = launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rates.data_ptr(), out.data_ptr(), n, hops, vec4, stream)
    build.check(err, "path_quality")
    global launches
    launches += 1
    return out
