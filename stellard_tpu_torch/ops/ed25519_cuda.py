"""K1 wrapper: batched Ed25519 verify on the CUDA kernel
(``csrc/ed25519_verify.cu``), or its plain PyTorch version for tensors
on the CPU (``ops.ed25519.verify_kernel_ref``, re-exported here).

Replaces stellard_tpu/ops/ed25519_pallas.py::_kernel and its XLA twin
ed25519_jax.py::verify_kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from . import ed25519_ref as ref
from .ed25519 import verify_kernel_ref

__all__ = ["verify", "verify_kernel_ref", "launches", "launches_by_batch", "base_table_np"]

LIB = "ed25519_verify"

# launches of the CUDA kernel in this process (never counts plain runs),
# and the same launches by batch size (the RPC door's submits launch K1
# one signature at a time)
launches = 0
launches_by_batch: dict[int, int] = {}

_BASE_TABLES: dict[torch.device, torch.Tensor] = {}


def _limbs51(x: int) -> list[int]:
    return [(x >> (51 * i)) & ((1 << 51) - 1) for i in range(5)]


def base_table_np() -> np.ndarray:
    """[15, 4, 5] u64: cached form (y+x, y-x, 2d*x*y, 2) of k*B for
    k = 1..15, each coordinate as canonical radix-2^51 limbs."""
    out = np.zeros((15, 4, 5), np.uint64)
    acc = ref.IDENTITY
    for k in range(15):
        acc = ref.pt_add(acc, ref.BASE)
        x, y, z, _t = acc
        zi = pow(z, ref.P - 2, ref.P)
        xa, ya = x * zi % ref.P, y * zi % ref.P
        coords = ((ya + xa) % ref.P, (ya - xa) % ref.P,
                  2 * ref.D * xa % ref.P * ya % ref.P, 2)
        for c, v in enumerate(coords):
            out[k, c] = _limbs51(v)
    return out


def _base_table(device: torch.device) -> torch.Tensor:
    t = _BASE_TABLES.get(device)
    if t is None:
        t = torch.from_numpy(base_table_np().view(np.int64)).to(device)
        _BASE_TABLES[device] = t
    return t


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def verify(a_words, r_words, s_bytes, h_bytes, s_canonical) -> torch.Tensor:
    """a_words, r_words: [B, 8] uint32 LE words; s_bytes, h_bytes:
    [B, 32] uint8 LE scalars (h < l); s_canonical: [B] bool -> [B] bool.

    On CUDA tensors this launches K1 (any B, no padding); on CPU
    tensors it runs the plain version."""
    b = a_words.shape[0]
    _check("a_words", a_words, torch.uint32, (b, 8))
    _check("r_words", r_words, torch.uint32, (b, 8))
    _check("s_bytes", s_bytes, torch.uint8, (b, 32))
    _check("h_bytes", h_bytes, torch.uint8, (b, 32))
    _check("s_canonical", s_canonical, torch.bool, (b,))
    dev = a_words.device
    for t in (r_words, s_bytes, h_bytes, s_canonical):
        if t.device != dev:
            raise ValueError(f"inputs on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return verify_kernel_ref(a_words, r_words, s_bytes, h_bytes, s_canonical)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return out
    lib = build.load(LIB)
    fn = lib.ed25519_verify_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            a_words.data_ptr(), r_words.data_ptr(), s_bytes.data_ptr(),
            h_bytes.data_ptr(), s_canonical.data_ptr(),
            _base_table(dev).data_ptr(), out.data_ptr(), b, stream,
        )
    build.check(err, "ed25519_verify")
    global launches
    launches += 1
    launches_by_batch[b] = launches_by_batch.get(b, 0) + 1
    return out
