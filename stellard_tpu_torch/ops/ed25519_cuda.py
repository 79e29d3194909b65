"""K1 wrapper: batched Ed25519 verify on the CUDA kernel
(``csrc/ed25519_verify.cu``), or its plain PyTorch version for tensors
on the CPU (``ops.ed25519.verify_kernel_ref``, re-exported here).

Replaces stellard_tpu/ops/ed25519_pallas.py::_kernel and its XLA twin
ed25519_jax.py::verify_kernel in either final-check mode (``check``,
``ops.ed25519.VERIFY_CHECK`` by default), and, with ``count``, the shard
body of stellard_tpu/parallel/mesh.py::verify_and_count: the accepted
signatures are added to a device counter in the kernel's last phase.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from . import ed25519_ref as ref
from .ed25519 import check_mode, verify_kernel_ref

__all__ = ["verify", "verify_kernel_ref", "launches", "launches_by_batch",
           "variant_launches", "reset_launches", "base_table_np"]

LIB = "ed25519_verify"

# launches of the CUDA kernel in this process (never counts plain runs),
# and the same launches by batch size (the RPC door's submits launch K1
# one signature at a time)
launches = 0
launches_by_batch: dict[int, int] = {}
# the part of those launches in point mode, and with the count epilogue
variant_launches = {"point": 0, "count": 0}


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_batch.clear()
    for k in variant_launches:
        variant_launches[k] = 0

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


def verify(a_words, r_words, s_bytes, h_bytes, s_canonical, check=None,
           count=None) -> torch.Tensor:
    """a_words, r_words: [B, 8] uint32 LE words; s_bytes, h_bytes:
    [B, 32] uint8 LE scalars (h < l); s_canonical: [B] bool -> [B] bool.
    ``check``: "bytes" or "point" (``ops.ed25519.VERIFY_CHECK`` when
    None); ``count``: a [1] int32 tensor on the same device, to which
    the number of accepted signatures is added in place.

    On CUDA tensors this launches K1 (any B, no padding); on CPU
    tensors it runs the plain version (the count: ``flags.sum()``)."""
    check = check_mode(check)
    b = a_words.shape[0]
    _check("a_words", a_words, torch.uint32, (b, 8))
    _check("r_words", r_words, torch.uint32, (b, 8))
    _check("s_bytes", s_bytes, torch.uint8, (b, 32))
    _check("h_bytes", h_bytes, torch.uint8, (b, 32))
    _check("s_canonical", s_canonical, torch.bool, (b,))
    if count is not None:
        _check("count", count, torch.int32, (1,))
    dev = a_words.device
    for t in (r_words, s_bytes, h_bytes, s_canonical) + ((count,) if count is not None else ()):
        if t.device != dev:
            raise ValueError(f"inputs on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        flags = verify_kernel_ref(a_words, r_words, s_bytes, h_bytes, s_canonical, check)
        if count is not None:
            count += flags.sum(dtype=torch.int32)
        return flags
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return out
    lib = build.load(LIB)
    fn = lib.ed25519_verify_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            a_words.data_ptr(), r_words.data_ptr(), s_bytes.data_ptr(),
            h_bytes.data_ptr(), s_canonical.data_ptr(),
            _base_table(dev).data_ptr(), out.data_ptr(), b,
            int(check == "point"), None if count is None else count.data_ptr(), stream,
        )
    build.check(err, "ed25519_verify")
    global launches
    launches += 1
    launches_by_batch[b] = launches_by_batch.get(b, 0) + 1
    if check == "point":
        variant_launches["point"] += 1
    if count is not None:
        variant_launches["count"] += 1
    return out
