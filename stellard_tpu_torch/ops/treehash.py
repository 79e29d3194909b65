"""Device-resident SHAMap tree hashing: K2 (masked SHA-512) and K3 (one
inner tree level), with their plain PyTorch versions.

The seal keeps one device buffer of every dirty node's digest
([cap, 8] u32, SHA-512-half as 8 big-endian words). Leaf levels hash
with the masked multi-block kernel (mixed true block counts share one
launch) and bank their digests at an offset; inner levels read their
children's digests straight from the buffer by row. The host reads the
buffer once per tree (``crypto.backend.CudaHasher.hash_tree``).

Replaces stellard_tpu/ops/treehash_jax.py (sha512_blocks_masked,
tree_leaf_body) and the inner level of parallel/mesh.py::
sharded_tree_kernels. No shape is padded to a power of two: nothing here
compiles per shape.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import build
from .sha512 import _compress, initial_state, u64_to_words, words_to_u64

__all__ = [
    "LEAF_BLOCK_LADDER",
    "INNER_BLOCKS",
    "INNER_WORDS",
    "sha512_blocks_masked",
    "sha512_blocks_masked_ref",
    "tree_leaf_body",
    "tree_inner_level",
    "tree_inner_level_ref",
    "pad_leaf_batch",
    "pad_packed",
    "ladder_buckets",
    "build_inner_template",
    "launches",
    "launches_by_thread",
    "reset_launches",
]

LIB = "sha512"

INNER_BLOCKS = 5  # 4-byte prefix + 16*32 child hashes = 516B -> 5 blocks
INNER_WORDS = INNER_BLOCKS * 32  # u32 words per inner payload

# leaf padded-block-count ladder (oversized leaves hash on the host and
# enter the tree as known children)
LEAF_BLOCK_LADDER = (2, 4, 8, 16)

# launches of each CUDA kernel in this process (never counts plain runs),
# and the same launches by the name of the thread that made them: the
# close's seal threads and the seal drainer launch K2/K3 concurrently
launches = {"sha512_masked": 0, "tree_inner_level": 0}
launches_by_thread: dict[str, dict[str, int]] = {}
_COUNT_LOCK = threading.Lock()


def _count(kernel: str) -> None:
    name = threading.current_thread().name
    with _COUNT_LOCK:
        launches[kernel] += 1
        per = launches_by_thread.setdefault(name, dict.fromkeys(launches, 0))
        per[kernel] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in launches:
            launches[k] = 0
        launches_by_thread.clear()


def _check(name, t, dtype, ndim):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _same_device(dev, *ts):
    for t in ts:
        if t.device != dev:
            raise ValueError(f"inputs on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


# --------------------------------------------------------------------------
# K2: masked SHA-512


def sha512_blocks_masked_ref(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, NB, 32] u32 blocks, [B] i32 true block counts
    -> [B, 16] u32 digest state."""
    words = words_to_u64(blocks)  # [B, NB, 16]
    state = initial_state(blocks.shape[:1], blocks.device)
    for i in range(blocks.shape[1]):
        new = _compress(state, words[:, i, :])
        state = torch.where((i < nblocks)[:, None], new, state)
    return u64_to_words(state)


def _masked_launch(blocks, nblocks, out, out_stride, out_words):
    lib = build.load(LIB)
    fn = lib.sha512_masked_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = blocks.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(blocks.data_ptr(), nblocks.data_ptr(), blocks.shape[0],
                 blocks.shape[1], out, out_stride, out_words, stream)
    build.check(err, "sha512_masked")
    _count("sha512_masked")


def _check_masked(blocks, nblocks):
    _check("blocks", blocks, torch.uint32, 3)
    _check("nblocks", nblocks, torch.int32, 1)
    if blocks.shape[2] != 32 or nblocks.shape[0] != blocks.shape[0]:
        raise ValueError(
            f"blocks {tuple(blocks.shape)} / nblocks {tuple(nblocks.shape)}: "
            "expected [B, NB, 32] and [B]"
        )
    _same_device(blocks.device, nblocks)


def sha512_blocks_masked(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """SHA-512 where row b compresses only its first nblocks[b] blocks:
    [B, NB, 32] u32, [B] i32 -> [B, 16] u32. K2 on CUDA tensors, the
    plain version on CPU tensors."""
    _check_masked(blocks, nblocks)
    if blocks.device.type == "cpu":
        return sha512_blocks_masked_ref(blocks, nblocks)
    out = torch.empty((blocks.shape[0], 16), dtype=torch.uint32, device=blocks.device)
    if blocks.shape[0]:
        _masked_launch(blocks, nblocks, out.data_ptr(), 16, 16)
    return out


def tree_leaf_body(buf: torch.Tensor, blocks: torch.Tensor,
                   nblocks: torch.Tensor, offset: int) -> None:
    """Hash a batch of leaves and bank their 32-byte digests into the
    resident digest buffer rows [offset, offset + B), in place."""
    _check("buf", buf, torch.uint32, 2)
    _check_masked(blocks, nblocks)
    _same_device(buf.device, blocks, nblocks)
    m = blocks.shape[0]
    if buf.shape[1] != 8 or not 0 <= offset <= buf.shape[0] - m:
        raise ValueError(f"rows [{offset}, {offset + m}) outside buf {tuple(buf.shape)}")
    if m == 0:
        return
    if buf.device.type == "cpu":
        st = sha512_blocks_masked_ref(blocks, nblocks)
        buf[offset : offset + m] = st[:, :8]
        return
    _masked_launch(blocks, nblocks, buf[offset].data_ptr(), 8, 8)


# --------------------------------------------------------------------------
# K3: one inner level


def tree_inner_level_ref(buf, template, child_rows, offset: int) -> None:
    """Plain version of tree_inner_level (same contract, in place)."""
    n = template.shape[0]
    vals = buf.view(torch.int32)[child_rows.clamp(min=0).to(torch.int64)]  # [N, 16, 8]
    kids = template.view(torch.int32)[:, 1 : 1 + 128].reshape(n, 16, 8)
    kids = torch.where((child_rows >= 0)[:, :, None], vals, kids)
    payload = torch.cat(
        [template.view(torch.int32)[:, :1], kids.reshape(n, 128),
         template.view(torch.int32)[:, 129:]],
        dim=1,
    )
    words = words_to_u64(payload.view(torch.uint32)).reshape(n, INNER_BLOCKS, 16)
    state = initial_state((n,), buf.device)
    for i in range(INNER_BLOCKS):
        state = _compress(state, words[:, i, :])
    buf[offset : offset + n] = u64_to_words(state)[:, :8]


def tree_inner_level(buf: torch.Tensor, template: torch.Tensor,
                     child_rows: torch.Tensor, offset: int) -> None:
    """Hash N inner nodes into buf rows [offset, offset + N), in place.

    buf: [cap, 8] u32 resident digests; template: [N, INNER_WORDS] u32
    payloads with prefix, known child hashes and FIPS padding filled;
    child_rows: [N, 16] i32 — row of buf holding child c's digest, or -1
    to keep the template's words. K3 on CUDA tensors, the plain version
    on CPU tensors."""
    _check("buf", buf, torch.uint32, 2)
    _check("template", template, torch.uint32, 2)
    _check("child_rows", child_rows, torch.int32, 2)
    _same_device(buf.device, template, child_rows)
    n = template.shape[0]
    if template.shape[1] != INNER_WORDS or tuple(child_rows.shape) != (n, 16):
        raise ValueError(
            f"template {tuple(template.shape)} / child_rows "
            f"{tuple(child_rows.shape)}: expected [N, {INNER_WORDS}] and [N, 16]"
        )
    if buf.shape[1] != 8 or not 0 <= offset <= buf.shape[0] - n:
        raise ValueError(f"rows [{offset}, {offset + n}) outside buf {tuple(buf.shape)}")
    if n == 0:
        return
    if buf.device.type == "cpu":
        tree_inner_level_ref(buf, template, child_rows, offset)
        return
    lib = build.load(LIB)
    fn = lib.tree_inner_level_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = fn(buf.data_ptr(), template.data_ptr(), child_rows.data_ptr(),
                 n, offset, stream)
    build.check(err, "tree_inner_level")
    _count("tree_inner_level")


# --------------------------------------------------------------------------
# host-side padding and templates


def ladder_buckets(lengths) -> tuple[np.ndarray, list[tuple[int, np.ndarray]]]:
    """Group messages by the smallest ladder size their padded block
    count fits: (indices over the ladder, [(ladder, indices), ...])."""
    nb = (np.asarray(lengths, np.int64) + 17 + 127) // 128
    k = np.searchsorted(np.array(LEAF_BLOCK_LADDER), nb)
    buckets = [(ladder, np.nonzero(k == i)[0]) for i, ladder in enumerate(LEAF_BLOCK_LADDER)]
    return np.nonzero(k == len(LEAF_BLOCK_LADDER))[0], [b for b in buckets if len(b[1])]


def pad_packed(buf: bytes, starts: np.ndarray, lengths: np.ndarray,
               ladder_nb: int) -> tuple[np.ndarray, np.ndarray]:
    """FIPS 180-4 pad the messages buf[starts[i] : starts[i] + lengths[i]]
    into (blocks [M, ladder_nb, 32] u32, nblocks [M] i32): each message
    is followed by its length's padding tail (0x80, zeros, the 128-bit
    big-endian bit length, zero blocks up to the ladder), built once per
    distinct length, and the whole batch is one join."""
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    m = len(starts)
    width = ladder_nb * 128
    nblocks = (lengths + 17 + 127) // 128
    if m and int(nblocks.max()) > ladder_nb:
        raise ValueError("message longer than the ladder bucket")
    tails = {}
    for length in np.unique(lengths).tolist():
        end = (length + 17 + 127) // 128 * 128
        tails[length] = (b"\x80" + bytes(end - length - 17)
                         + (length * 8).to_bytes(16, "big") + bytes(width - end))
    padded = b"".join([
        part
        for s, n in zip(starts.tolist(), lengths.tolist())
        for part in (buf[s : s + n], tails[n])
    ])
    blocks = np.frombuffer(padded, ">u4").astype(np.uint32).reshape(m, ladder_nb, 32)
    return blocks, nblocks.astype(np.int32)


def pad_leaf_batch(payloads: list[bytes], ladder_nb: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (blocks [M, ladder_nb, 32] u32, nblocks [M] i32) host arrays."""
    lengths = np.array([len(p) for p in payloads], np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    return pad_packed(b"".join(payloads), starts, lengths, ladder_nb)


def build_inner_template(n_nodes: int, prefix: int) -> np.ndarray:
    """[n_nodes, INNER_WORDS] u32 with the invariant parts of every
    516-byte inner payload filled: the 4-byte prefix, the 0x80
    terminator and the big-endian bit length. Child hashes are zero
    (the empty-branch hash) until filled in."""
    t = np.zeros((n_nodes, INNER_WORDS), np.uint32)
    t[:, 0] = prefix
    t[:, 129] = 0x80000000  # byte 516 = 0x80: word 129, top byte
    t[:, 159] = 516 * 8  # 4128 bits in the last word
    return t
