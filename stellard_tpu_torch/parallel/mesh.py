"""Data-parallel sharding of the crypto plane over a list of devices.

The port of stellard_tpu/parallel/mesh.py. There the batch dimension of
the verify and hash programs shards over a 1-D ``jax.sharding.Mesh`` and
a ``psum`` adds the per-chip valid counts. Here a ``Mesh`` is an ordered
list of torch devices: the cards of one host, or, in the tests, CPU
shards. A device may appear more than once, which cuts a batch into
several shards on one card. Validator-to-validator traffic stays on the
overlay; the mesh is within one node.

Each function cuts its batch into ``width`` contiguous shards whose
sizes differ by at most one row (``Mesh.shards``; a batch need not
divide by the width), runs the shard's kernel wrapper on the shard's
device (K1, K2, K3 or K4: a CPU shard runs the plain version), and
gathers the results on the first device, device to device, with no
host readback. Width 1 is a one-device mesh of the same functions, not
another code path.

Every shard is launched from the caller's thread, one after another. A
launch returns before its kernel ends, so shards on distinct cards run
at once, and a caller under the wedge watchdog (``utils.devicewatch``:
the verifier, the hasher and the path evaluator are each called on its
one watched thread) holds every shard to that one deadline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from ..utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices; the first holds gathered results."""

    devices: tuple

    @property
    def width(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def shards(self, n: int) -> list[tuple[torch.device, int, int]]:
        """(device, lo, hi) of each shard of an n-row batch: contiguous,
        the first ``n % width`` shards one row longer (the cut of
        ``torch.tensor_split``)."""
        q, r = divmod(n, self.width)
        out, lo = [], 0
        for i, dev in enumerate(self.devices):
            hi = lo + q + (1 if i < r else 0)
            out.append((dev, lo, hi))
            lo = hi
        return out


def visible_devices(device="cuda") -> list[torch.device]:
    """The devices a mesh is cut from: for a CUDA device every card of
    the host (``torch.cuda.device_count()``), the named one first; for
    ``"cpu"`` the one CPU (a caller that wants N CPU shards passes an
    explicit list of N CPU devices instead)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [dev] + [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                    if i != dev.index]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (torch devices or their names, repeats
    allowed), or over every visible card when None."""
    devs = tuple(resolve_device(d) for d in (visible_devices() if devices is None
                                              else devices))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)


def _map(mesh: Mesh, fn: Callable, arrays: Sequence[torch.Tensor]) -> list:
    """fn(device, *shards) for each non-empty shard of ``arrays`` (batch
    on dim 0), in shard order; one call on the first device when the
    batch is empty."""
    n = arrays[0].shape[0]
    parts = [(d, lo, hi) for d, lo, hi in mesh.shards(n) if hi > lo] or [(mesh.first, 0, 0)]
    return [fn(d, *(a[lo:hi].to(d) for a in arrays)) for d, lo, hi in parts]


def _gather(mesh: Mesh, outs: list) -> torch.Tensor:
    if len(outs) == 1:
        return outs[0].to(mesh.first)
    return torch.cat([o.to(mesh.first) for o in outs])


def sharded_verify_kernel(mesh: Mesh, check: Optional[str] = None):
    """K1 with the batch sharded over the mesh: fn(a_words, r_words,
    s_bytes, h_bytes, s_canonical) -> [B] bool flags on the first
    device. ``check``: the final check (``ops.ed25519.VERIFY_CHECK``
    when None)."""
    from ..ops.ed25519_cuda import verify

    def fn(a_words, r_words, s_bytes, h_bytes, s_canonical):
        return _gather(mesh, _map(
            mesh, lambda _d, *shard: verify(*shard, check=check),
            (a_words, r_words, s_bytes, h_bytes, s_canonical)))

    return fn


# the JAX package's shard_map of its Pallas kernel: K1 serves both
sharded_verify_kernel_pallas = sharded_verify_kernel


def verify_and_count(mesh: Mesh, check: Optional[str] = None):
    """Each device verifies its shard on K1, whose last phase adds the
    shard's accepted signatures to a counter on that device; the
    counters are summed on the first device (the JAX ``psum``):
    fn(...) -> (flags [B] bool, total 0-dim int32), both on the first
    device, nothing read back to the host. The consensus-path shape:
    "did every validation of this quorum batch verify" stays a device
    result."""
    from ..ops.ed25519_cuda import verify

    def local(dev, *shard):
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        return verify(*shard, check=check, count=count), count

    def fn(a_words, r_words, s_bytes, h_bytes, s_canonical):
        outs = _map(mesh, local, (a_words, r_words, s_bytes, h_bytes, s_canonical))
        total = torch.zeros(1, dtype=torch.int32, device=mesh.first)
        for _flags, count in outs:
            total += count.to(mesh.first)
        return _gather(mesh, [f for f, _c in outs]), total.reshape(())

    return fn


def sharded_masked_sha512(mesh: Mesh):
    """K2 with the rows sharded over the mesh: fn(blocks [B, NB, 32] u32,
    nblocks [B] i32) -> [B, 16] u32 states on the first device (the tree
    hasher's flat batches)."""
    from ..ops.treehash import sha512_blocks_masked

    def fn(blocks, nblocks):
        return _gather(mesh, _map(mesh, lambda _d, b, nb: sha512_blocks_masked(b, nb),
                                  (blocks, nblocks)))

    return fn


def sharded_sha512_blocks(mesh: Mesh):
    """Unmasked SHA-512 of [B, NB, 32] u32 padded blocks -> [B, 16] u32,
    every row compressing all NB blocks: K2 with full block counts."""
    masked = sharded_masked_sha512(mesh)

    def fn(blocks):
        nblocks = torch.full((blocks.shape[0],), blocks.shape[1], dtype=torch.int32,
                             device=blocks.device)
        return masked(blocks, nblocks)

    return fn


def sharded_path_quality(mesh: Mesh):
    """K4 with the candidate rows sharded over the mesh: fn(rates [B, H]
    u32) -> [B] u32 composites on the first device."""
    from ..ops.pathq import path_quality

    def fn(rates):
        return _gather(mesh, _map(mesh, lambda _d, r: path_quality(r), (rates,)))

    return fn


def _ordered(src: torch.device, dst: torch.device) -> None:
    """Make ``dst``'s current stream wait for the work queued so far on
    ``src``'s, before a copy from ``src`` to ``dst``. (PyTorch's copy
    between two cards orders itself against both current streams; the
    wait states the order the tree chain relies on.)"""
    if src != dst and src.type == dst.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(src))
        torch.cuda.current_stream(dst).wait_event(done)


def sharded_tree_kernels(mesh: Mesh):
    """-> (leaf, inner): the seal's level-chained tree hashing with the
    rows of each level sharded over the mesh and the digest buffer kept
    on the first device, so a tree is read back once whatever the width.

    leaf(buf, blocks, nblocks, offset) and inner(buf, template,
    child_rows, offset) have the contracts of ``ops.treehash``'s
    ``tree_leaf_body`` and ``tree_inner_level``. A shard on the buffer's
    own device writes its rows in place. A shard on another card hashes
    there and its digests are copied back, device to device: a leaf
    shard ships its blocks, an inner shard the child digests its nodes
    read (gathered on the buffer's device into a small buffer of their
    own, where the JAX package replicates the whole buffer to every
    chip)."""
    from ..ops.treehash import sha512_blocks_masked, tree_inner_level, tree_leaf_body

    def leaf(buf, blocks, nblocks, offset: int) -> None:
        for dev, lo, hi in mesh.shards(blocks.shape[0]):
            if hi == lo:
                continue
            b, nb = blocks[lo:hi].to(dev), nblocks[lo:hi].to(dev)
            if dev == buf.device:
                tree_leaf_body(buf, b, nb, offset + lo)
                continue
            st = sha512_blocks_masked(b, nb)[:, :8]
            _ordered(dev, buf.device)
            buf[offset + lo : offset + hi] = st.to(buf.device)

    def inner(buf, template, child_rows, offset: int) -> None:
        for dev, lo, hi in mesh.shards(template.shape[0]):
            if hi == lo:
                continue
            rows = child_rows[lo:hi].to(buf.device)
            if dev == buf.device:
                tree_inner_level(buf, template[lo:hi].to(dev), rows, offset + lo)
                continue
            # the shard's children, 16 slots a node (-1: the template's
            # words), then its own k output rows
            k = hi - lo
            kids = buf[rows.clamp(min=0).reshape(-1).long()]
            local = torch.cat([kids.to(dev), torch.zeros(k, 8, dtype=buf.dtype, device=dev)])
            slots = torch.arange(16 * k, dtype=torch.int32, device=dev).reshape(k, 16)
            slots = torch.where(rows.to(dev) >= 0, slots, -1)
            tree_inner_level(local, template[lo:hi].to(dev), slots, 16 * k)
            _ordered(dev, buf.device)
            buf[offset + lo : offset + hi] = local[16 * k :].to(buf.device)

    return leaf, inner
