"""The crypto-plane backend seam: pluggable batched verifier/hasher.

The factory-registry pattern the reference uses for NodeStore backends
(src/ripple_core/nodestore/api/Factory.h:27-44), applied to the crypto
hot path: a backend name selects which implementation coalesced
verification batches and the ledger seal run on.

- ``cpu``: per-signature verification with the pure-Python RFC 8032
  oracle (``ops.ed25519_ref``), and hashlib SHA-512-half.
- ``cuda``: the hand-written CUDA kernels — K1 batch verify
  (``ops.ed25519_cuda``), K2/K3 masked and inner-level SHA-512
  (``ops.treehash``) — with the digests of a whole tree seal resident
  on the card.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device


def parse_width(mesh) -> int:
    """The ``mesh=`` device-width axis. Only width 1 (one card) is
    supported by this package; ``None``, ``""``, ``"off"``, ``0`` and
    ``1`` all mean one card, anything else raises rather than silently
    running narrower than asked."""
    s = "" if mesh is None else str(mesh).strip().lower()
    if s in ("", "off", "0", "1"):
        return 1
    raise ValueError(f"mesh={mesh!r}: only one device is supported (width 1)")


@dataclass(frozen=True)
class VerifyRequest:
    public: bytes  # 32-byte Ed25519 public key
    signing_hash: bytes  # 32-byte message (prefixed SHA-512-half)
    signature: bytes  # 64-byte detached signature


class BatchVerifier:
    """Interface: verify a batch of Ed25519 signatures."""

    name = "abstract"

    def verify_batch(self, batch: Sequence[VerifyRequest]) -> np.ndarray:
        raise NotImplementedError


class BatchHasher:
    """Interface: batched SHA-512-half with 4-byte domain prefixes.

    Hashers are callable (the SHAMap hash_batch seam); implementations
    may additionally expose ``hash_tree(root)`` for whole-tree device
    pipelines (state.shamap.compute_hashes detects it)."""

    name = "abstract"

    # routing counters: a hasher that silently ran on the host cannot
    # look device-accelerated
    device_nodes = 0
    host_nodes = 0

    def prefix_hash_batch(self, prefixes: Sequence[int], payloads: Sequence[bytes]) -> list[bytes]:
        raise NotImplementedError

    def hash_packed(self, buf: bytes, offsets: Sequence[int]) -> list[bytes]:
        """Hash PACKED messages (state.shamap.encode_nodes layout: every
        message carries its 4-byte domain prefix, `offsets` is the n+1
        boundary list)."""
        prefixes, payloads = [], []
        for i in range(len(offsets) - 1):
            msg = buf[offsets[i] : offsets[i + 1]]
            prefixes.append(int.from_bytes(msg[:4], "big"))
            payloads.append(msg[4:])
        return self.prefix_hash_batch(prefixes, payloads)

    def __call__(self, prefixes, payloads):
        return self.prefix_hash_batch(prefixes, payloads)


# name -> (factory, accepted option names). Declared options make the
# factories fail loudly on unknown keys: a typo'd option must raise when
# the plane is built, never silently no-op.
_VERIFIERS: dict[str, tuple[Callable[..., BatchVerifier], frozenset]] = {}
_HASHERS: dict[str, tuple[Callable[..., BatchHasher], frozenset]] = {}


def _check_options(kind: str, name: str, accepted: frozenset, kwargs: dict) -> None:
    unknown = sorted(set(kwargs) - accepted)
    if unknown:
        raise ValueError(
            f"{kind} backend {name!r} does not accept option(s) "
            f"{unknown}; accepted: {sorted(accepted) or '(none)'}"
        )


def register_verifier(name: str, factory: Callable[..., BatchVerifier],
                      options: Iterable[str] = ()) -> None:
    _VERIFIERS[name] = (factory, frozenset(options))


def register_hasher(name: str, factory: Callable[..., BatchHasher],
                    options: Iterable[str] = ()) -> None:
    _HASHERS[name] = (factory, frozenset(options))


def make_verifier(name: str, **kwargs) -> BatchVerifier:
    if name not in _VERIFIERS:
        raise KeyError(f"unknown signature backend {name!r}; have {sorted(_VERIFIERS)}")
    factory, accepted = _VERIFIERS[name]
    _check_options("signature", name, accepted, kwargs)
    return factory(**kwargs)


def make_hasher(name: str, **kwargs) -> BatchHasher:
    if name not in _HASHERS:
        raise KeyError(f"unknown hash backend {name!r}; have {sorted(_HASHERS)}")
    factory, accepted = _HASHERS[name]
    _check_options("hash", name, accepted, kwargs)
    return factory(**kwargs)


# --------------------------------------------------------------------------
# cpu backend


class CpuVerifier(BatchVerifier):
    """Per-signature host verification with the RFC 8032 oracle and the
    reference's checks (StellarPublicKey::verifySignature): 32-byte key
    and signing hash, 64-byte signature, canonical S."""

    name = "cpu"
    impl = "ed25519_ref"

    def verify_batch(self, batch: Sequence[VerifyRequest]) -> np.ndarray:
        from ..ops.ed25519_ref import verify

        return np.array(
            [len(r.signing_hash) == 32
             and verify(r.public, r.signing_hash, r.signature) for r in batch],
            bool,
        )


class CpuHasher(BatchHasher):
    name = "cpu"

    def prefix_hash_batch(self, prefixes, payloads):
        from ..utils.hashes import prefix_hash

        self.host_nodes += len(prefixes)
        return [prefix_hash(p, d) for p, d in zip(prefixes, payloads)]

    def hash_packed(self, buf, offsets):
        # a packed message == prefix ‖ payload: hash slices directly
        from ..utils.hashes import sha512_half

        mv = memoryview(buf)
        n = len(offsets) - 1
        self.host_nodes += n
        return [sha512_half(mv[offsets[i] : offsets[i + 1]]) for i in range(n)]


# --------------------------------------------------------------------------
# cuda backend


class TransferMeter:
    """Host<->device transfer counter: every device plane counts its
    host->device shipments and device->host readbacks, so residency
    cannot silently regress — a seal that round-trips per level shows a
    readback count proportional to tree depth instead of one per tree.
    ``uploads`` counts shipment SETS (one per launched step, however
    many arrays ride it); ``readbacks`` counts host-blocking
    device->host transfers. Updated under a lock: several threads (the
    close's two seal threads, the seal drainer) share one hasher."""

    __slots__ = ("uploads", "readbacks", "bytes_up", "bytes_down", "_lock")

    def __init__(self):
        self.uploads = 0
        self.readbacks = 0
        self.bytes_up = 0
        self.bytes_down = 0
        self._lock = threading.Lock()

    def up(self, nbytes: int) -> None:
        with self._lock:
            self.uploads += 1
            self.bytes_up += int(nbytes)

    def down(self, nbytes: int) -> None:
        with self._lock:
            self.readbacks += 1
            self.bytes_down += int(nbytes)

    def get_json(self) -> dict:
        with self._lock:
            return {
                "uploads": self.uploads,
                "readbacks": self.readbacks,
                "bytes_up": self.bytes_up,
                "bytes_down": self.bytes_down,
                "transfers": self.uploads + self.readbacks,
                "bytes_moved": self.bytes_up + self.bytes_down,
            }


class CudaVerifier(BatchVerifier):
    """Batched Ed25519 on the K1 kernel (ops.ed25519_cuda.verify).

    Batches are cut into chunks of at most ``max_batch`` and
    double-buffered: the host prep of chunk i+1 (SHA-512 and mod-l of h,
    packing) runs while the card verifies chunk i, since a launch
    returns before the kernel ends. K1 takes any batch size, so nothing
    is padded. On ``device="cpu"`` the same path runs K1's plain
    version (the tests use it)."""

    name = "cuda"

    def __init__(self, max_batch: int = 16384, mesh=None, device="cuda"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.width = parse_width(mesh)
        self.device = resolve_device(device)
        self.transfers = TransferMeter()

    def describe(self) -> dict:
        return {
            "device": str(self.device),
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "width": self.width,
            "kernel": "ed25519_verify" if self.device.type == "cuda" else "plain",
            "max_batch": self.max_batch,
        }

    def verify_batch(self, batch: Sequence[VerifyRequest]) -> np.ndarray:
        from ..ops.ed25519 import prepare_batch, to_tensors
        from ..ops.ed25519_cuda import verify

        out = np.zeros(len(batch), bool)
        pending = None  # (start, n, device verdicts) of the chunk in flight

        def drain(p):
            s0, n0, r0 = p
            got = r0.cpu().numpy()  # blocks on that chunk only
            self.transfers.down(got.nbytes)
            out[s0 : s0 + n0] = got

        for start in range(0, len(batch), self.max_batch):
            chunk = batch[start : start + self.max_batch]
            host = prepare_batch(
                [r.public for r in chunk],
                [r.signing_hash for r in chunk],
                [r.signature for r in chunk],
            )
            self.transfers.up(sum(v.nbytes for v in host.values()))
            res = verify(**to_tensors(host, self.device))
            if pending is not None:
                drain(pending)
            pending = (start, len(chunk), res)
        if pending is not None:
            drain(pending)
        return out


def _digests(rows: np.ndarray) -> bytes:
    """[n, 8] u32 digest words -> n * 32 raw bytes."""
    return np.ascontiguousarray(rows).astype(">u4").tobytes()


class CudaHasher(BatchHasher):
    """SHA-512-half on the K2/K3 kernels.

    - ``prefix_hash_batch`` / ``hash_packed``: flat batches bucketed to
      the leaf block-count ladder, one K2 launch per bucket;
    - ``hash_tree``: a whole dirty SHAMap sealed level by level with
      every digest resident in one device buffer — leaf levels through
      K2, inner levels through K3 reading their children by row — and
      ONE readback per tree (``tree_transfers.readbacks == tree_calls``).

    One hasher serves several threads at once: the close hashes its two
    trees on two helper threads while the seal drainer pre-hashes the
    next ledger's building tree. Every launch goes to the device's
    current (default) stream, so each tree's buffer, launches and
    readback stay in order; the counters and meters are updated under
    a lock, and each ``hash_tree`` call times its own phases.
    """

    name = "cuda"
    # whole-tree (fused) hashing on: the seal drainer takes hash_tree
    fused_enabled = True

    def __init__(self, mesh=None, device="cuda"):
        self.width = parse_width(mesh)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self.tree_calls = 0
        self.host_nodes = 0
        self.device_nodes = 0
        # host wall ms of the last finished hash_tree's phases: plan
        # (walk, encode, bucket), stage (pad, upload, launch), readback
        # (waits for the device chain), write_back (digests onto the nodes)
        self.last_tree_ms: dict[str, float] = {}
        self.transfers = TransferMeter()
        # the residency pin is crisp only for the whole-tree path: one
        # blocking readback per tree, never one per level
        self.tree_transfers = TransferMeter()

    def _count_nodes(self, host: int, device: int) -> None:
        with self._lock:
            self.host_nodes += host
            self.device_nodes += device

    def transfer_json(self) -> dict:
        """Both meters summed (the flat batches' and the whole-tree
        path's): a close's deltas of this block are its residency proof."""
        agg = self.transfers.get_json()
        for k, v in self.tree_transfers.get_json().items():
            agg[k] += v
        return agg

    def prefix_hash_batch(self, prefixes, payloads):
        return self._hash_msgs(
            [p.to_bytes(4, "big") + d for p, d in zip(prefixes, payloads)]
        )

    def hash_packed(self, buf, offsets):
        return self._hash_msgs(
            [buf[offsets[i] : offsets[i + 1]] for i in range(len(offsets) - 1)]
        )

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _hash_msgs(self, msgs):
        from ..ops.treehash import ladder_buckets, pad_leaf_batch, sha512_blocks_masked
        from ..utils.hashes import sha512_half

        out: list[Optional[bytes]] = [None] * len(msgs)
        oversized, buckets = ladder_buckets([len(m) for m in msgs])
        for i in oversized:  # host path (rare)
            out[i] = sha512_half(msgs[i])
        self._count_nodes(len(oversized), len(msgs) - len(oversized))
        results = []  # launched first, read back after
        for ladder, idxs in buckets:
            blocks, nblocks = pad_leaf_batch([msgs[i] for i in idxs], ladder)
            self.transfers.up(blocks.nbytes + nblocks.nbytes)
            st = sha512_blocks_masked(self._upload(blocks), self._upload(nblocks))
            results.append((idxs, st))
        for idxs, st in results:
            arr = st.cpu().numpy()  # [M, 16] u32
            self.transfers.down(arr.nbytes)
            raw = _digests(arr[:, :8])
            for row, i in enumerate(idxs):
                out[i] = raw[row * 32 : row * 32 + 32]
        return out  # type: ignore[return-value]

    # -- whole-tree pipeline ----------------------------------------------

    def hash_tree(self, root) -> int:
        """Fill every missing node hash of a SHAMap with device-resident
        level-synchronous hashing. Returns the number of nodes hashed.

        The host work is per level, not per child: a child of a depth-d
        node sits at depth d + 1, so an inner level's child-row table is
        one sorted lookup of its children's ids among the rows of the
        level below; only children with a known hash (sealed siblings,
        oversized leaves) are written into its template, and the
        digests go back onto the nodes in one pass in row order."""
        from ..ops.treehash import (
            build_inner_template,
            ladder_buckets,
            pad_packed,
            tree_inner_level,
            tree_leaf_body,
        )
        from ..state.shamap import ZERO256, Inner, _collect_unhashed, encode_nodes
        from ..utils.hashes import HP_INNER_NODE, sha512_half

        t_plan = time.perf_counter()
        levels = _collect_unhashed(root)
        if not levels:
            return 0

        order: list = []  # device-hashed nodes, in digest-buffer row order
        plan: list[tuple] = []
        hashed_host = 0
        empty = (None,) * 16
        below = _RowIndex()  # rows of the level below's device nodes

        for level in reversed(levels):
            leaves: list = []
            inners: list = []
            for node in level:
                if not isinstance(node, Inner):
                    leaves.append(node)
                elif node.children == empty:
                    node._hash = ZERO256
                    hashed_host += 1
                else:
                    inners.append(node)
            here = _RowIndex()
            if leaves:
                lbuf, loff = encode_nodes(leaves)
                off = np.asarray(loff, np.int64)
                lengths = off[1:] - off[:-1]
                oversized, buckets = ladder_buckets(lengths)
                for i in oversized:
                    # oversized leaf: host hash, enters as a known child
                    leaves[i]._hash = sha512_half(lbuf[off[i] : off[i + 1]])
                hashed_host += len(oversized)
                for ladder, sel in buckets:
                    start = here.add(order, [leaves[i] for i in sel.tolist()])
                    plan.append(("leaf", ladder, lbuf, off[sel], lengths[sel], start))
            if inners:
                kids = [c for node in inners for c in node.children]
                kid_ids = np.fromiter(map(id, kids), np.int64, len(kids))
                child_rows = below.rows_of(kid_ids)
                # not None and hashed below: known before this seal
                known = np.flatnonzero((child_rows < 0) & (kid_ids != id(None)))
                hashes = [kids[k]._hash for k in known.tolist()]
                if None in hashes:
                    raise RuntimeError("an unhashed child is missing from the level below")
                known_words = np.frombuffer(b"".join(hashes), ">u4").reshape(-1, 8)
                start = here.add(order, inners)
                plan.append(("inner", child_rows.reshape(-1, 16), known, known_words, start))
            below = here.sealed()

        if not plan:
            self._count_nodes(hashed_host, 0)
            return hashed_host

        # counted HERE, not at entry: tree_calls pairs 1:1 with the single
        # readback below, so host-only calls do not count
        with self._lock:
            self.tree_calls += 1
        t_stage = time.perf_counter()
        buf = torch.zeros((len(order), 8), dtype=torch.uint32, device=self.device)
        for step in plan:
            if step[0] == "leaf":
                _k, ladder, lbuf, starts, lengths, off = step
                blocks, nblocks = pad_packed(lbuf, starts, lengths, ladder)
                self.tree_transfers.up(blocks.nbytes + nblocks.nbytes)
                tree_leaf_body(buf, self._upload(blocks), self._upload(nblocks), off)
            else:
                _k, child_rows, known, known_words, off = step
                template = build_inner_template(len(child_rows), HP_INNER_NODE)
                node_i, slot = np.divmod(known, 16)
                template[node_i[:, None], 1 + 8 * slot[:, None] + np.arange(8)] = known_words
                self.tree_transfers.up(template.nbytes + child_rows.nbytes)
                tree_inner_level(
                    buf, self._upload(template), self._upload(child_rows), off
                )

        t_readback = time.perf_counter()
        host = buf.cpu().numpy()  # ONE transfer; waits for the whole chain
        t_write = time.perf_counter()
        self.tree_transfers.down(host.nbytes)
        raw = _digests(host)
        for node, k in zip(order, range(0, len(raw), 32)):
            node._hash = raw[k : k + 32]
        t_end = time.perf_counter()
        phases = {
            "plan": (t_stage - t_plan) * 1e3,
            "stage": (t_readback - t_stage) * 1e3,
            "readback": (t_write - t_readback) * 1e3,
            "write_back": (t_end - t_write) * 1e3,
        }
        with self._lock:
            self.host_nodes += hashed_host
            self.device_nodes += len(order)
            self.last_tree_ms = phases
        return hashed_host + len(order)


class _RowIndex:
    """Digest-buffer rows of one tree level's device-hashed nodes, looked
    up by node id (a sorted id array, so a level's children are found in
    one searchsorted rather than one dict lookup each)."""

    def __init__(self):
        self._ids: list[np.ndarray] = []
        self._rows: list[np.ndarray] = []
        self.ids = np.zeros(0, np.int64)
        self.rows = np.zeros(0, np.int32)

    def add(self, order: list, nodes: list) -> int:
        """Give nodes the next rows of `order`; -> the first row."""
        start = len(order)
        order.extend(nodes)
        self._ids.append(np.fromiter(map(id, nodes), np.int64, len(nodes)))
        self._rows.append(np.arange(start, len(order), dtype=np.int32))
        return start

    def sealed(self) -> "_RowIndex":
        if self._ids:
            ids = np.concatenate(self._ids)
            by_id = np.argsort(ids)
            self.ids, self.rows = ids[by_id], np.concatenate(self._rows)[by_id]
        return self

    def rows_of(self, ids: np.ndarray) -> np.ndarray:
        """Row of each id, -1 where the id has none."""
        if not len(self.ids):
            return np.full(len(ids), -1, np.int32)
        pos = np.minimum(np.searchsorted(self.ids, ids), len(self.ids) - 1)
        return np.where(self.ids[pos] == ids, self.rows[pos], -1).astype(np.int32)


register_verifier("cpu", CpuVerifier)
register_verifier("cuda", CudaVerifier, options=("max_batch", "mesh", "device"))
register_hasher("cpu", CpuHasher)
register_hasher("cuda", CudaHasher, options=("mesh", "device"))


# --------------------------------------------------------------------------
# path-quality plane: Q16.16 candidate evaluation on K4


class PathQualityEvaluator:
    """Evaluation of flattened candidate-path rate matrices, the path
    search's pre-rank (paths.plane.PathPlane.make_pre_rank).

    Two arms give the same bytes: the NumPy host arm
    (``ops.pathq.path_quality_host``) and K4 on the card
    (``ops.pathq.path_quality``). ``routing``: "device" (default) runs
    every batch on K4 on ``device``; "host" runs the host arm. The JAX
    package's measured-cost routing ("cost") and mesh widths above one
    are not ported (ROADMAP Queue A item 3 and item 2) and raise. A
    device batch never falls back to the host arm: a failed build or
    launch raises."""

    def __init__(self, mesh=None, routing: Optional[str] = None, device="cuda"):
        routing = (routing or "device").strip().lower()
        if routing == "cost":
            raise NotImplementedError(
                "path evaluator routing='cost' needs the measured-cost model "
                "(_HashCostModel), not ported yet (ROADMAP Queue A item 3); "
                "use routing='device' or 'host'"
            )
        if routing not in ("device", "host"):
            raise ValueError(
                f"path evaluator routing must be device|host, got {routing!r}"
            )
        try:
            self.width = parse_width(mesh)
        except ValueError:
            raise ValueError(
                f"mesh={mesh!r}: path evaluation across more than one card is "
                "not ported yet (ROADMAP Queue A item 2)"
            ) from None
        self.routing = routing
        self.device = resolve_device(device) if routing == "device" else None
        self._lock = threading.Lock()
        self.host_batches = 0
        self.device_batches = 0
        self.rows_evaluated = 0

    def evaluate_host(self, rates: np.ndarray) -> np.ndarray:
        from ..ops.pathq import path_quality_host

        return path_quality_host(rates)

    def _evaluate_device(self, rates: np.ndarray) -> np.ndarray:
        from ..ops.pathq import path_quality

        t = torch.from_numpy(rates).to(self.device)
        return path_quality(t).cpu().numpy()

    def evaluate(self, rates: np.ndarray) -> np.ndarray:
        """[B, H] uint32 -> [B] uint32 composites on the routed arm."""
        rates = np.ascontiguousarray(rates, dtype=np.uint32)
        n = int(rates.shape[0])
        if n == 0:
            return np.zeros((0,), dtype=np.uint32)
        if self.routing == "host":
            out = self.evaluate_host(rates)
        else:
            out = self._evaluate_device(rates)
        with self._lock:
            self.rows_evaluated += n
            if self.routing == "host":
                self.host_batches += 1
            else:
                self.device_batches += 1
        return out

    def get_json(self) -> dict:
        with self._lock:
            return {
                "mesh": self.width,
                "routing": self.routing,
                "device": None if self.device is None else str(self.device),
                "host_batches": self.host_batches,
                "device_batches": self.device_batches,
                "rows_evaluated": self.rows_evaluated,
            }


def make_path_evaluator(mesh=None, routing: Optional[str] = None,
                        device="cuda") -> PathQualityEvaluator:
    """The one wiring of the path-quality evaluator."""
    return PathQualityEvaluator(mesh=mesh, routing=routing, device=device)
