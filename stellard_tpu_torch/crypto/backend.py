"""The crypto-plane backend seam: pluggable batched verifier/hasher.

The factory-registry pattern the reference uses for NodeStore backends
(src/ripple_core/nodestore/api/Factory.h:27-44), applied to the crypto
hot path: a backend name selects which implementation coalesced
verification batches and the ledger seal run on.

- host verifiers: ``native``, the whole batch in one call to the C++
  verifier (``native/src/ed25519_verify.cc``); ``openssl``, one
  ``protocol.keys.verify_signature`` a signature (the ``cryptography``
  wheel, else the native single verify), threaded; and ``cpu``, which
  resolves to ``native`` where the host library builds, else to
  ``openssl`` (``STELLARD_HOST_VERIFY`` overrides).
- host hasher: ``cpu``, hashlib SHA-512-half; ``cpp`` (the JAX
  package's C SHA-512 name) is served by it, since the C batch ran
  slower than hashlib on the card's host (PERF.md).
- ``cuda``: the hand-written CUDA kernels — K1 batch verify
  (``ops.ed25519_cuda``), K2/K3 masked and inner-level SHA-512
  (``ops.treehash``) — with the digests of a whole tree seal resident
  on the card.

``mesh=`` is the device-width axis (``parse_mesh``: 0, N or ``auto``):
a ``cuda`` backend cuts each batch into shards over that many devices
(``parallel.mesh``), the cards of the host or, in the tests, an explicit
list of CPU shards (``devices=``). Width 1 runs the same sharded code
over a one-device mesh.

A node builds its hasher with ``make_watched_hasher``: a ``cuda`` hasher
runs under the wedge watchdog (``WatchdogHasher``), with every batch on
the card by default, or, as an explicit choice, routed by the
measured-cost model (``_HashCostModel``) between the host, one card
(``dev1``) and the whole mesh (``devN``) above the floor
``min_device_nodes``. A device call that overruns its deadline raises,
and so does every later call: nothing moves to the host after a wedge.
``PathQualityEvaluator`` routes on the same model.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

log = logging.getLogger("stellard.device")


def parse_mesh(value) -> str:
    """Canonicalize a ``mesh=`` value (the device-width axis): ``"auto"``
    or the string form of a non-negative int. ``0`` means "no mesh
    requested", which runs as a width-1 mesh, the same sharded code as
    every other width. Anything else raises: a width toggle must not
    silently fail open into an unintended topology."""
    if value is None:
        return "0"
    s = str(value).strip().lower()
    if s in ("", "off"):
        return "0"
    if s == "auto":
        return "auto"
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"mesh= must be a non-negative integer or 'auto', got {value!r}"
        ) from None
    if n < 0:
        raise ValueError(
            f"mesh= must be a non-negative integer or 'auto', got {value!r}"
        )
    return str(n)


def mesh_wants_width(value) -> bool:
    """True when a ``mesh=`` value asks for more than one device (so the
    host/1-card/N-card routing grows a separate one-card arm). "auto"
    counts: its width is known only when the devices are listed."""
    m = parse_mesh(value)
    return m == "auto" or int(m) > 1


def resolve_mesh_width(mesh, n_visible: int, pow2: bool = False) -> int:
    """Effective width: ``auto`` -> every visible device, N -> min(N,
    visible) (clamped with a warning), 0 -> 1. ``pow2=True`` rounds down
    to a power of two, as the JAX package's hash plane does."""
    m = parse_mesh(mesh)
    n_visible = max(1, n_visible)
    want = n_visible if m == "auto" else max(1, int(m))
    if want > n_visible:
        log.warning(
            "mesh=%s requests %d devices but only %d are visible — "
            "clamping to %d", m, want, n_visible, n_visible,
        )
    width = max(1, min(want, n_visible))
    if pow2:
        width = 1 << (width.bit_length() - 1)
    return width


def _visible(device, devices) -> list[torch.device]:
    """The devices a backend's mesh is cut from: ``devices`` (an explicit
    list, repeats allowed: N CPU shards in the tests), else every card of
    the host with ``device`` first, or the one CPU."""
    from ..parallel.mesh import visible_devices

    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if not out:
            raise ValueError("devices= must name at least one device")
        return out
    return visible_devices(device)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


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
    """Host-library per-signature verification (the libsodium role of the
    reference: StellarPublicKey::verifySignature), threaded over the
    batch: ``protocol.keys.verify_signature`` for each, which counts it
    in ``keys.host_verifies``."""

    name = "cpu"
    impl = "openssl"

    _shared_pool: ThreadPoolExecutor | None = None

    def __init__(self, threads: int = 4):
        if threads > 1:
            if CpuVerifier._shared_pool is None:
                CpuVerifier._shared_pool = ThreadPoolExecutor(
                    max_workers=threads, thread_name_prefix="cpu-verify"
                )
            self._pool = CpuVerifier._shared_pool
        else:
            self._pool = None

    def verify_batch(self, batch: Sequence[VerifyRequest]) -> np.ndarray:
        from ..protocol.keys import verify_signature

        def one(req: VerifyRequest) -> bool:
            return verify_signature(req.public, req.signing_hash, req.signature)

        if self._pool is None or len(batch) < 64:
            return np.array([one(r) for r in batch], bool)
        return np.array(list(self._pool.map(one, batch)), bool)


class NativeVerifier(BatchVerifier):
    """Batched C++ verification (native/src/ed25519_verify.cc): the whole
    batch crosses into native code in one call, the GIL released. The
    host side of the verify plane where the library builds. It bypasses
    ``verify_signature``, so it counts its batch in
    ``keys.host_verifies`` itself."""

    name = "cpu"  # fills the host role; .impl says which implementation
    impl = "native"

    def __init__(self, **_):
        from ..native import Ed25519NativeVerify

        self._impl = Ed25519NativeVerify()

    def verify_batch(self, batch: Sequence[VerifyRequest]) -> np.ndarray:
        from ..protocol import keys

        keys.host_verifies += len(batch)
        return self._impl.verify_batch(
            [r.public for r in batch],
            [r.signing_hash for r in batch],
            [r.signature for r in batch],
        )


def _host_verifier_factory(**kwargs) -> BatchVerifier:
    """The ``cpu`` backend: native C++ batch verify where the host
    library builds, else the per-signature host-library path.
    ``STELLARD_HOST_VERIFY`` overrides: ``python`` / ``openssl`` force
    the host-library path, ``native`` requires the C++ kernel (raises
    if it does not build), ``auto`` (default) prefers native. Any other
    value raises: a switch must not silently do nothing."""
    import os

    choice = os.environ.get("STELLARD_HOST_VERIFY", "auto").lower()
    if choice in ("python", "openssl"):
        return CpuVerifier(**kwargs)
    if choice == "native":
        return NativeVerifier()
    if choice not in ("auto", ""):
        raise ValueError(
            f"STELLARD_HOST_VERIFY={choice!r}: expected auto|native|"
            "python|openssl"
        )
    try:
        return NativeVerifier()
    except Exception:  # noqa: BLE001 — no compiler: the host library
        return CpuVerifier(**kwargs)


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
    """Batched Ed25519 on the K1 kernel (ops.ed25519_cuda.verify), the
    batch sharded over a mesh of ``mesh=`` devices
    (``parallel.mesh.sharded_verify_kernel``).

    Batches are cut into chunks of at most ``max_batch`` and
    double-buffered: the host prep of chunk i+1 (SHA-512 and mod-l of h,
    packing) runs while the card verifies chunk i, since a launch
    returns before the kernel ends. K1 takes any batch size and the mesh
    cuts a chunk into shards that differ by at most one row, so nothing
    is padded. On ``device="cpu"`` the same path runs K1's plain version
    (the tests use it, with ``devices=`` for N CPU shards)."""

    name = "cuda"

    def __init__(self, max_batch: int = 16384, mesh="auto", device="cuda", devices=None):
        from ..parallel.mesh import make_mesh, sharded_verify_kernel

        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.mesh = parse_mesh(mesh)
        visible = _visible(device, devices)
        self.devices_visible = len(visible)
        self.n_devices = resolve_mesh_width(self.mesh, len(visible))
        self.device = visible[0]
        self._kernel = sharded_verify_kernel(make_mesh(visible[: self.n_devices]))
        self.kernel_selected = (
            f"{'ed25519_verify' if self.device.type == 'cuda' else 'plain'}"
            f"@{self.n_devices}"
        )
        self.max_batch = max_batch
        self.transfers = TransferMeter()

    def describe(self) -> dict:
        """Which devices, width and kernel this verifier resolved to (the
        get_counts crypto block)."""
        return {
            "mesh_requested": self.mesh,
            "mesh_width": self.n_devices,
            "devices_visible": self.devices_visible,
            "platform": self.device.type,
            "kernel": self.kernel_selected,
            "max_batch": self.max_batch,
            "device": str(self.device),
            "device_name": _device_name(self.device),
        }

    def verify_batch(self, batch: Sequence[VerifyRequest]) -> np.ndarray:
        from ..ops.ed25519 import prepare_batch, to_tensors

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
            res = self._kernel(**to_tensors(host, self.device))
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

    Both paths shard their rows over a mesh of ``mesh=`` devices
    (rounded down to a power of two, as the JAX hasher's width is),
    ``parallel.mesh``'s ``sharded_masked_sha512`` and
    ``sharded_tree_kernels``, the digest buffer on the first device.

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

    def __init__(self, mesh="auto", device="cuda", devices=None):
        from ..parallel.mesh import make_mesh, sharded_masked_sha512, sharded_tree_kernels

        self.mesh = parse_mesh(mesh)
        visible = _visible(device, devices)
        self.devices_visible = len(visible)
        self.n_devices = resolve_mesh_width(self.mesh, len(visible), pow2=True)
        self.device = visible[0]
        mesh_ = make_mesh(visible[: self.n_devices])
        self._masked = sharded_masked_sha512(mesh_)
        self._leaf, self._inner = sharded_tree_kernels(mesh_)
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

    def describe(self) -> dict:
        """Which devices, width and kernels this hasher resolved to, and
        the whole-tree path's calls and meters (the get_counts crypto
        block)."""
        cuda = self.device.type == "cuda"
        return {
            "mesh_requested": self.mesh,
            "mesh_width": self.n_devices,
            "devices_visible": self.devices_visible,
            "kernel": f"{'sha512_masked' if cuda else 'plain'}@{self.n_devices}",
            "tree_kernel": f"{'tree_inner_level' if cuda else 'plain'}@{self.n_devices}",
            "tree_width": self.n_devices,
            "tree_pipeline_calls": self.tree_calls,
            "transfers": self.transfers.get_json(),
            "tree_transfers": self.tree_transfers.get_json(),
            "device": str(self.device),
            "device_name": _device_name(self.device),
            "kernels": ["sha512_masked", "tree_inner_level"] if cuda else "plain",
        }

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
        from ..ops.treehash import ladder_buckets, pad_leaf_batch
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
            st = self._masked(self._upload(blocks), self._upload(nblocks))
            results.append((idxs, st))
        for idxs, st in results:
            arr = st.cpu().numpy()  # [M, 16] u32
            self.transfers.down(arr.nbytes)
            raw = _digests(arr[:, :8])
            for row, i in enumerate(idxs):
                out[i] = raw[row * 32 : row * 32 + 32]
        return out  # type: ignore[return-value]

    # -- whole-tree pipeline ----------------------------------------------

    def hash_tree(self, root, cancelled=None, cancel_lock=None) -> int:
        """Fill every missing node hash of a SHAMap with device-resident
        level-synchronous hashing. Returns the number of nodes hashed.

        ``cancelled``/``cancel_lock`` (a threading.Event and Lock,
        supplied together by ``WatchdogHasher``): the write-back checks
        ``cancelled`` and stamps the digests as ONE critical section
        under ``cancel_lock``, and the watchdog sets ``cancelled`` under
        the same lock before its host fallback starts. So a call the
        watchdog abandoned either stamped the whole tree before the
        fallback began, or stamps nothing.

        The host work is per level, not per child: a child of a depth-d
        node sits at depth d + 1, so an inner level's child-row table is
        one sorted lookup of its children's ids among the rows of the
        level below; only children with a known hash (sealed siblings,
        oversized leaves) are written into its template, and the
        digests go back onto the nodes in one pass in row order."""
        from ..ops.treehash import build_inner_template, ladder_buckets, pad_packed
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
                self._leaf(buf, self._upload(blocks), self._upload(nblocks), off)
            else:
                _k, child_rows, known, known_words, off = step
                template = build_inner_template(len(child_rows), HP_INNER_NODE)
                node_i, slot = np.divmod(known, 16)
                template[node_i[:, None], 1 + 8 * slot[:, None] + np.arange(8)] = known_words
                self.tree_transfers.up(template.nbytes + child_rows.nbytes)
                self._inner(
                    buf, self._upload(template), self._upload(child_rows), off
                )

        t_readback = time.perf_counter()
        host = buf.cpu().numpy()  # ONE transfer; waits for the whole chain
        t_write = time.perf_counter()
        self.tree_transfers.down(host.nbytes)
        raw = _digests(host)
        with cancel_lock if cancel_lock is not None else nullcontext():
            if cancelled is not None and cancelled.is_set():
                return 0  # abandoned by the watchdog: tree untouched
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


register_verifier("cpu", _host_verifier_factory, options=("threads",))
# strict: raises if the host library does not build
register_verifier("native", NativeVerifier)
register_verifier("openssl", CpuVerifier, options=("threads",))
register_verifier("cuda", CudaVerifier, options=("max_batch", "mesh", "device", "devices"))
register_hasher("cpu", CpuHasher)
# a config written for the JAX package's C hasher loads and hashes the same
register_hasher("cpp", CpuHasher)
register_hasher("cuda", CudaHasher, options=("mesh", "device", "devices"))


# --------------------------------------------------------------------------
# the node's hasher: cost routing and the wedge watchdog


class _RoutedFlat:
    """Flat-batch facade over a WatchdogHasher for compute_hashes: the
    routed/watchdogged prefix+packed paths WITHOUT the hash_tree attr
    (which would recurse back into the watchdog's tree dispatch)."""

    __slots__ = ("_wd",)

    def __init__(self, wd: "WatchdogHasher"):
        self._wd = wd

    def __call__(self, prefixes, payloads):
        return self._wd.prefix_hash_batch(prefixes, payloads)

    def prefix_hash_batch(self, prefixes, payloads):
        return self._wd.prefix_hash_batch(prefixes, payloads)

    def hash_packed(self, buf, offsets):
        return self._wd.hash_packed(buf, offsets)


def make_watched_hasher(backend: str,
                        min_device_nodes: int = 0,
                        mesh=None,
                        routing: str = "device",
                        first_timeout: Optional[float] = None,
                        device="cuda",
                        devices=None,
                        ) -> BatchHasher:
    """The ONE wiring for a possibly-device hasher: the cuda backend is
    wrapped in the wedge watchdog (a hung device call must fail the
    close, not freeze it) with a cpu host arm for cost routing; the cpu
    backend passes through untouched.

    ``mesh`` is the [hash_backend] width axis (``parse_mesh`` values,
    ``auto`` when None). When the hasher resolves to more than one
    device, the watchdog also gets a width-1 inner hasher: the one-card
    arm of the host / 1-card / N-card cost routing. ``routing`` "device"
    (default) sends every batch at or over ``min_device_nodes`` to the
    widest arm,
    "cost" routes by measured cost; ``first_timeout`` is the wedge
    deadline; ``device`` the torch device of the cuda hasher ("cpu" runs
    the kernels' plain versions) and ``devices`` an explicit list of
    the devices its mesh is cut from."""
    if backend != "cuda":
        return make_hasher(backend)
    mesh = "auto" if mesh is None else mesh
    hasher = make_hasher("cuda", mesh=mesh, device=device, devices=devices)
    inner_one = None
    if hasher.n_devices > 1:
        # the one-card arm: the same sharded code at width 1
        inner_one = make_hasher("cuda", mesh="0", device=device, devices=devices)
    return WatchdogHasher(
        hasher, make_hasher("cpu"), min_device_nodes=min_device_nodes,
        inner_one=inner_one, routing=routing, first_timeout=first_timeout,
    )


class _HashCostModel:
    """Measured-cost routing for the hash plane (the VerifyPlane
    stance), over host + device ARMS: per-pow2-bucket EWMAs per arm,
    first (build-laden) sample discarded per (arm, bucket), one host
    measurement enables the comparison, and a losing arm re-explores
    per (arm, bucket) after `reexplore_every` eligible losses (a
    counter, not a global modulo — a bucket whose calls never align
    with a global stride must not be starved), bounded to within 4x of
    the winning cost. Thread-safe: the hasher is shared across node
    threads."""

    EWMA = 0.3
    REEXPLORE_BOUND = 4.0

    def __init__(self, reexplore_every: int, min_device_nodes: int = 0,
                 arms: Sequence[str] = ("device",)):
        self._lock = threading.Lock()
        self._reexplore = reexplore_every
        # floor knob: batches below this size NEVER route to (or explore)
        # the device — the incremental seal's residual batches are a few
        # nodes, far below any plausible device win, and without the
        # floor every tiny residual would re-trigger per-bucket
        # exploration (a device round-trip per close)
        self.min_device_nodes = max(0, int(min_device_nodes))
        self.arms = tuple(arms)
        # arm -> bucket -> [n_samples, ewma]
        self._dev: dict[str, dict[int, list]] = {a: {} for a in self.arms}
        self._host_unit_ms: Optional[float] = None
        self._losses: dict[tuple[str, int], int] = {}

    @staticmethod
    def _bucket(n: int) -> int:
        return 1 << max(0, n - 1).bit_length()

    def _ewma(self, cur: Optional[float], ms: float) -> float:
        return ms if cur is None else (1 - self.EWMA) * cur + self.EWMA * ms

    def get_json(self) -> dict:
        """Routing-model snapshot (the get_counts crypto block).
        `buckets` is the primary device arm's view; `arms` every arm."""
        with self._lock:
            arms = {
                arm: {
                    str(b): {"samples": s[0], "ewma_ms": s[1]}
                    for b, s in sorted(slots.items())
                }
                for arm, slots in self._dev.items()
            }
            return {
                "min_device_nodes": self.min_device_nodes,
                "host_unit_ms": self._host_unit_ms,
                "arms": arms,
                "buckets": arms[self.arms[-1]],
                "losses": {
                    f"{a}:{b}": v
                    for (a, b), v in sorted(self._losses.items())
                },
            }

    def choose(self, n: int) -> str:
        """Pick the arm for an n-node batch: ``"host"`` or a device arm
        name. Unmeasured device arms are explored first (in declared
        order); the host is measured once before any comparison; after
        that the cheapest measured arm wins, with bounded per-(arm,
        bucket) re-exploration of close losers."""
        avail = self.arms
        with self._lock:
            if n < self.min_device_nodes or not avail:
                return "host"  # below any plausible win size
            b = self._bucket(n)
            costs: dict[str, float] = {}
            for a in avail:
                slot = self._dev[a].setdefault(b, [0, None])
                if slot[1] is None:
                    return a  # unmeasured (or build sample): explore
                costs[a] = slot[1]
            if self._host_unit_ms is None:
                return "host"  # measure the host side once
            exp_host = self._host_unit_ms * n
            best_arm = min(costs, key=lambda a: costs[a])
            if costs[best_arm] <= exp_host:
                self._losses.pop((best_arm, b), None)
                winner, best = best_arm, costs[best_arm]
            else:
                winner, best = "host", exp_host
            # losing device arms within striking distance of the winner
            # accrue losses and periodically re-explore; hopeless arms
            # (beyond the 4x band) never do
            for a in avail:
                if a == winner:
                    continue
                if costs[a] > self.REEXPLORE_BOUND * best:
                    continue
                k = (a, b)
                self._losses[k] = self._losses.get(k, 0) + 1
                if self._losses[k] >= self._reexplore:
                    self._losses[k] = 0
                    return a
            return winner

    def use_device(self, n: int) -> bool:
        return self.choose(n) != "host"

    def observe(self, arm: str, n: int, ms: float) -> None:
        if arm == "host":
            with self._lock:
                self._host_unit_ms = self._ewma(self._host_unit_ms, ms / n)
            return
        with self._lock:
            slot = self._dev[arm].setdefault(self._bucket(n), [0, None])
            slot[0] += 1
            if slot[0] <= 1:
                return  # discard the build-laden first sample
            slot[1] = self._ewma(slot[1], ms)

    def observe_device(self, n: int, ms: float) -> None:
        self.observe(self.arms[-1], n, ms)

    def observe_host(self, n: int, ms: float) -> None:
        self.observe("host", n, ms)


class WatchdogHasher(BatchHasher):
    """Run a device hasher's calls under a wedge deadline
    (utils.devicewatch): a device call that never returns would freeze
    every ledger close. An overrun raises ``DeviceWedged`` to the caller
    (the close fails) and marks the hasher, and the process-wide device
    verdict, wedged: every later call raises too, whatever its routing,
    and ``get_json`` reports it. An error the device call raises — a
    failed kernel build or launch, a CUDA error — propagates unchanged.
    ``fallback`` is the host arm of cost routing, never a substitute
    for a failed card.

    Every hashing call gets the generous first-call deadline: the
    hasher launches K2 and K3 on shapes the wrapper cannot enumerate,
    so no call is provably build-free.

    ``inner_one`` (``make_watched_hasher`` builds it when the wide
    hasher resolved to more than one device) is the one-card arm of the
    host / 1-card / N-card routing: the arms are ``dev1`` and ``devN``
    (the wide ``inner``), or ``device`` alone without it. The split
    follows the JAX hasher's model; on CUDA it is not measured yet.

    The inner hashers' meters are read through ``inner`` and
    ``inner_one`` (and summed in ``transfer_json``);
    ``device_nodes``/``host_nodes`` sum the arms and the fallback.
    """

    # [tree] fused kill-switch surface: node.py stamps cfg.tree_fused
    # here, and shamap.compute_hashes / ledgermaster._drain_loop consult
    # it before taking the whole-tree device pipeline (fused=0 keeps
    # the staged per-level hash_packed path — the identity leg)
    fused_enabled = True

    def __init__(self, inner: BatchHasher, fallback: BatchHasher,
                 first_timeout: Optional[float] = None,
                 warm_timeout: Optional[float] = None,
                 min_device_nodes: int = 0,
                 routing: str = "device",
                 inner_one: Optional[BatchHasher] = None):
        from ..utils.devicewatch import resolve_timeouts

        self.inner = inner
        self.fallback = fallback
        self.inner_one = inner_one
        self.name = inner.name
        self._t_first, _ = resolve_timeouts(first_timeout, warm_timeout)
        self.device_wedged = False
        # routing="device" sends every batch the floor admits to the
        # card; "cost" is measured-cost routing (same stance as
        # VerifyPlane's model: the device must EARN traffic; a losing
        # device floors at the host path instead of dragging a leg, and
        # is re-explored bounded)
        if routing not in ("cost", "device"):
            raise ValueError(
                f"hash routing must be cost|device, got {routing!r}"
            )
        self.routing = routing
        self._route_by_cost = routing != "device"
        # device floor: flat batches below this size never route to the
        # device, and under cost routing tree hashing with a
        # caller-supplied dirty-count hint below it goes straight to the
        # host level-batcher
        floor = int(min_device_nodes)
        if floor < 0:
            raise ValueError(f"min_device_nodes must be >= 0, got {floor}")
        self.min_device_nodes = floor
        self._arm_names = ("dev1", "devN") if inner_one is not None else ("device",)
        self._flat = _HashCostModel(
            reexplore_every=256, min_device_nodes=floor, arms=self._arm_names,
        )
        # tree model buckets per-node RATE in the size-independent
        # bucket 1 — the floor applies via the hash_tree hint, not here
        self._tree = _HashCostModel(reexplore_every=64)

    def _inner_of(self, arm: str) -> BatchHasher:
        if arm == "dev1" and self.inner_one is not None:
            return self.inner_one
        return self.inner

    @property
    def device_nodes(self):  # type: ignore[override]
        one = self.inner_one.device_nodes if self.inner_one is not None else 0
        return self.inner.device_nodes + one

    @device_nodes.setter
    def device_nodes(self, value):  # counter reset
        self.inner.device_nodes = value
        if self.inner_one is not None:
            self.inner_one.device_nodes = 0

    @property
    def host_nodes(self):  # type: ignore[override]
        one = self.inner_one.host_nodes if self.inner_one is not None else 0
        return self.inner.host_nodes + self.fallback.host_nodes + one

    @host_nodes.setter
    def host_nodes(self, value):  # counter reset
        # round-trips: getter sums the arms and the fallback, so the
        # value goes to inner and the other shares zero
        self.inner.host_nodes = value
        self.fallback.host_nodes = 0
        if self.inner_one is not None:
            self.inner_one.host_nodes = 0

    def _wedge(self, exc: Exception) -> None:
        from ..utils.devicewatch import log as dlog

        self.device_wedged = True
        dlog.error("hash plane: %s — every later hashing call raises", exc)

    def _check_alive(self) -> None:
        from ..utils.devicewatch import HEALTH, DeviceWedged

        if self.device_wedged or HEALTH.dead:
            self.device_wedged = True
            raise DeviceWedged(
                "the device is wedged; nothing is hashed on the host "
                "instead (restart the node)"
            )

    def prefix_hash_batch(self, prefixes, payloads):
        return self._routed(
            len(prefixes),
            lambda arm: self._inner_of(arm).prefix_hash_batch(prefixes, payloads),
            lambda: self.fallback.prefix_hash_batch(prefixes, payloads),
        )

    def hash_packed(self, buf, offsets):
        """Routed flat-buffer hashing (the seal/flush path): same cost
        model and wedge watchdog as the (prefix, payload) shape."""
        return self._routed(
            len(offsets) - 1,
            lambda arm: self._inner_of(arm).hash_packed(buf, offsets),
            lambda: self.fallback.hash_packed(buf, offsets),
        )

    def _routed(self, n, device_call, host_fn):
        """Host / 1-card / N-card dispatch: ``device_call(arm)`` runs the
        batch on that arm's inner hasher. Cost mode picks the cheapest
        measured arm (exploring unmeasured ones), device mode sends every
        batch at or above the floor to the widest arm."""
        from ..utils.devicewatch import DeviceWedged, call_with_deadline

        self._check_alive()
        arm: Optional[str] = None
        if n > 0:
            if not self._route_by_cost:
                if n >= self.min_device_nodes:
                    arm = self._arm_names[-1]
            else:
                choice = self._flat.choose(n)
                arm = None if choice == "host" else choice
        if arm is not None:
            t0 = time.perf_counter()
            try:
                out = call_with_deadline(
                    lambda: device_call(arm), self._t_first, label="hash-device",
                )
            except DeviceWedged as exc:
                self._wedge(exc)
                raise
            self._flat.observe(arm, n, (time.perf_counter() - t0) * 1000.0)
            return out
        t0 = time.perf_counter()
        out = host_fn()
        if n > 0:
            self._flat.observe_host(n, (time.perf_counter() - t0) * 1000.0)
        return out

    def get_json(self) -> dict:
        """Hash-plane routing snapshot: the device, the routing mode and
        floor, the node counters, transfers and both cost models."""
        describe = getattr(self.inner, "describe", None)
        return {
            "backend": self.name,
            "wedged": self.device_wedged,
            "routing": self.routing,
            "arms": list(self._arm_names),
            "fused": bool(self.fused_enabled),
            "mesh": describe() if describe is not None else None,
            "device_nodes": self.device_nodes,
            "host_nodes": self.host_nodes,
            "min_device_nodes": self.min_device_nodes,
            "transfers": self.transfer_json(),
            "flat_model": self._flat.get_json(),
            "tree_model": self._tree.get_json(),
        }

    def transfer_json(self) -> Optional[dict]:
        """Transfer-honesty aggregate of both device arms' meters, the
        flat ``transfers`` and the whole-tree ``tree_transfers`` (kept
        apart on each inner so the one-readback-per-tree pin stays crisp
        there). Per-close deltas of this block are the residency proof."""
        agg: Optional[dict] = None
        meters = [getattr(h, m, None) for h in (self.inner, self.inner_one)
                  if h is not None for m in ("transfers", "tree_transfers")]
        for meter in meters:
            if meter is None:
                continue
            j = meter.get_json()
            if agg is None:
                agg = dict(j)
            else:
                for k, v in j.items():
                    agg[k] = agg.get(k, 0) + v
        return agg

    def flat_hasher(self) -> "_RoutedFlat":
        """This hasher's routed FLAT facade (no hash_tree attr): tree
        hashing through it level-batches into the routed hash_packed
        path."""
        return _RoutedFlat(self)

    def _host_tree(self, root) -> int:
        """Level-batched hashing through the watched flat path."""
        from ..state.shamap import compute_hashes

        return compute_hashes(root, _RoutedFlat(self))

    def hash_tree(self, root, hint_nodes: Optional[int] = None) -> int:
        from ..utils.devicewatch import DeviceWedged, call_with_deadline

        self._check_alive()
        inner_tree = getattr(self.inner, "hash_tree", None)
        if inner_tree is None:
            return self._host_tree(root)
        if (
            hint_nodes is not None
            and hint_nodes < self.min_device_nodes
            and self._route_by_cost
        ):
            # caller-declared small dirty set (incremental-seal residual
            # drains): below any plausible device win, and exploring the
            # device per tiny batch would burn a round-trip per close
            return self._host_tree(root)
        if self._route_by_cost and not self._tree.use_device(1):
            from ..state.shamap import compute_hashes

            t0 = time.perf_counter()
            count = compute_hashes(root, self.fallback)
            if count:
                self._tree.observe_host(
                    count, (time.perf_counter() - t0) * 1000.0
                )
            return count
        cancel = threading.Event()
        lock = threading.Lock()
        t0 = time.perf_counter()
        try:
            count = call_with_deadline(
                lambda: inner_tree(root, cancelled=cancel, cancel_lock=lock),
                self._t_first, label="hash-device",
            )
        except DeviceWedged as exc:
            # setting cancelled under the shared lock means the abandoned
            # call either already stamped the whole tree or stamps
            # nothing: the tree is never left half-hashed behind the
            # caller's back
            with lock:
                cancel.set()
            self._wedge(exc)
            raise
        if count:
            # per-node rate in the size-independent bucket 1
            self._tree.observe_device(
                1, (time.perf_counter() - t0) * 1000.0 / count
            )
        return count


# --------------------------------------------------------------------------
# path-quality plane: Q16.16 candidate evaluation on K4

# candidate batches below this never route to the device under cost
# routing: a path_find with a handful of candidates can never amortize a
# launch
PATHQ_DEVICE_FLOOR = 256


class PathQualityEvaluator:
    """Evaluation of flattened candidate-path rate matrices, the path
    search's pre-rank (paths.plane.PathPlane.make_pre_rank).

    The arms give the same bytes: the NumPy host arm
    (``ops.pathq.path_quality_host``), a one-card arm ``dev1`` and, when
    ``mesh=`` resolves to more than one device, an N-card arm ``devN``:
    K4 over a mesh of that width (rounded down to a power of two, as the
    JAX evaluator's), ``parallel.mesh.sharded_path_quality``.
    ``routing``: "device" (default) runs every batch on the widest arm;
    "host" runs the host arm; "cost" routes each batch by the
    measured-cost model (``_HashCostModel``: per-pow2-bucket EWMAs, the
    first sample discarded, bounded re-exploration, and batches under
    ``min_device_batch`` on the host). A device batch never falls back
    to the host arm: a failed build or launch raises."""

    def __init__(self, mesh=None, routing: Optional[str] = None,
                 device="cuda", min_device_batch: int = PATHQ_DEVICE_FLOOR,
                 devices=None):
        routing = (routing or "device").strip().lower()
        if routing not in ("device", "host", "cost"):
            raise ValueError(
                f"path evaluator routing must be cost|device|host, got {routing!r}"
            )
        self.mesh = parse_mesh(mesh)
        self.routing = routing
        self._visible = _visible(device, devices) if routing != "host" else []
        self.device = self._visible[0] if self._visible else None
        wide = resolve_mesh_width(self.mesh, len(self._visible), pow2=True) > 1
        arms = ("dev1", "devN") if wide else ("dev1",)
        self._model = _HashCostModel(
            reexplore_every=64, min_device_nodes=min_device_batch, arms=arms,
        )
        self._lock = threading.Lock()
        self._kernels: dict[str, tuple] = {}  # arm -> (sharded K4, width)
        # fn(rates) for every non-empty batch, before it is evaluated:
        # lets a caller hold a kernel to its plain version on the very
        # batches the path search gave it
        self.batch_observers: list[Callable[[np.ndarray], None]] = []
        self.host_batches = 0
        self.device_batches = 0
        self.rows_evaluated = 0

    def _kernel(self, arm: str) -> tuple:
        from ..parallel.mesh import make_mesh, sharded_path_quality

        with self._lock:
            hit = self._kernels.get(arm)
            if hit is None:
                want = "0" if arm == "dev1" else self.mesh
                width = resolve_mesh_width(want, len(self._visible), pow2=True)
                hit = self._kernels[arm] = (
                    sharded_path_quality(make_mesh(self._visible[:width])), width)
            return hit

    def evaluate_host(self, rates: np.ndarray) -> np.ndarray:
        from ..ops.pathq import path_quality_host

        return path_quality_host(rates)

    def _evaluate_device(self, arm: str, rates: np.ndarray) -> np.ndarray:
        fn, _width = self._kernel(arm)
        return fn(torch.from_numpy(rates).to(self.device)).cpu().numpy()

    def evaluate(self, rates: np.ndarray) -> np.ndarray:
        """[B, H] uint32 -> [B] uint32 composites on the routed arm."""
        rates = np.ascontiguousarray(rates, dtype=np.uint32)
        n = int(rates.shape[0])
        if n == 0:
            return np.zeros((0,), dtype=np.uint32)
        for observe in self.batch_observers:
            observe(rates)
        if self.routing == "host":
            arm = "host"
        elif self.routing == "device":
            arm = self._model.arms[-1]
        else:
            arm = self._model.choose(n)
        t0 = time.perf_counter()
        if arm == "host":
            out = self.evaluate_host(rates)
        else:
            out = self._evaluate_device(arm, rates)
        self._model.observe(arm, n, (time.perf_counter() - t0) * 1000.0)
        with self._lock:
            self.rows_evaluated += n
            if arm == "host":
                self.host_batches += 1
            else:
                self.device_batches += 1
        return out

    def device_width(self) -> int:
        """Effective width of the widest device arm."""
        return self._kernel(self._model.arms[-1])[1]

    def get_json(self) -> dict:
        with self._lock:
            widths = {a: w for a, (_f, w) in self._kernels.items()}
            counters = {
                "host_batches": self.host_batches,
                "device_batches": self.device_batches,
                "rows_evaluated": self.rows_evaluated,
            }
        return {
            "mesh": self.mesh,
            "routing": self.routing,
            "device": None if self.device is None else str(self.device),
            "min_device_batch": self._model.min_device_nodes,
            "arm_widths": widths,
            **counters,
            "model": self._model.get_json(),
        }


def make_path_evaluator(mesh=None, routing: Optional[str] = None,
                        device="cuda",
                        min_device_batch: int = PATHQ_DEVICE_FLOOR,
                        devices=None,
                        ) -> PathQualityEvaluator:
    """The one wiring of the path-quality evaluator."""
    return PathQualityEvaluator(mesh=mesh, routing=routing, device=device,
                                min_device_batch=min_device_batch, devices=devices)
