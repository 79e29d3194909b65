"""SHAMap: 16-ary Merkle-radix tree over 256-bit keys.

Hash compatible with the reference (src/ripple_app/shamap/
SHAMapTreeNode.cpp:253-295 updateHash; SHAMapNodeID.cpp:147-176
selectBranch):

- inner node hash  = SHA512half(HP_INNER_NODE || 16 child hashes);
  an inner with no branches hashes to zero,
- tx leaf (no md)  = SHA512half(HP_TXN_ID || data)          (== the tx ID),
- tx leaf (w/ md)  = SHA512half(HP_TX_NODE || data || tag),
- state leaf       = SHA512half(HP_LEAF_NODE || data || tag).

A persistent tree (every mutation returns a new root sharing unchanged
subtrees) with deferred, level-synchronous hashing: mutations never
hash; ``compute_hashes`` groups the unhashed nodes by depth and hands
them to a batch hasher, or the whole tree to a hasher's ``hash_tree``
(the device-resident seal, crypto.backend.CudaHasher). Nodes persist
to a NodeStore in the prefix format (``flush``; a blob is exactly the
node's hashed bytes) and a tree is rebuilt from one (``from_store``,
every node content-checked): eagerly, or lazily as the out-of-core tree,
whose unmaterialized slots (``Stub``, ``LazyInner``) fault through a
``NodeSource`` and the bounded hot-node cache on first descent. This is
the JAX package's state/shamap.py: the node pack (``encode_nodes``) and
the write-set merge (``SHAMap.bulk_update``) run in C where this
package's ``_stser`` extension builds (``native.load_stser``), else in
Python, with the same bytes and roots. Unlike the JAX package, the
native merge is given the ``Stub`` type on every tree, so a building
tree over a lazy root (no source of its own, stubs inside) merges.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, Iterator, Optional

from ..utils.hashes import (
    HP_INNER_NODE,
    HP_LEAF_NODE,
    HP_TXN_ID,
    HP_TX_NODE,
    prefix_hash,
    sha512_half,
)

__all__ = [
    "TNType", "SHAMapItem", "SHAMap", "Leaf", "Inner",
    "Stub", "LazyInner", "NodeSource", "MissingNodeError",
    "encode_nodes", "compute_hashes", "inner_node_cache", "configure_inner_cache",
    "resolve_node",
]


class MissingNodeError(KeyError):
    """A tree node could not be fetched from the store. On lazy trees
    this can surface MID-WALK, long after the tree opened — e.g. an
    online-deletion sweep retired a cached historical ledger's nodes —
    so consumers that used to rely on Ledger.load's all-or-nothing
    materialization catch THIS (rpc dispatch maps it to lgrNotFound;
    the overlay serving path answers with silence) instead of leaking
    a bare KeyError."""


ZERO256 = b"\x00" * 32


class TNType(IntEnum):
    """Node types (reference: SHAMapTreeNode.h:47-53). The numeric values
    double as the wire-format trailer byte for leaves (addRaw snfWIRE)."""

    INNER = 1
    TX_NM = 2  # transaction, no metadata (tx map of an open ledger)
    TX_MD = 3  # transaction + metadata (tx map of a closed ledger)
    ACCOUNT_STATE = 4  # state map leaf


_LEAF_PREFIX = {
    TNType.TX_NM: HP_TXN_ID,
    TNType.TX_MD: HP_TX_NODE,
    TNType.ACCOUNT_STATE: HP_LEAF_NODE,
}

# wire-format trailer bytes (reference addRaw: snfWIRE)
_WIRE_TX_NM = 0
_WIRE_STATE = 1
_WIRE_INNER_FULL = 2
_WIRE_INNER_COMPRESSED = 3
_WIRE_TX_MD = 4


class SHAMapItem:
    """A keyed blob: 32-byte tag (index) + serialized payload
    (reference: src/ripple_app/shamap/SHAMapItem.h).

    ``parsed`` memoizes the deserialized STObject for this (immutable)
    blob, shared across the map versions that alias the item; consumers
    copy before mutating (Ledger.read_entry does)."""

    __slots__ = ("tag", "data", "parsed")

    def __init__(self, tag: bytes, data: bytes):
        if len(tag) != 32:
            raise ValueError(f"SHAMapItem tag must be 32 bytes, got {len(tag)}")
        self.tag = tag
        self.data = data
        self.parsed = None

    def __eq__(self, other):
        return (
            isinstance(other, SHAMapItem)
            and self.tag == other.tag
            and self.data == other.data
        )

    def __repr__(self):
        return f"SHAMapItem({self.tag.hex()[:16]}…, {len(self.data)}B)"


class Leaf:
    """Immutable leaf node. `_hash` is a lazily-filled, write-once cache —
    the only mutable slot, so sharing across snapshots stays safe."""

    __slots__ = ("item", "type", "_hash")

    def __init__(self, item: SHAMapItem, type: TNType, hash: Optional[bytes] = None):
        self.item = item
        self.type = type
        self._hash = hash

    def hash_payload(self) -> tuple[int, bytes]:
        """(prefix, payload) whose prefixed SHA-512-half is this node's hash
        (reference: SHAMapTreeNode.cpp updateHash leaf arms)."""
        prefix = _LEAF_PREFIX[self.type]
        if self.type == TNType.TX_NM:
            return prefix, self.item.data
        return prefix, self.item.data + self.item.tag


class Inner:
    """Immutable inner node: 16 child slots."""

    __slots__ = ("children", "_hash")

    def __init__(self, children: tuple, hash: Optional[bytes] = None):
        self.children = children  # tuple of 16 × (Leaf | Inner | None)
        self._hash = hash

    def is_empty(self) -> bool:
        return all(c is None for c in self.children)

    def branch_count(self) -> int:
        return sum(1 for c in self.children if c is not None)


EMPTY_INNER = Inner((None,) * 16, hash=ZERO256)


# --------------------------------------------------------------------------
# out-of-core faulting: Stub / LazyInner / NodeSource (doc/storage.md)
#
# A lazy tree holds *unmaterialized* child slots: a `Stub` knows only a
# node hash and the `NodeSource` to fault it from. Stubs always carry a
# hash (`_hash` is set at construction), so every hash-driven fast path
# — compute_hashes skipping sealed subtrees, compare's hash
# short-circuit, encode_nodes reading child hashes — works on a stub
# without touching the store. Only an actual *descent* through the slot
# faults, and the faulted node lives in the process-wide HotNodeCache
# (state/hotcache.py), NOT in the tree: the slot keeps its stub, so
# evicting the cache entry really frees the node and the resident set
# stays bounded by `[tree] cache_mb` regardless of state size.


class Stub:
    """Unmaterialized child slot: hash + where to fault it from."""

    __slots__ = ("_hash", "source")

    def __init__(self, hash: bytes, source: "NodeSource"):
        self._hash = hash
        self.source = source

    def resolve(self):
        """Fault the node (through the hot cache)."""
        return self.source.load(self._hash)

    def __repr__(self):
        return f"Stub({self._hash.hex()[:16]}…)"


class LazyInner(Inner):
    """Faulted inner node that stays PACKED: the 512-byte child-hash
    area is kept as one bytes object and `child(b)` resolves straight
    off a 32-byte slice. The 16-slot `children` tuple of Stub objects
    materializes only when something iterates it (mutation copies,
    whole-subtree walks); key-guided descents (`get`, `succ`,
    bulk_update path prefaults) never pay for the 16 sibling objects."""

    __slots__ = ("raw", "source")

    def __init__(self, raw: bytes, source: "NodeSource", hash: bytes):
        # deliberately NOT calling Inner.__init__: the `children` slot
        # stays unset until __getattr__ materializes it
        self.raw = raw
        self.source = source
        self._hash = hash

    def __getattr__(self, name):
        if name == "children":
            raw, src = self.raw, self.source
            ch = tuple(
                None if raw[i * 32: (i + 1) * 32] == ZERO256
                else Stub(raw[i * 32: (i + 1) * 32], src)
                for i in range(16)
            )
            # benign write race: concurrent materializers build equal
            # tuples of content-addressed stubs; either assignment wins
            self.children = ch
            return ch
        raise AttributeError(name)

    def child_hash(self, b: int) -> bytes:
        return self.raw[b * 32: (b + 1) * 32]

    def child(self, b: int):
        h = self.raw[b * 32: (b + 1) * 32]
        if h == ZERO256:
            return None
        return self.source.load(h)

    def is_empty(self) -> bool:
        return self.raw == ZERO256 * 16

    def branch_count(self) -> int:
        raw = self.raw
        return sum(
            1 for i in range(16)
            if raw[i * 32: (i + 1) * 32] != ZERO256
        )


class NodeSource:
    """The fault door of a lazy tree: content-addressed loads through
    the process-wide hot-node cache, single-flight per hash.

    `known` is the identity of the backing store (the Database's
    `flushed` set): SHAMap.flush skips any stub/lazy subtree whose
    source carries the same `known` object — those bytes are already
    durably in that store, so a close's save never faults the cold
    tail just to re-write it.

    `cold` marks a historical scan (an RPC touching an old ledger):
    its faults enter the hot cache one epoch behind, so a deep history
    walk becomes first-pass eviction fodder instead of flushing the
    serving snapshot's working set (the readplane epoch contract)."""

    __slots__ = ("fetch", "verify", "known", "cold")

    def __init__(self, fetch: Callable[[bytes], Optional[bytes]],
                 verify: bool = True, known: Optional[set] = None,
                 cold: bool = False):
        self.fetch = fetch
        self.verify = verify
        self.known = known
        self.cold = cold

    def load(self, h: bytes):
        """Leaf | LazyInner for `h`, faulting through the hot cache."""
        return inner_node_cache().get_or_load(h, self._load,
                                              cold=self.cold)

    def _load(self, h: bytes):
        blob = self.fetch(h)
        if blob is None:
            raise MissingNodeError(f"missing node {h.hex()}")
        if self.verify:
            if sha512_half(blob) != h:
                raise ValueError(
                    f"node content hash mismatch: key {h.hex()[:16]}"
                )
        if len(blob) >= 4 and \
                int.from_bytes(blob[:4], "big") == HP_INNER_NODE:
            if len(blob) != 516:
                raise ValueError(f"bad inner node length {len(blob) - 4}")
            return LazyInner(blob[4:], self, h), len(blob)
        node = deserialize_node_prefix(blob)
        if isinstance(node, InnerStub):  # unreachable; defensive
            raise ValueError("inner blob misclassified")
        node._hash = h
        return node, len(blob)


def resolve_node(node):
    """Fault `node` if it is a stub; identity otherwise. The accessor
    every traversal outside this module uses before type-dispatching on
    Leaf/Inner (state/shamapsync.py walks, node/inbound.py serving)."""
    if type(node) is Stub:
        return node.resolve()
    return node


_resolve = resolve_node


def _step(node, b: int):
    """Child slot `b` of an inner: plain tuple index for Inner, packed
    raw-slice fault for LazyInner (no sibling-stub materialization)."""
    if type(node) is Inner:
        return node.children[b]
    return node.child(b)


def _nibble(key: bytes, depth: int) -> int:
    """Branch index at `depth` (reference: SHAMapNodeID::selectBranch —
    high nibble at even depths, low nibble at odd)."""
    b = key[depth // 2]
    return b & 0xF if depth & 1 else b >> 4


# --------------------------------------------------------------------------
# persistent-tree primitives (each returns a NEW node; inputs untouched)


def _set_item(node, key: bytes, leaf: Leaf, depth: int):
    node = _resolve(node)
    if node is None:
        return leaf
    if isinstance(node, Leaf):
        if node.item.tag == key:
            return leaf  # replace
        # leaf collision: grow inner nodes until the two keys diverge
        other = node
        branch_new = _nibble(key, depth)
        branch_old = _nibble(other.item.tag, depth)
        children = [None] * 16
        if branch_new == branch_old:
            children[branch_new] = _set_item(other, key, leaf, depth + 1)
        else:
            children[branch_new] = leaf
            children[branch_old] = other
        return Inner(tuple(children))
    # inner
    b = _nibble(key, depth)
    child = node.children[b]
    new_child = _set_item(child, key, leaf, depth + 1)
    children = list(node.children)
    children[b] = new_child
    return Inner(tuple(children))


def _del_item(node, key: bytes, depth: int):
    """Returns the replacement node (None if subtree empty), or raises
    KeyError. Collapses single-leaf inners on the way up (reference:
    SHAMap::delItem single-child fold-up)."""
    node = _resolve(node)
    if node is None:
        raise KeyError(key.hex())
    if isinstance(node, Leaf):
        if node.item.tag != key:
            raise KeyError(key.hex())
        return None
    b = _nibble(key, depth)
    new_child = _del_item(node.children[b], key, depth + 1)
    children = list(node.children)
    children[b] = new_child
    live = [c for c in children if c is not None]
    if len(live) == 1:
        only = _resolve(live[0])  # the fold-up candidate may be a stub
        if isinstance(only, Leaf):
            return only
    if not live:
        return None
    return Inner(tuple(children))


def _build_subtree(ops: list, lo: int, hi: int, depth: int):
    """Canonical subtree for ops[lo:hi] (sorted, unique (key, Leaf)
    set-ops) under an empty slot. Shared nibble runs recurse once — the
    path-copy cost of a batch is O(distinct inner nodes), not
    O(ops × depth). Index-range recursion: no slice copies."""
    if hi - lo == 1:
        return ops[lo][1]
    children = [None] * 16
    shift_odd = depth & 1
    byte_i = depth // 2
    i = lo
    while i < hi:
        kb = ops[i][0][byte_i]
        b = kb & 0xF if shift_odd else kb >> 4
        j = i + 1
        while j < hi:
            kb = ops[j][0][byte_i]
            if (kb & 0xF if shift_odd else kb >> 4) != b:
                break
            j += 1
        children[b] = _build_subtree(ops, i, j, depth + 1)
        i = j
    return Inner(tuple(children))


def _bulk_merge(node, ops: list, lo: int, hi: int, depth: int,
                dels: list):
    """Merge ops[lo:hi] (sorted, unique (key, Leaf|None); None = delete)
    into the persistent subtree at `node`; returns the replacement node
    (None when the subtree empties). One DFS pass: each dirty inner is
    copied once regardless of how many ops pass through it. Deleting a
    missing key raises KeyError — exact `_del_item` parity. `dels` is
    the delete-count prefix array over `ops` (dels[i] = deletes before
    index i): a subtree whose run carries no deletes can neither empty
    nor fold up, so the live-child scan is skipped entirely.

    The tree is CANONICAL (structure is a pure function of the final
    key set: inners exist exactly on shared prefixes of >= 2 leaves, and
    single-leaf inners collapse), so this produces byte-identical roots
    to any per-key application of the same final key->value map — the
    property the differential suite pins."""
    if lo >= hi:
        return node
    node = _resolve(node)
    if hi - lo == 1:
        # singleton run: the lean per-key primitives finish the path
        k, leaf = ops[lo]
        if leaf is None:
            return _del_item(node, k, depth)
        return _set_item(node, k, leaf, depth)
    if node is None:
        if dels[hi] != dels[lo]:
            for i in range(lo, hi):
                if ops[i][1] is None:
                    raise KeyError(ops[i][0].hex())
        return _build_subtree(ops, lo, hi, depth)
    if isinstance(node, Leaf):
        tag = node.item.tag
        merged: list = []
        replaced = False
        placed = False
        for i in range(lo, hi):
            k, leaf = ops[i]
            if not placed and not replaced and tag < k:
                merged.append((tag, node))
                placed = True
            if k == tag:
                replaced = True
                if leaf is not None:
                    merged.append((k, leaf))
            elif leaf is None:
                raise KeyError(k.hex())
            else:
                merged.append((k, leaf))
        if not replaced and not placed:
            merged.append((tag, node))
        if not merged:
            return None
        if len(merged) == 1:
            return merged[0][1]
        return _build_subtree(merged, 0, len(merged), depth)
    # inner: partition the sorted run into contiguous nibble runs
    children = list(node.children)
    shift_odd = depth & 1
    byte_i = depth // 2
    i = lo
    while i < hi:
        kb = ops[i][0][byte_i]
        b = kb & 0xF if shift_odd else kb >> 4
        j = i + 1
        while j < hi:
            kb = ops[j][0][byte_i]
            if (kb & 0xF if shift_odd else kb >> 4) != b:
                break
            j += 1
        children[b] = _bulk_merge(children[b], ops, i, j, depth + 1, dels)
        i = j
    if dels[hi] == dels[lo]:
        return Inner(tuple(children))  # no deletes below: cannot collapse
    live = [c for c in children if c is not None]
    if not live:
        return None
    if len(live) == 1:
        only = _resolve(live[0])  # the fold-up candidate may be a stub
        if isinstance(only, Leaf):
            return only  # single-leaf fold-up (del_item parity)
    return Inner(tuple(children))


def _get(node, key: bytes, depth: int) -> Optional[SHAMapItem]:
    while node is not None:
        node = _resolve(node)
        if isinstance(node, Leaf):
            return node.item if node.item.tag == key else None
        node = _step(node, _nibble(key, depth))
        depth += 1
    return None


def _walk_leaves(node) -> Iterator[Leaf]:
    """Leaves in ascending key order (radix order == numeric order)."""
    node = _resolve(node)
    if node is None:
        return
    if isinstance(node, Leaf):
        yield node
        return
    for c in node.children:
        if c is not None:
            yield from _walk_leaves(c)


# --------------------------------------------------------------------------
# batched hashing


def _collect_unhashed(root) -> list[list]:
    """Unhashed nodes grouped by depth (index = depth). A node whose hash is
    cached is a sealed subtree — nothing below it can be unhashed, because
    mutation always rebuilds the whole path from the root with fresh
    (hashless) nodes."""
    levels: list[list] = []

    def visit(node, depth):
        if node is None or node._hash is not None:
            return
        while len(levels) <= depth:
            levels.append([])
        levels[depth].append(node)
        if isinstance(node, Inner):
            for c in node.children:
                visit(c, depth + 1)

    visit(root, 0)
    return levels


def _default_hasher(prefixes, payloads):
    return [prefix_hash(p, d) for p, d in zip(prefixes, payloads)]


# --------------------------------------------------------------------------
# flat-buffer node encoding: every dirty node's prefix-format bytes packed
# into ONE contiguous buffer + offsets (the exact hashed message per node),
# instead of one Python payload object per node.

_PFX_INNER = HP_INNER_NODE.to_bytes(4, "big")
_PFX_LEAF = {t: p.to_bytes(4, "big") for t, p in _LEAF_PREFIX.items()}


def _resolve_native_pack():
    """The C node pack (native/src/stser.cc ``pack_nodes``), or None:
    the Python loop."""
    from ..native import load_stser

    return getattr(load_stser(), "pack_nodes", None)


def _resolve_native_merge():
    """The C write-set merge (``bulk_merge``) where it has its stub door
    (its optional 5th argument, faulting stubs on the op path, probed
    through the module's ``BULK_MERGE_STUB_DOOR``), else None: a library
    without it leaves every tree that can hold a stub to the Python
    merge."""
    from ..native import load_stser

    mod = load_stser()
    if getattr(mod, "BULK_MERGE_STUB_DOOR", 0) < 1:
        return None
    return getattr(mod, "bulk_merge", None)


def _encode_nodes_py(nodes) -> tuple[bytes, list[int]]:
    buf = bytearray()
    ext = buf.extend
    offsets = [0]
    app = offsets.append
    for node in nodes:
        if isinstance(node, Inner):
            ext(_PFX_INNER)
            for c in node.children:
                ext(c._hash if c is not None else ZERO256)
        else:
            t = node.type
            ext(_PFX_LEAF[t])
            ext(node.item.data)
            if t is not TNType.TX_NM:
                ext(node.item.tag)
        app(len(buf))
    return bytes(buf), offsets


def encode_nodes(nodes) -> tuple[bytes, list[int]]:
    """Pack the prefix-format bytes of `nodes` (Leaf | Inner; inner
    children must already carry hashes) into one contiguous buffer.
    Returns (buffer, offsets[n+1]); node i's message is
    buffer[offsets[i]:offsets[i+1]]."""
    nodes = nodes if isinstance(nodes, list) else list(nodes)
    pack = _resolve_native_pack()
    if pack is not None:
        return pack(nodes, int(HP_INNER_NODE), int(HP_TXN_ID),
                    int(HP_TX_NODE), int(HP_LEAF_NODE))
    return _encode_nodes_py(nodes)


def compute_hashes(root, hash_batch: Callable = _default_hasher) -> int:
    """Fill every missing node hash, one batched call per tree level,
    deepest level first. Returns the number of nodes hashed.

    This is the flushDirty replacement (reference:
    LedgerConsensus.cpp:993-996 → SHAMap::flushDirty). A hasher with a
    ``hash_tree`` method (CudaHasher) takes the whole tree instead: its
    digests stay device-resident across levels.
    """
    if hasattr(hash_batch, "hash_tree"):
        return hash_batch.hash_tree(root)
    levels = _collect_unhashed(root)
    packed = getattr(hash_batch, "hash_packed", None)
    n = 0
    for level in reversed(levels):
        if packed is not None:
            # flat-buffer path: one contiguous encoding per level feeds
            # the batch hasher in a single call — no per-node payload
            # objects (the prep cost that dominated the host seal)
            targets = []
            for node in level:
                if isinstance(node, Inner) and node.is_empty():
                    node._hash = ZERO256
                else:
                    targets.append(node)
            if targets:
                buf, offsets = encode_nodes(targets)
                digests = packed(buf, offsets)
                for node, dg in zip(targets, digests):
                    node._hash = dg
            n += len(targets)
            continue
        prefixes, payloads = [], []
        for node in level:
            if isinstance(node, Leaf):
                p, d = node.hash_payload()
            else:
                if node.is_empty():
                    node._hash = ZERO256
                    continue
                p = HP_INNER_NODE
                d = b"".join(
                    (c._hash if c is not None else ZERO256) for c in node.children
                )
            prefixes.append(p)
            payloads.append(d)
        digests = hash_batch(prefixes, payloads) if prefixes else []
        i = 0
        for node in level:
            if node._hash is None:
                node._hash = digests[i]
                i += 1
        n += len(prefixes)
    return n


# --------------------------------------------------------------------------
# node (de)serialization — NodeStore uses the prefix format, the wire
# protocol the compressed format (reference addRaw/make from snfPREFIX /
# snfWIRE)


def serialize_node_prefix(node) -> bytes:
    if isinstance(node, Inner):
        out = HP_INNER_NODE.to_bytes(4, "big")
        return out + b"".join(
            (c._hash if c is not None else ZERO256) for c in node.children
        )
    prefix, payload = node.hash_payload()
    return prefix.to_bytes(4, "big") + payload


def serialize_node_wire(node) -> bytes:
    if isinstance(node, Inner):
        if node.branch_count() < 12:
            out = b""
            for i, c in enumerate(node.children):
                if c is not None:
                    out += c._hash + bytes([i])
            return out + bytes([_WIRE_INNER_COMPRESSED])
        return (
            b"".join((c._hash if c is not None else ZERO256) for c in node.children)
            + bytes([_WIRE_INNER_FULL])
        )
    item, t = node.item, node.type
    if t == TNType.TX_NM:
        return item.data + bytes([_WIRE_TX_NM])
    trailer = _WIRE_STATE if t == TNType.ACCOUNT_STATE else _WIRE_TX_MD
    return item.data + item.tag + bytes([trailer])


# process-wide memo of deserialized-and-resolved nodes, keyed by node
# hash (content-addressed, so sharing across stores and trees is always
# sound): the byte-bounded, epoch-aware HotNodeCache (state/hotcache.py).
# For lazy trees it IS the resident hot set ([tree] cache_mb) and its
# fault counters are the out-of-core evidence in
# get_counts.shamap_inner_cache; for the eager from_store path a hit
# returns a whole resolved subtree in O(1), and those entries ride the
# cache's EAGER_ENTRY_CAP count bound.
_INNER_CACHE = None


def inner_node_cache():
    global _INNER_CACHE
    if _INNER_CACHE is None:
        from .hotcache import HotNodeCache

        _INNER_CACHE = HotNodeCache("shamap_inners")
    return _INNER_CACHE


def configure_inner_cache(cache_mb: int) -> None:
    """Apply the `[tree] cache_mb` budget (node setup)."""
    inner_node_cache().set_limit(max(1, int(cache_mb)) << 20)


class InnerStub:
    """Parse-time placeholder: an inner node known only by child hashes.
    Resolved against a fetch source when the tree is materialized."""

    __slots__ = ("child_hashes",)

    def __init__(self, child_hashes: list[bytes]):
        self.child_hashes = child_hashes


def deserialize_node_prefix(blob: bytes):
    """Parse a NodeStore/prefix-format node → Leaf | InnerStub
    (reference: SHAMapTreeNode ctor, snfPREFIX arm)."""
    if len(blob) < 4:
        raise ValueError("short node blob")
    prefix = int.from_bytes(blob[:4], "big")
    body = blob[4:]
    if prefix == HP_INNER_NODE:
        if len(body) != 512:
            raise ValueError(f"bad inner node length {len(body)}")
        return InnerStub([body[i * 32 : (i + 1) * 32] for i in range(16)])
    if prefix == HP_TXN_ID:
        item = SHAMapItem(prefix_hash(HP_TXN_ID, body), body)
        return Leaf(item, TNType.TX_NM)
    if prefix == HP_TX_NODE:
        item = SHAMapItem(body[-32:], body[:-32])
        return Leaf(item, TNType.TX_MD)
    if prefix == HP_LEAF_NODE:
        item = SHAMapItem(body[-32:], body[:-32])
        return Leaf(item, TNType.ACCOUNT_STATE)
    raise ValueError(f"unknown node prefix {prefix:#x}")


def deserialize_node_wire(blob: bytes):
    """Parse a wire-format node (reference: SHAMapTreeNode ctor, snfWIRE)."""
    if not blob:
        raise ValueError("empty node blob")
    trailer, body = blob[-1], blob[:-1]
    if trailer == _WIRE_INNER_FULL:
        if len(body) != 512:
            raise ValueError("bad full inner length")
        return InnerStub([body[i * 32 : (i + 1) * 32] for i in range(16)])
    if trailer == _WIRE_INNER_COMPRESSED:
        if len(body) % 33:
            raise ValueError("bad compressed inner length")
        hashes = [ZERO256] * 16
        for i in range(0, len(body), 33):
            branch = body[i + 32]
            if branch >= 16:
                raise ValueError(f"bad branch index {branch}")
            hashes[branch] = body[i : i + 32]
        return InnerStub(hashes)
    if trailer == _WIRE_TX_NM:
        return Leaf(SHAMapItem(prefix_hash(HP_TXN_ID, body), body), TNType.TX_NM)
    if trailer == _WIRE_STATE:
        return Leaf(SHAMapItem(body[-32:], body[:-32]), TNType.ACCOUNT_STATE)
    if trailer == _WIRE_TX_MD:
        return Leaf(SHAMapItem(body[-32:], body[:-32]), TNType.TX_MD)
    raise ValueError(f"unknown wire trailer {trailer}")


# --------------------------------------------------------------------------


class SHAMap:
    """Mutable handle over a persistent radix tree.

    Mirrors the reference SHAMap surface (src/ripple_app/shamap/SHAMap.h):
    add/update/del items, hash, snapshot, compare, flush to a NodeStore,
    rebuild from a NodeStore by root hash.
    """

    def __init__(self, leaf_type: TNType = TNType.ACCOUNT_STATE, root=None,
                 hash_batch: Callable = _default_hasher,
                 source: Optional[NodeSource] = None):
        self.leaf_type = leaf_type
        self.root = root if root is not None else EMPTY_INNER
        self.hash_batch = hash_batch
        # non-None marks a lazy tree (out-of-core faulting): descents may
        # hit Stub slots, which every traversal resolves on the way down
        self._source = source

    # -- queries ----------------------------------------------------------

    def get(self, key: bytes) -> Optional[SHAMapItem]:
        return _get(self.root, key, 0)

    def get_leaf(self, key: bytes) -> Optional[Leaf]:
        """Typed leaf lookup, O(depth)."""
        node, depth = self.root, 0
        while node is not None:
            node = _resolve(node)
            if isinstance(node, Leaf):
                return node if node.item.tag == key else None
            node = _step(node, _nibble(key, depth))
            depth += 1
        return None

    def __contains__(self, key: bytes) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return sum(1 for _ in _walk_leaves(self.root))

    def items(self) -> Iterator[SHAMapItem]:
        for leaf in _walk_leaves(self.root):
            yield leaf.item

    def leaves(self) -> Iterator[Leaf]:
        """Typed leaves in key order (callers that must distinguish raw-tx
        vs tx+metadata items, reference visitLeaves)."""
        yield from _walk_leaves(self.root)

    def peek_first_item(self) -> Optional[SHAMapItem]:
        for leaf in _walk_leaves(self.root):
            return leaf.item
        return None

    def succ(self, key: bytes) -> Optional[SHAMapItem]:
        """First item with tag strictly greater than `key` (reference:
        SHAMap::peekNextItem — order-book/directory iteration). Key-guided
        descent, O(depth): at each inner node, recurse into the key's own
        branch first, then scan higher branches for their smallest leaf."""

        def smallest(node) -> Optional[SHAMapItem]:
            node = _resolve(node)
            while isinstance(node, Inner):
                node = _resolve(
                    next((c for c in node.children if c is not None), None)
                )
            return node.item if node is not None else None

        def descend(node, depth) -> Optional[SHAMapItem]:
            node = _resolve(node)
            if node is None:
                return None
            if isinstance(node, Leaf):
                return node.item if node.item.tag > key else None
            b = _nibble(key, depth)
            found = descend(_step(node, b), depth + 1)
            if found is not None:
                return found
            for c in node.children[b + 1 :]:
                if c is not None:
                    return smallest(c)
            return None

        return descend(self.root, 0)

    # -- mutation ---------------------------------------------------------

    def set_item(self, item: SHAMapItem, leaf_type: Optional[TNType] = None) -> None:
        leaf = Leaf(item, leaf_type or self.leaf_type)
        self.root = _set_item(self.root, item.tag, leaf, 0)

    def del_item(self, key: bytes) -> None:
        root = _del_item(self.root, key, 0)
        self.root = self._normalize_root(root)

    def bulk_update(self, sets=(), deletes=(),
                    leaf_type: Optional[TNType] = None,
                    missing_ok: bool = False) -> int:
        """Apply a whole write set in ONE key-sorted DFS pass: `sets` are
        SHAMapItems (replace-or-insert), `deletes` are keys (KeyError if
        missing — del_item parity). Shared path prefixes are copied once
        instead of once per write, which is what makes a close's spliced
        delta O(distinct dirty nodes) instead of O(writes x depth).

        Byte-contract: the resulting root (and hash) is identical to
        applying the same final key->value map through per-key
        set_item/del_item in any order — the tree is canonical in the
        final key set. A key in both `sets` and `deletes` is a caller
        bug (ValueError); duplicate keys within `sets` keep the LAST
        item. With `missing_ok`, deletes of keys absent from the tree
        are dropped instead of raising (a compacted create-then-delete
        nets to nothing). Returns the number of distinct keys applied."""
        lt = leaf_type or self.leaf_type
        ops: dict[bytes, Optional[Leaf]] = {}
        for item in sets:
            ops[item.tag] = Leaf(item, lt)
        for key in deletes:
            if ops.get(key) is not None:
                raise ValueError(
                    f"key {key.hex()[:16]} in both sets and deletes"
                )
            if missing_ok and self.get(key) is None:
                continue
            ops[key] = None
        if not ops:
            return 0
        sorted_ops = sorted(ops.items())
        merge_c = _resolve_native_merge()
        if merge_c is not None:
            # every tree takes the stub door, not only one with a source:
            # a building tree over a lazy root has none and holds stubs
            root = merge_c(self.root, sorted_ops, Leaf, Inner, Stub)
        else:
            dels = [0] * (len(sorted_ops) + 1)
            for i, (_k, leaf) in enumerate(sorted_ops):
                dels[i + 1] = dels[i] + (leaf is None)
            root = _bulk_merge(self.root, sorted_ops, 0, len(sorted_ops), 0, dels)
        self.root = self._normalize_root(root)
        return len(ops)

    @staticmethod
    def _normalize_root(root):
        """The tree root is always an inner node (reference keeps a root
        inner even for a single item)."""
        if root is None:
            return EMPTY_INNER
        if isinstance(root, Leaf):
            children = [None] * 16
            children[_nibble(root.item.tag, 0)] = root
            return Inner(tuple(children))
        return root

    # -- hashing / snapshots ---------------------------------------------

    def get_hash(self) -> bytes:
        if isinstance(self.root, Inner) and self.root.is_empty():
            return ZERO256
        if self.root._hash is None:
            compute_hashes(self.root, self.hash_batch)
        return self.root._hash

    def snapshot(self) -> "SHAMap":
        """O(1) immutable snapshot: share the persistent root."""
        return SHAMap(self.leaf_type, self.root, self.hash_batch,
                      source=self._source)

    def compare(self, other: "SHAMap", limit: int = 2**31) -> dict[bytes, tuple]:
        """Key → (this_item|None, other_item|None) for keys that differ
        (reference: SHAMapDelta.cpp SHAMap::compare). Shared subtrees are
        skipped by object identity / node hash, so the cost is proportional
        to the delta, not the tree."""
        delta: dict[bytes, tuple] = {}

        def same(a, b) -> bool:
            if a is b:
                return True
            if a is None or b is None:
                return False
            return a._hash is not None and a._hash == b._hash

        def items_of(node) -> Optional[dict]:
            """A leaf's or an empty slot's items; None for an inner."""
            if node is None:
                return {}
            if isinstance(node, Leaf):
                return {node.item.tag: node.item}
            return None

        def walk(a, b):
            if len(delta) > limit or same(a, b):
                return
            # resolve only AFTER the hash short-circuit: shared subtrees
            # (stub vs anything carrying the same hash) never fault
            a, b = _resolve(a), _resolve(b)
            a_items, b_items = items_of(a), items_of(b)
            if a_items is not None or b_items is not None:
                if a_items is None:
                    a_items = {leaf.item.tag: leaf.item for leaf in _walk_leaves(a)}
                if b_items is None:
                    b_items = {leaf.item.tag: leaf.item for leaf in _walk_leaves(b)}
                for tag in set(a_items) | set(b_items):
                    ia, ib = a_items.get(tag), b_items.get(tag)
                    if ia != ib:
                        delta[tag] = (ia, ib)
                return
            for ca, cb in zip(a.children, b.children):
                walk(ca, cb)

        walk(self.root, other.root)
        if len(delta) > limit:
            raise ValueError("delta exceeds limit")
        return delta

    # -- NodeStore integration -------------------------------------------

    # encode-and-store chunk size: bounds the shared buffer so flushing
    # a whole genesis tree never materializes the full serialization
    FLUSH_CHUNK = 8192

    def flush(self, store: Callable[[bytes, bytes], None],
              known: Optional[set] = None,
              store_many: Optional[Callable[[list], None]] = None,
              store_packed: Optional[Callable] = None) -> int:
        """Hash everything, then persist every node the target store does
        not yet have, as (hash → prefix-format blob). Returns the number of
        nodes written.

        `known` is the per-store set of already-flushed hashes (e.g.
        nodestore.Database.flushed); a hash in `known` seals its whole
        subtree (flush adds bottom-up), so shared subtrees across ledger
        versions are skipped and the write cost per close is proportional
        to the delta, not total state. The set is per-store — flushing the
        same tree into a second store writes everything again there
        (the reference's flushDirty dirty-list behaves the same way). A
        lazy tree's clean subtrees whose source is backed by the target
        store (the source's `known` IS `known`) are skipped without
        faulting; flushing into another store faults and writes them.

        The write set serializes through the flat-buffer node encoder
        (the same encoding the hash plane consumes — a prefix-format
        blob IS the hashed byte sequence). With `store_many` (a batch
        sink, e.g. Database.store_many_fn) each chunk lands in the store
        in one call; with `store_packed` (the flat-buffer sink,
        Database.store_packed_fn) the encoded chunk is handed through
        AS-IS — (hashes, buf, offsets) — which a log-structured backend
        turns into one contiguous segment append.
        """
        self.get_hash()
        if known is None:
            known = set()
        nodes: list = []

        def visit(node):
            if node is None or node._hash in known:
                return
            # lazy subtrees: a stub or faulted-but-clean node whose
            # source is backed by THIS store ("known" is the source's
            # own flushed set) is already durably present — skip the
            # whole subtree without faulting it. Flushing into a
            # DIFFERENT store materializes and writes as usual.
            src = getattr(node, "source", None)
            if src is not None and src.known is known:
                return
            if type(node) is Stub:
                node = node.source.load(node._hash)
            if isinstance(node, Inner):
                for c in node.children:
                    visit(c)
            nodes.append(node)  # post-order: children land before parents

        if not (isinstance(self.root, Inner) and self.root.is_empty()):
            visit(self.root)
        for start in range(0, len(nodes), self.FLUSH_CHUNK):
            chunk = nodes[start : start + self.FLUSH_CHUNK]
            buf, offsets = encode_nodes(chunk)
            if store_packed is not None:
                store_packed([node._hash for node in chunk], buf, offsets)
            elif store_many is not None:
                store_many([
                    (node._hash, buf[offsets[i] : offsets[i + 1]])
                    for i, node in enumerate(chunk)
                ])
            else:
                for i, node in enumerate(chunk):
                    store(node._hash, buf[offsets[i] : offsets[i + 1]])
            # mark flushed only AFTER the store accepted the chunk: a
            # failing store must leave the flush retryable, never a
            # known-set claiming nodes the backend never saw
            known.update(node._hash for node in chunk)
        return len(nodes)

    @classmethod
    def from_store(
        cls,
        root_hash: bytes,
        fetch: Callable[[bytes], Optional[bytes]],
        leaf_type: TNType = TNType.ACCOUNT_STATE,
        hash_batch: Callable = _default_hasher,
        verify: bool = True,
        use_cache: bool = True,
        lazy: bool = False,
        store_known: Optional[set] = None,
        cold: bool = False,
    ) -> "SHAMap":
        """Materialize a full tree from a content-addressed store
        (reference: SHAMap fetchNodeExternal path). Raises
        MissingNodeError (a KeyError) on a missing node and, with `verify`
        (default), ValueError when a fetched blob does not hash to its key
        (the reference verifies fetched nodes the same way, SHAMapTreeNode
        ctor hashValid path).

        With `use_cache` (default), resolved inner nodes memoize in the
        process-wide `inner_node_cache()` keyed by node hash — a hit
        returns a whole already-verified subtree, so materializing
        successive ledgers of a chain re-parses only what the cache no
        longer holds. Nodes are immutable + content-addressed, which is
        what makes the sharing sound across stores and trees.

        With `lazy` (the out-of-core plane), only the ROOT node is
        fetched now; every child slot is a hash-only Stub that faults
        from the store through the bounded hot-node cache on first
        descent, and a missing or corrupt node raises then. Opening a
        million-account ledger is O(1); walks, succ cursors, bulk_update
        and the delta-replay splice fault on demand, byte-identical to
        the eager tree. `store_known` identifies the backing store (the
        Database's `flushed` set) so flushing back into the same store
        never faults clean subtrees just to re-write them; `cold` enters
        the faults into the hot cache one epoch behind (a history
        read)."""
        if root_hash == ZERO256:
            return cls(leaf_type, EMPTY_INNER, hash_batch)
        if lazy:
            source = NodeSource(fetch, verify=verify, known=store_known,
                                cold=cold)
            root = source.load(root_hash)
            if isinstance(root, Leaf):
                children = [None] * 16
                children[_nibble(root.item.tag, 0)] = root
                root = Inner(tuple(children))
            return cls(leaf_type, root, hash_batch, source=source)
        cache = inner_node_cache() if use_cache else None

        def load(h: bytes):
            if cache is not None:
                hit = cache.get(h)
                # only a whole resolved Inner or a leaf may enter an
                # EAGER tree: a LazyInner hit (faulted by the out-of-core
                # plane) has stubs below it, and eager trees (source=None)
                # promise stub-free structure
                if type(hit) is Inner or type(hit) is Leaf:
                    return hit
            blob = fetch(h)
            if blob is None:
                raise MissingNodeError(f"missing node {h.hex()}")
            node = deserialize_node_prefix(blob)
            if verify:
                # prefix-format blob == exactly the hashed bytes
                actual = sha512_half(blob)
                if actual != h:
                    raise ValueError(
                        f"node content hash mismatch: key {h.hex()[:16]} "
                        f"content {actual.hex()[:16]}"
                    )
            if isinstance(node, InnerStub):
                children = tuple(
                    load(ch) if ch != ZERO256 else None for ch in node.child_hashes
                )
                node = Inner(children, hash=h)
                if cache is not None:
                    # eager: this entry pins its whole materialized
                    # subtree, so it rides the EAGER_ENTRY_CAP count
                    # bound, not the per-node byte budget
                    cache.put(h, node, eager=True)
            else:
                node._hash = h
            return node

        root = load(root_hash)
        if isinstance(root, Leaf):
            children = [None] * 16
            children[_nibble(root.item.tag, 0)] = root
            root = Inner(tuple(children))
        return cls(leaf_type, root, hash_batch)
