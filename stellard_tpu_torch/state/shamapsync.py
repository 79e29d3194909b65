"""SHAMap network synchronization: incremental acquisition of a tree by
root hash, and fetch-pack production/consumption for fast catch-up.

Reference: src/ripple_app/shamap/SHAMapSync.cpp (getMissingNodes,
addKnownNode, getFetchPack) and the fetch-pack tests
(FetchPackTests.cpp). Every arriving node blob is verified against the
hash that named it before it is attached — a malicious peer cannot graft
bad state.

Device shape: verification of arriving node blobs is batched SHA-512 —
an acquisition burst of N nodes is one hasher call, not N host hashes.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence

from ..utils.hashes import sha512_half
from .shamap import (
    SHAMap,
    TNType,
    ZERO256,
    deserialize_node_prefix,
    serialize_node_prefix,
    InnerStub,
)

__all__ = ["SHAMapNodeID", "IncompleteMap", "make_fetch_pack", "FetchPack"]


class SHAMapNodeID:
    """Position of a node in the tree: nibble path + depth
    (reference: SHAMapNodeID — 33-byte wire encoding, 32-byte padded
    path then a depth byte)."""

    __slots__ = ("path", "depth")

    def __init__(self, path: bytes = b"", depth: int = 0):
        # path holds ceil(depth/2) meaningful nibbles
        self.path = path
        self.depth = depth

    @classmethod
    def root(cls) -> "SHAMapNodeID":
        return cls(b"", 0)

    def child(self, branch: int) -> "SHAMapNodeID":
        nibbles = [self._nibble(i) for i in range(self.depth)] + [branch]
        raw = bytearray((len(nibbles) + 1) // 2)
        for i, nb in enumerate(nibbles):
            raw[i // 2] |= nb << (4 if i % 2 == 0 else 0)
        return SHAMapNodeID(bytes(raw), self.depth + 1)

    def _nibble(self, i: int) -> int:
        byte = self.path[i // 2]
        return (byte >> 4) if i % 2 == 0 else (byte & 0x0F)

    def nibbles(self) -> list[int]:
        return [self._nibble(i) for i in range(self.depth)]

    def encode(self) -> bytes:
        """33-byte wire form: zero-padded path ‖ depth."""
        return self.path.ljust(32, b"\x00") + bytes([self.depth])

    @classmethod
    def decode(cls, blob: bytes) -> "SHAMapNodeID":
        if len(blob) != 33:
            raise ValueError("bad node id")
        depth = blob[32]
        if depth > 64:
            raise ValueError("bad node depth")
        return cls(blob[: (depth + 1) // 2], depth)

    def __eq__(self, other):
        return (
            isinstance(other, SHAMapNodeID)
            and self.depth == other.depth
            and self.nibbles() == other.nibbles()
        )

    def __hash__(self):
        return hash((self.depth, tuple(self.nibbles())))

    def __repr__(self):
        return f"NodeID({''.join(f'{n:x}' for n in self.nibbles())}@{self.depth})"


class IncompleteMap:
    """A tree being synchronized from the network, identified by its root
    hash. Feed it `(node_id, blob)` pairs (from LedgerData replies or a
    fetch pack); ask it for `missing_nodes()` to request next. Blobs are
    prefix-format (the hashed byte sequence), so verification is
    `sha512_half(blob) == expected-hash-at-position`.
    """

    def __init__(self, root_hash: bytes, leaf_type: TNType = TNType.ACCOUNT_STATE,
                 hash_many: Optional[Callable[[Sequence[bytes]], list]] = None):
        self.root_hash = root_hash
        self.leaf_type = leaf_type
        self.hash_many = hash_many  # batched SHA-512-half over blobs
        self.nodes: dict[bytes, bytes] = {}  # node hash -> blob
        # node hash -> [(branch, child_hash)] (for parsed inners)
        self._children: dict[bytes, list[tuple[int, bytes]]] = {}
        # incremental frontier: position -> expected hash. Maintained by
        # _attach so progress queries never re-walk the whole tree (an
        # acquisition is O(nodes), not O(nodes²))
        self._missing: dict[SHAMapNodeID, bytes] = {}
        self._missing_by_hash: dict[bytes, set[SHAMapNodeID]] = {}
        if root_hash != ZERO256:
            self._note_missing(SHAMapNodeID.root(), root_hash)

    def _note_missing(self, nid: SHAMapNodeID, h: bytes) -> None:
        if h in self.nodes:
            # already have the content — expand straight through it
            for branch, ch in self._children.get(h, ()):
                self._note_missing(nid.child(branch), ch)
        else:
            self._missing[nid] = h
            self._missing_by_hash.setdefault(h, set()).add(nid)

    # -- feeding ----------------------------------------------------------

    def _digest_all(self, blobs: Sequence[bytes]) -> list[bytes]:
        if self.hash_many is not None:
            return list(self.hash_many(blobs))
        return [sha512_half(b) for b in blobs]

    def add_nodes(self, pairs: Sequence[tuple[bytes, bytes]]) -> int:
        """Add `(expected_hash, blob)` pairs; hash verification is one
        batch. Returns how many were new and valid."""
        fresh = [(h, b) for h, b in pairs if h not in self.nodes]
        if not fresh:
            return 0
        digests = self._digest_all([b for _h, b in fresh])
        added = 0
        for (h, blob), actual in zip(fresh, digests):
            if actual != h:
                continue  # corrupted/forged node — drop
            self._attach(h, blob)
            added += 1
        return added

    def add_known_node(self, expected_hash: bytes, blob: bytes) -> bool:
        """Single-node path (reference: addKnownNode)."""
        return self.add_nodes([(expected_hash, blob)]) == 1

    def _attach(self, h: bytes, blob: bytes) -> None:
        self.nodes[h] = blob
        node = deserialize_node_prefix(blob)
        if isinstance(node, InnerStub):
            self._children[h] = [
                (branch, c)
                for branch, c in enumerate(node.child_hashes)
                if c != ZERO256
            ]
        # resolve every frontier position waiting on this hash
        for nid in self._missing_by_hash.pop(h, set()):
            self._missing.pop(nid, None)
            for branch, ch in self._children.get(h, ()):
                self._note_missing(nid.child(branch), ch)

    # -- progress ---------------------------------------------------------

    def missing_nodes(self, limit: int = 256) -> list[tuple[SHAMapNodeID, bytes]]:
        """(node_id, node_hash) pairs we still need — read straight off
        the incrementally-maintained frontier (reference: getMissingNodes,
        which walks; here _attach keeps the frontier current so this is
        O(limit))."""
        out = []
        for nid, h in self._missing.items():
            out.append((nid, h))
            if len(out) >= limit:
                break
        return out

    def is_complete(self) -> bool:
        return not self._missing

    def have_node(self, h: bytes) -> bool:
        return h in self.nodes

    # -- completion -------------------------------------------------------

    def to_shamap(self, hash_batch: Optional[Callable] = None) -> SHAMap:
        assert self.is_complete(), "tree still has missing nodes"
        if hash_batch is not None:
            return SHAMap.from_store(
                self.root_hash, self.nodes.get, self.leaf_type,
                hash_batch, verify=False,  # verified on arrival
            )
        return SHAMap.from_store(
            self.root_hash, self.nodes.get, self.leaf_type, verify=False
        )


# -- fetch packs ----------------------------------------------------------


class FetchPack:
    """A bundle of (hash, blob) node pairs covering a ledger's trees (or
    their delta against a base), used to catch up without per-node
    round-trips (reference: getFetchPack / TMGetObjectByHash pack)."""

    def __init__(self, pairs: Optional[list[tuple[bytes, bytes]]] = None):
        self.pairs = pairs or []

    def __len__(self):
        return len(self.pairs)

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        return iter(self.pairs)


def _walk_nodes(map: SHAMap) -> Iterator[tuple[bytes, bytes]]:
    from .shamap import resolve_node

    map.get_hash()

    def visit(node):
        node = resolve_node(node)  # lazy trees: fault before serving
        if node is None:
            return
        yield node._hash, serialize_node_prefix(node)
        if hasattr(node, "children"):
            for c in node.children:
                yield from visit(c)

    from .shamap import Inner

    if isinstance(map.root, Inner) and map.root.is_empty():
        return
    yield from visit(map.root)


def make_fetch_pack(
    target: SHAMap, base: Optional[SHAMap] = None, max_nodes: int = 65536
) -> FetchPack:
    """All nodes of `target` (minus subtrees shared with `base`, matched
    by node hash — the reference builds packs as the delta against the
    requester's stated ledger)."""
    if base is None:
        pairs = []
        for h, blob in _walk_nodes(target):
            pairs.append((h, blob))
            if len(pairs) >= max_nodes:
                break
        return FetchPack(pairs)

    from .shamap import resolve_node

    base.get_hash()
    base_hashes: set[bytes] = set()

    def collect(node):
        node = resolve_node(node)
        if node is None:
            return
        base_hashes.add(node._hash)
        if hasattr(node, "children"):
            for c in node.children:
                collect(c)

    from .shamap import Inner

    if not (isinstance(base.root, Inner) and base.root.is_empty()):
        collect(base.root)

    target.get_hash()
    pairs: list[tuple[bytes, bytes]] = []

    def visit(node):
        if node is None or node._hash in base_hashes or len(pairs) >= max_nodes:
            return
        node = resolve_node(node)  # hash checks above never fault
        pairs.append((node._hash, serialize_node_prefix(node)))
        if hasattr(node, "children"):
            for c in node.children:
                visit(c)

    if not (isinstance(target.root, Inner) and target.root.is_empty()):
        visit(target.root)
    return FetchPack(pairs)
