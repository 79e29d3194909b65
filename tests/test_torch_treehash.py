"""The port's SHA-512 seal (stellard_tpu_torch.ops.treehash and
CudaHasher.hash_tree, run on the CPU through the kernels' plain
versions) against the JAX package's tree hashing and hashlib.

Everything is integer arithmetic, so every comparison is exact: digest
words, inner-level buffers and tree roots must be equal.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stellard_tpu.crypto.backend import CpuHasher as JaxCpuHasher
from stellard_tpu.crypto.backend import TpuHasher
from stellard_tpu.ops.treehash_jax import inner_level_kernel as jax_inner_level
from stellard_tpu.ops.treehash_jax import pad_leaf_batch as jax_pad_leaf_batch
from stellard_tpu.ops.treehash_jax import sha512_blocks_masked as jax_masked
from stellard_tpu.state.shamap import SHAMap as JaxSHAMap
from stellard_tpu.state.shamap import SHAMapItem as JaxItem
from stellard_tpu_torch.crypto.backend import CpuHasher, CudaHasher, _RowIndex
from stellard_tpu_torch.interop import shamap_from_items
from stellard_tpu_torch.ops import treehash as T
from stellard_tpu_torch.ops.sha512 import (
    digest_to_bytes,
    pad_message_np,
    padded_block_count,
    sha512_blocks,
)
from stellard_tpu_torch.state.shamap import SHAMapItem, TNType
from stellard_tpu_torch.utils.hashes import HP_INNER_NODE


def _messages(ladder: int, n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    hi = ladder * 128 - 17  # the longest message that pads to `ladder`
    lens = rng.integers(0, hi + 1, n)
    lens[0], lens[1] = hi, 0
    return [rng.bytes(int(x)) for x in lens]


@pytest.mark.parametrize("ladder", [2, 4, 8, 16])
def test_masked_sha512_matches_jax_and_hashlib(ladder):
    msgs = _messages(ladder, 12, seed=ladder)
    blocks, nblocks = T.pad_leaf_batch(msgs, ladder)
    jb, jn = jax_pad_leaf_batch(msgs, ladder)  # pads rows to a power of two
    assert np.array_equal(blocks, jb[: len(msgs)])
    assert np.array_equal(nblocks, jn[: len(msgs)])
    got = T.sha512_blocks_masked(torch.from_numpy(blocks), torch.from_numpy(nblocks))
    want = np.asarray(jax_masked(jnp.asarray(jb), jnp.asarray(jn)))[: len(msgs)]
    assert np.array_equal(got.numpy(), want)
    for i, m in enumerate(msgs):
        assert digest_to_bytes(got[i].numpy()) == hashlib.sha512(m).digest()


def test_padding_matches_fips_reference():
    for n in (0, 1, 111, 112, 239, 240, 2031):
        m = bytes(range(256)) * 8
        m = m[:n]
        blocks, nb = T.pad_leaf_batch([m], 16)
        assert nb[0] == pad_message_np(m).shape[0]
        assert np.array_equal(blocks[0, : nb[0]], pad_message_np(m))
        assert not blocks[0, nb[0]:].any()
    with pytest.raises(ValueError):
        T.pad_leaf_batch([bytes(2032)], 16)


def test_plain_sha512_blocks():
    msgs = [bytes([7]) * 516, bytes(516)]
    blocks = torch.from_numpy(np.stack([pad_message_np(m) for m in msgs]))
    st = sha512_blocks(blocks)
    for i, m in enumerate(msgs):
        assert digest_to_bytes(st[i].numpy()) == hashlib.sha512(m).digest()


def test_inner_level_matches_jax():
    rng = np.random.default_rng(9)
    cap, n, off = 64, 12, 40
    buf = rng.integers(0, 2**32, (cap, 8), dtype=np.uint64).astype(np.uint32)
    template = T.build_inner_template(n, HP_INNER_NODE)
    known = rng.integers(0, 2**32, (n, 128), dtype=np.uint64).astype(np.uint32)
    template[:, 1:129] = known
    child_rows = rng.integers(-1, off, (n, 16)).astype(np.int32)
    child_rows[0] = -1  # a node whose children are all known
    got = torch.from_numpy(buf.copy())
    T.tree_inner_level(got, torch.from_numpy(template), torch.from_numpy(child_rows), off)

    # the same level through the JAX program: template plus scatter list
    jt = np.zeros((n + 1, T.INNER_WORDS), np.uint32)
    jt[:n] = template
    rows, cols, srcs = np.nonzero(child_rows >= 0)[0], [], []
    for i, c in zip(*np.nonzero(child_rows >= 0)):
        cols.append(1 + 8 * c)
        srcs.append(child_rows[i, c])
    want = jax_inner_level(
        jnp.asarray(buf), jnp.asarray(jt), jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(np.array(cols, np.int32)), jnp.asarray(np.array(srcs, np.int32)),
        off, n,
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_wrappers_reject_bad_inputs():
    buf = torch.zeros((8, 8), dtype=torch.uint32)
    blocks = torch.zeros((4, 2, 32), dtype=torch.uint32)
    nblocks = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        T.sha512_blocks_masked(blocks.view(torch.int32), nblocks)
    with pytest.raises(ValueError):
        T.sha512_blocks_masked(blocks, nblocks[:3])
    with pytest.raises(ValueError):
        T.tree_leaf_body(buf, blocks, nblocks, 5)  # rows 5..8 overflow
    with pytest.raises(ValueError):
        T.tree_inner_level(buf, torch.zeros((2, 160), dtype=torch.uint32),
                           torch.zeros((2, 15), dtype=torch.int32), 0)


def _items(n: int, seed: int, big_every: int = 0):
    """(key, data) with mixed sizes across the ladder; every big_every-th
    leaf is over the ladder (hashed on the host)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        size = int(rng.integers(20, 1900))
        if big_every and i % big_every == 3:
            size = 2600
        out.append((rng.bytes(32), rng.bytes(size)))
    return out


def _jax_map(items, hasher):
    m = JaxSHAMap()
    m.bulk_update([JaxItem(k, d) for k, d in items])
    m.hash_batch = hasher
    return m


def test_hash_tree_roots_match_jax_and_hashlib():
    items = _items(300, seed=1, big_every=97)
    tpu = _jax_map(items, TpuHasher(mesh="1"))
    ref = _jax_map(items, JaxCpuHasher())
    # the port's trees are read off the JAX tree
    leaves = [(lf.item.tag, lf.item.data, int(lf.type)) for lf in tpu.leaves()]
    hasher = CudaHasher(device="cpu")
    port = shamap_from_items(leaves, hash_batch=hasher)
    host = shamap_from_items(leaves, hash_batch=CpuHasher())
    root = port.get_hash()
    assert root == host.get_hash() == tpu.get_hash() == ref.get_hash()
    assert hasher.host_nodes >= 1  # the oversized leaves
    assert hasher.device_nodes > 250

    # incremental re-seal after a delta: writes, new keys, deletes
    rng = np.random.default_rng(2)
    sets = [(items[i][0], rng.bytes(150)) for i in range(0, 60, 3)]
    sets += [(rng.bytes(32), rng.bytes(int(rng.integers(40, 900)))) for _ in range(15)]
    dels = [items[i][0] for i in range(100, 130, 4)]
    for m, item_cls in ((port, SHAMapItem), (host, SHAMapItem), (tpu, JaxItem)):
        m.bulk_update([item_cls(k, d) for k, d in sets], dels)
    assert port.get_hash() == host.get_hash() == tpu.get_hash()
    assert port.get_hash() != root
    assert hasher.tree_calls == 2
    assert hasher.tree_transfers.readbacks == hasher.tree_calls


def test_transaction_tree_and_flat_batches():
    rng = np.random.default_rng(4)
    items = [(rng.bytes(32), rng.bytes(int(rng.integers(400, 456))), TNType.TX_MD)
             for _ in range(120)]
    items += [(rng.bytes(32), rng.bytes(200), TNType.TX_NM) for _ in range(10)]
    a = shamap_from_items(items, TNType.TX_MD, hash_batch=CudaHasher(device="cpu"))
    b = shamap_from_items(items, TNType.TX_MD, hash_batch=CpuHasher())
    assert a.get_hash() == b.get_hash()

    prefixes = [0x4D494E00, 0x534E4400, 0x54584E00] * 6
    payloads = [rng.bytes(int(rng.integers(10, 2500))) for _ in range(18)]
    h = CudaHasher(device="cpu")
    assert h.prefix_hash_batch(prefixes, payloads) == \
        CpuHasher().prefix_hash_batch(prefixes, payloads)
    assert h.tree_transfers.readbacks == h.tree_calls == 0
    # one launch and one readback per ladder bucket in use
    nbs = [padded_block_count(4 + len(p)) for p in payloads]
    buckets = {next(l for l in T.LEAF_BLOCK_LADDER if nb <= l) for nb in nbs if nb <= 16}
    assert h.transfers.readbacks == len(buckets)
    assert h.host_nodes == sum(nb > 16 for nb in nbs)


def test_row_index_finds_rows_by_node_id():
    nodes = [object() for _ in range(7)]
    order: list = ["earlier"]
    index = _RowIndex()
    assert index.add(order, nodes[:3]) == 1
    assert index.add(order, nodes[3:5]) == 4
    index.sealed()
    ids = np.array([id(n) for n in reversed(nodes)] + [id(None)], np.int64)
    assert index.rows_of(ids).tolist() == [-1, -1, 5, 4, 3, 2, 1, -1]
    assert order[1:] == nodes[:5]
    assert _RowIndex().sealed().rows_of(ids).tolist() == [-1] * 8
