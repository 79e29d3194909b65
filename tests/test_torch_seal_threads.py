"""One CudaHasher, several trees in flight: the default close's seal.

The close hashes its tx tree and its state tree on two helper threads
while the seal drainer pre-hashes the next ledger's building tree, all
through the chain's one CudaHasher. Here (device="cpu": the plain
versions of K2/K3) three threads hash at once — disjoint trees, and
trees that share unhashed subtrees, as the building tree and the
adopted state tree do — and every root must equal hashlib's, with
exactly one readback per device-hashed tree. Then the LedgerMaster's
helpers: which threads hash, and that an error from the card on the
drainer or a seal thread fails the next close while any other error is
counted and absorbed.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading

import pytest

from stellard_tpu.node.ledgermaster import LedgerMaster as JaxLedgerMaster
from stellard_tpu.protocol.sttx import SerializedTransaction as JaxSTTx
from stellard_tpu.engine.engine import TxParams as JaxTxParams
from stellard_tpu_torch.crypto.backend import CudaHasher, TransferMeter
from stellard_tpu_torch.engine.engine import TxParams
from stellard_tpu_torch.node.ledgermaster import LedgerMaster
from stellard_tpu_torch.node.node import build_tx_rows
from stellard_tpu_torch.ops import treehash
from stellard_tpu_torch.ops.build import KernelError, is_device_error
from stellard_tpu_torch.protocol.formats import TxType
from stellard_tpu_torch.protocol.keys import KeyPair
from stellard_tpu_torch.protocol.sfields import sfAmount, sfDestination
from stellard_tpu_torch.protocol.stamount import STAmount
from stellard_tpu_torch.protocol.sttx import SerializedTransaction
from stellard_tpu_torch.state.shamap import SHAMap, SHAMapItem, TNType

MASTER = KeyPair.from_passphrase("masterpassphrase")
OPEN = TxParams.OPEN_LEDGER | TxParams.RETRY


def key(tag: str, i: int) -> bytes:
    return hashlib.sha256(f"{tag}:{i}".encode()).digest()


def items(tag: str, n: int, size=lambda i: 110 + i % 21):
    return [SHAMapItem(key(tag, i), (hashlib.sha512(key(tag, -i)).digest() * 40)[: size(i)])
            for i in range(n)]


def _rehash(leaf_type, root) -> bytes:
    """The same tree's root by hashlib alone: its leaves in a fresh map
    sealed by SHAMap's default hasher."""
    m = SHAMap(leaf_type)
    m.bulk_update([leaf.item for leaf in SHAMap(leaf_type, root).leaves()])
    return m.get_hash()


def hash_in_threads(hasher, maps) -> None:
    """Every map's tree through ``hasher.hash_tree``, one thread each,
    started together."""
    gate = threading.Barrier(len(maps))
    errors = []

    def run(m):
        gate.wait()
        try:
            hasher.hash_tree(m.root)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(m,)) for m in maps]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert errors == []


def test_three_disjoint_trees_in_flight_match_hashlib():
    hasher = CudaHasher(device="cpu")
    # a state tree, a tx tree whose leaves span the block ladder (and a
    # few past it, which the host hashes), and a small third tree
    state = SHAMap(TNType.ACCOUNT_STATE)
    state.bulk_update(items("s", 1500))
    txs = SHAMap(TNType.TX_MD)
    txs.bulk_update(items("t", 400, size=lambda i: 300 + 7 * i if i % 50 else 2200))
    small = SHAMap(TNType.ACCOUNT_STATE)
    small.bulk_update(items("x", 40))
    maps = [state, txs, small]
    for rnd in range(3):
        hash_in_threads(hasher, maps)
        for m in maps:
            assert m.root._hash == _rehash(m.leaf_type, m.root)
        # the next round re-hashes only each tree's new paths
        for m, tag in zip(maps, "stx"):
            m.bulk_update(items(f"{tag}{rnd}", 60))
    assert hasher.tree_transfers.readbacks == hasher.tree_calls == 9
    assert hasher.host_nodes >= 8  # the leaves past the ladder, hashed on the host
    tj = hasher.transfer_json()
    assert tj["readbacks"] == hasher.tree_transfers.readbacks + hasher.transfers.readbacks
    assert set(hasher.last_tree_ms) == {"plan", "stage", "readback", "write_back"}


def test_trees_sharing_unhashed_subtrees_in_flight():
    """A building tree and the state tree adopted from it share unhashed
    nodes: both threads may hash a shared node, and each writes the same
    digest into its write-once slot."""
    hasher = CudaHasher(device="cpu")
    for rnd in range(4):
        base = SHAMap(TNType.ACCOUNT_STATE)
        base.bulk_update(items(f"b{rnd}", 1200))
        a = base.snapshot()
        b = base.snapshot()
        b.bulk_update(items(f"d{rnd}", 30), [key(f"b{rnd}", i) for i in range(0, 1200, 97)])
        c = b.snapshot()
        c.bulk_update(items(f"e{rnd}", 10))
        hash_in_threads(hasher, [a, b, c])
        for m in (a, b, c):
            assert m.root._hash == _rehash(m.leaf_type, m.root)
    assert hasher.tree_transfers.readbacks == hasher.tree_calls == 12


def test_meters_and_launch_counts_are_exact_from_many_threads():
    """More threads than cores, the interpreter switching threads every
    microsecond: a lost read-modify-write update would show."""
    meter = TransferMeter()
    treehash.reset_launches()
    n_threads = 2 * (os.cpu_count() or 4)
    per_thread = 20000
    gate = threading.Barrier(n_threads)

    def work():
        gate.wait()
        for _ in range(per_thread):
            meter.up(3)
            meter.down(5)
            treehash._count("sha512_masked")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, name=f"w{i}") for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    n = per_thread * n_threads
    j = meter.get_json()
    assert (j["uploads"], j["readbacks"], j["bytes_up"], j["bytes_down"]) == (n, n, 3 * n, 5 * n)
    assert treehash.launches["sha512_masked"] == n
    assert {name: per["sha512_masked"] for name, per in treehash.launches_by_thread.items()} == {
        f"w{i}": per_thread for i in range(n_threads)}
    treehash.reset_launches()
    assert treehash.launches == {"sha512_masked": 0, "tree_inner_level": 0}
    assert treehash.launches_by_thread == {}


class ThreadLog(CudaHasher):
    """CudaHasher keeping the name of each thread that hashed a tree,
    and raising ``fail[name]`` (an exception) on a thread of that name."""

    def __init__(self, fail=None):
        super().__init__(device="cpu")
        self.threads: list[str] = []
        self.fail = dict(fail or {})

    def hash_tree(self, root):
        name = threading.current_thread().name
        self.threads.append(name)
        exc = self.fail.get(name)
        if exc is not None:
            raise exc
        return super().hash_tree(root)


def payments(n: int, start: int = 1) -> list[bytes]:
    out = []
    for i in range(n):
        tx = SerializedTransaction.build(
            TxType.ttPAYMENT, MASTER.account_id, start + i, 10,
            {sfAmount: STAmount.from_drops(300_000_000),
             sfDestination: KeyPair.from_passphrase(f"st-{i % 5}").account_id})
        tx.sign(MASTER)
        out.append(tx.serialize())
    return out


def jax_hashes(rounds: list[list[bytes]]) -> list[bytes]:
    lm = JaxLedgerMaster()
    lm.start_new_ledger(MASTER.account_id, close_time=1000)
    out = []
    for k, blobs in enumerate(rounds):
        for blob in blobs:
            lm.do_transaction(JaxSTTx.from_bytes(blob), JaxTxParams.OPEN_LEDGER | JaxTxParams.RETRY)
        out.append(lm.close_and_advance(2000 + 30 * k, 30)[0].hash())
    lm.stop_seal_drainer()
    return out


def chain(hasher) -> LedgerMaster:
    lm = LedgerMaster(hash_batch=hasher)
    lm.persist_prep = build_tx_rows
    lm.seal_drain_batch = 2
    lm.start_new_ledger(MASTER.account_id, close_time=1000)
    return lm


def submit(lm, blobs) -> None:
    for blob in blobs:
        _ter, ok = lm.do_transaction(SerializedTransaction.from_bytes(blob), OPEN)
        assert ok
    lm.kick_seal_drain(wait_s=60)


def test_the_close_hashes_on_the_drainer_and_two_seal_threads():
    rounds = [payments(12), payments(12, start=13)]
    hasher = ThreadLog()
    lm = chain(hasher)
    got = []
    for k, blobs in enumerate(rounds):
        submit(lm, blobs)
        ledger, _results = lm.close_and_advance(2000 + 30 * k, 30)
        got.append(ledger.hash())
        assert ledger.persist_rows is not None and len(ledger.persist_rows) == 12
    lm.stop_seal_drainer()
    assert got == jax_hashes(rounds)
    assert {"seal-drain", "seal-hash-tx", "seal-hash-state"} <= set(hasher.threads)
    tree = lm.tree_json()
    assert tree["drains"] >= 2 and tree["drained_nodes"] > 0
    assert tree["seal_adopted"] == 2
    assert all(tree[k] == 0 for k in ("drain_errors", "seal_thread_errors",
                                      "persist_prep_errors", "fold_errors", "spec_errors",
                                      "adopt_errors"))
    assert hasher.tree_transfers.readbacks == hasher.tree_calls


def test_four_chains_close_at_once_on_one_hasher():
    """The consensus phase's concurrency, and more: four validators'
    LedgerMasters on one CudaHasher, each with its drainer and its two
    seal threads, closing at the same time (up to twelve threads hashing
    at once): every ledger equal to the JAX close's, one readback a
    tree."""
    rounds = [payments(12), payments(12, start=13)]
    hasher = ThreadLog()
    lms = [chain(hasher) for _ in range(4)]
    got = [[] for _ in lms]
    errors = []
    gate = threading.Barrier(len(lms))

    def run(lm, out):
        try:
            for k, blobs in enumerate(rounds):
                submit(lm, blobs)
                gate.wait()
                out.append(lm.close_and_advance(2000 + 30 * k, 30)[0].hash())
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(lm, out)) for lm, out in zip(lms, got)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    for lm in lms:
        lm.stop_seal_drainer()
    assert errors == []
    assert got == [jax_hashes(rounds)] * 4
    assert {"seal-drain", "seal-hash-tx", "seal-hash-state"} <= set(hasher.threads)
    assert hasher.tree_transfers.readbacks == hasher.tree_calls
    assert all(lm.tree_json()[k] == 0 for lm in lms
               for k in ("drain_errors", "seal_thread_errors", "adopt_errors"))


@pytest.mark.parametrize("thread", ["seal-drain", "seal-hash-tx", "seal-hash-state"])
def test_an_error_from_the_card_fails_the_next_close(thread):
    """A kernel that fails on a helper thread is not hidden behind the
    host's recomputation: the close raises it (the drainer's at the next
    close, a seal thread's at its own)."""
    lm = chain(ThreadLog(fail={thread: KernelError("sha512_masked: CUDA error 700 at launch")}))
    submit(lm, payments(6))
    try:
        with pytest.raises(KernelError):
            lm.close_and_advance(2000, 30)
        counter = "drain_errors" if thread == "seal-drain" else "seal_thread_errors"
        assert lm.tree_json()[counter] >= 1
    finally:
        lm.stop_seal_drainer()


@pytest.mark.parametrize("thread", ["seal-drain", "seal-hash-tx", "seal-hash-state"])
def test_any_other_helper_error_is_counted_and_absorbed(thread):
    rounds = [payments(6)]
    lm = chain(ThreadLog(fail={thread: ValueError("not from the card")}))
    submit(lm, rounds[0])
    ledger, _results = lm.close_and_advance(2000, 30)
    lm.stop_seal_drainer()
    assert [ledger.hash()] == jax_hashes(rounds)
    counter = "drain_errors" if thread == "seal-drain" else "seal_thread_errors"
    assert lm.tree_json()[counter] >= 1


def test_device_errors_are_told_apart():
    assert is_device_error(KernelError("tree_inner_level: CUDA error 1 at launch"))
    assert is_device_error(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not is_device_error(ValueError("bad input"))
    assert not is_device_error(RuntimeError("an unhashed child is missing from the level below"))
