"""The port's state/ledger.py, state/indexes.py and interop.ledger_from_items
against the JAX package: genesis hash and header bytes, every index
function, and a port ledger rebuilt from a JAX ledger's header fields and
leaves with the same hash. Tolerance: zero, these are bytes.
"""

from __future__ import annotations

import random

import pytest

from stellard_tpu.engine.engine import TxParams as JaxTxParams
from stellard_tpu.node.ledgermaster import LedgerMaster as JaxLedgerMaster
from stellard_tpu.protocol.keys import KeyPair as JaxKeyPair
from stellard_tpu.state import indexes as jix
from stellard_tpu.state.ledger import Ledger as JaxLedger
from stellard_tpu.state.ledger import parse_header as jax_parse_header
from stellard_tpu.testkit.workloads import TxFactory
from stellard_tpu_torch.crypto.backend import CudaHasher
from stellard_tpu_torch.interop import ledger_from_items
from stellard_tpu_torch.state import indexes as tix
from stellard_tpu_torch.state.ledger import Ledger, parse_header, strip_ledger_prefix
from stellard_tpu_torch.utils.hashes import HP_LEDGER_MASTER

ROOT = JaxKeyPair.from_passphrase("masterpassphrase").account_id


@pytest.mark.parametrize("close_time", [0, 1, 530_000_014, 530_000_015, 2**31])
def test_genesis_hash_and_header_equal(close_time):
    j = JaxLedger.genesis(ROOT, close_time=close_time)
    t = Ledger.genesis(ROOT, close_time=close_time)
    for led in (j, t):
        led.close(close_time, 30)
    assert t.header_bytes() == j.header_bytes()
    assert t.hash() == j.hash()
    assert t.close_time == j.close_time == Ledger.round_close_time(close_time, 30)
    assert parse_header(t.header_bytes()) == jax_parse_header(j.header_bytes())
    blob = HP_LEDGER_MASTER.to_bytes(4, "big") + t.header_bytes()
    assert strip_ledger_prefix(blob) == t.header_bytes()
    succ_j, succ_t = j.open_successor(), t.open_successor()
    assert succ_t.parent_hash == succ_j.parent_hash == j.hash()
    assert succ_t.header_bytes() == succ_j.header_bytes()


@pytest.mark.parametrize("t,res", [(0, 30), (14, 30), (15, 30), (44, 10), (7, 1), (99, 120)])
def test_round_close_time_equal(t, res):
    assert Ledger.round_close_time(t, res) == JaxLedger.round_close_time(t, res)


def test_index_functions_equal():
    rng = random.Random(11)
    for _ in range(20):
        a, b = rng.randbytes(20), rng.randbytes(20)
        cur = rng.randbytes(20)
        h = rng.randbytes(32)
        n = rng.randrange(2**64)
        seq = rng.randrange(2**32)
        assert tix.account_root_index(a) == jix.account_root_index(a)
        assert tix.offer_index(a, seq) == jix.offer_index(a, seq)
        assert tix.owner_dir_index(a) == jix.owner_dir_index(a)
        assert tix.ripple_state_index(a, b, cur) == jix.ripple_state_index(a, b, cur)
        assert tix.ripple_state_index(a, b, cur) == tix.ripple_state_index(b, a, cur)
        assert tix.dir_node_index(h, n) == jix.dir_node_index(h, n)
        assert tix.quality_index(h, n) == jix.quality_index(h, n)
        assert tix.get_quality(h) == jix.get_quality(h)
        assert tix.quality_next(h) == jix.quality_next(h)
        assert tix.book_base(cur, a, b, h[:20]) == jix.book_base(cur, a, b, h[:20])
        assert tix.skip_list_index_for(seq) == jix.skip_list_index_for(seq)
    assert tix.fee_index() == jix.fee_index()
    assert tix.amendment_index() == jix.amendment_index()
    assert tix.skip_list_index() == jix.skip_list_index()


def _jax_chain(closes: int) -> JaxLedger:
    """A JAX ledger after `closes` closes of testkit payments from genesis
    (funded accounts, created entries, metadata in its tx map)."""
    fac = TxFactory(seed=9, n_accounts=5)
    lm = JaxLedgerMaster()
    lm.start_new_ledger(fac.master.account_id, close_time=530_000_000)
    mode = JaxTxParams.OPEN_LEDGER | JaxTxParams.RETRY
    try:
        for k in range(closes):
            for i, acct in enumerate(fac.accounts):
                if k == 0:
                    tx = fac.payment(fac.master, acct.account_id, 1_000_000_000)
                else:
                    tx = fac.payment(acct, fac.accounts[(i + k) % 5].account_id, 1_000_000 * (i + 1))
                lm.do_transaction(tx, mode)
            lm.close_and_advance(530_000_000 + 30 * (k + 1), 30)
        return lm.closed_ledger()
    finally:
        lm.stop_seal_drainer()


def _header(led: JaxLedger) -> dict:
    return jax_parse_header(led.header_bytes())


def _leaves(m):
    return [(leaf.item.tag, leaf.item.data, int(leaf.type)) for leaf in m.leaves()]


@pytest.mark.parametrize("hasher", ["default", "cuda-on-cpu"])
def test_ledger_from_items_hash_equal(hasher):
    j = _jax_chain(3)
    hb = CudaHasher(device="cpu") if hasher != "default" else None
    t = ledger_from_items(_header(j), _leaves(j.state_map), _leaves(j.tx_map), hash_batch=hb)
    assert t.state_map.get_hash() == j.state_map.get_hash()
    assert t.tx_map.get_hash() == j.tx_map.get_hash()
    assert t.header_bytes() == j.header_bytes()
    assert t.hash() == j.hash()
    assert sorted(t.tx_entries()) == sorted(j.tx_entries())
    if hb is not None:
        assert hb.tree_calls == hb.tree_transfers.readbacks == 2


def test_ledger_from_items_rejects_a_wrong_root():
    j = _jax_chain(1)
    h = _header(j)
    h["account_hash"] = bytes(32)
    with pytest.raises(ValueError, match="account_hash"):
        ledger_from_items(h, _leaves(j.state_map), _leaves(j.tx_map))


def test_entries_read_equal_and_successor_keeps_the_hasher():
    j = _jax_chain(2)
    hb = CudaHasher(device="cpu")
    t = ledger_from_items(_header(j), _leaves(j.state_map), _leaves(j.tx_map), hash_batch=hb)
    for item in j.state_map.items():
        assert t.read_entry(item.tag).serialize() == j.read_entry(item.tag).serialize()
    succ = t.open_successor()
    assert succ.tx_map.hash_batch is hb and succ.state_map.hash_batch is hb
