"""The tcp phase's workload (chip_smoke.tcp_workload) through both
packages' standalone node, and the constant chip_smoke.py holds the
card's 4-validator TCP net to.

Over TCP the close times are wall-clock, so which ledger a payment lands
in, and every ledger hash, differs from run to run; the balances and
sequences of the accounts (the master, the 16 destinations, the second
sender) after every good payment do not. The JAX package's Node (host
planes, admission caps that never bind, as the phase's INI has them)
submits the warm-up's funding and every round's good payments in order,
closing after each: every answer tesSUCCESS, and the accounts' digest
is TCP_BALANCES_DIGEST. The port's Node on host planes gives the same
answers and the same digest.

The port's test kit (``testkit/workloads.py``, ``testkit/schedule.py``)
builds the same transactions and fault schedules as the JAX package's
from one seed.
"""

from __future__ import annotations

import pytest

import chip_smoke as cs
from stellard_tpu.node.config import Config as JaxConfig
from stellard_tpu.node.node import Node as JaxNode
from stellard_tpu.protocol.sfields import sfBalance as jax_balance
from stellard_tpu.protocol.sfields import sfSequence as jax_sequence
from stellard_tpu.protocol.sttx import SerializedTransaction as JaxTx
from stellard_tpu_torch.node.node import Node as PortNode
from stellard_tpu_torch.protocol.sfields import sfBalance as port_balance
from stellard_tpu_torch.protocol.sfields import sfSequence as port_sequence
from stellard_tpu_torch.protocol.sttx import SerializedTransaction as PortTx
from test_torch_txq import CpuConfig

SMALL = dict(n_rounds=2, per_round=6, per_relay=5, bad_share=0.5, seed=53)
PACKAGES = {
    "jax": (JaxNode, JaxConfig, JaxTx, jax_balance, jax_sequence),
    "port": (PortNode, CpuConfig, PortTx, port_balance, port_sequence),
}


def batches(wl) -> list:
    """The good payments as the phase submits them: the funding, then a
    round (its door payments, then its relay payments) at a time."""
    return [[wl["fund"]]] + [[g for g, _b in rnd["door"]] + rnd["relay"]
                             for rnd in wl["rounds"]]


def good_blobs(wl) -> list:
    return [b for batch in batches(wl) for b in batch]


def run_payments(pkg: str, wl) -> tuple[dict, str]:
    """Every good payment of ``wl`` through package ``pkg``'s standalone
    node, closing after each funding step and each round; the answers'
    counts and the accounts' balances digest."""
    node_cls, config_cls, tx_cls, sf_balance, sf_sequence = PACKAGES[pkg]
    node = node_cls(config_cls(standalone=True, txq_min_cap=1_000_000,
                               txq_max_cap=1_000_000)).setup()
    answers: dict = {}
    try:
        for batch in batches(wl):
            for blob in batch:
                ter, _applied = node.submit(tx_cls.from_bytes(blob))
                answers[ter.token] = answers.get(ter.token, 0) + 1
            node.close_ledger()
        led = node.ledger_master.closed_ledger()
        rows = []
        for account in wl["accounts"]:
            root = led.account_root(account)
            rows.append((account, 0, 0) if root is None
                        else (account, root[sf_balance].drops(), root[sf_sequence]))
    finally:
        node.stop()
    return answers, cs.balances_digest(rows)


def cs_tx(blob):
    return PortTx.from_bytes(blob)


def test_small_workload_equal_in_both_packages():
    wl = cs.tcp_workload(**SMALL)
    n_bad = sum(b is not None for rnd in wl["rounds"] for _g, b in rnd["door"])
    assert n_bad > 0
    jax, port = run_payments("jax", wl), run_payments("port", wl)
    assert jax == port
    assert jax[0] == {"tesSUCCESS": len(good_blobs(wl))}


def test_workload_shape():
    """The warm-up funds a second sender; each round is 512 of the master
    account's consecutive sequences at the door and 256 of the second
    sender's, relayed; 18 accounts in all."""
    wl = cs.tcp_workload(**cs.TCP_SIZES)
    assert len(wl["rounds"]) == 4 and len(wl["accounts"]) == 1 + 16 + 1
    assert all(len(r["door"]) == 512 and len(r["relay"]) == 256 for r in wl["rounds"])
    master, sender = wl["accounts"][0], wl["sender"]
    fund = cs_tx(wl["fund"])
    assert (fund.account, fund.sequence) == (master, 1)
    door = [cs_tx(g) for r in wl["rounds"] for g, _b in r["door"]]
    relay = [cs_tx(b) for r in wl["rounds"] for b in r["relay"]]
    assert {t.account for t in door} == {master} and {t.account for t in relay} == {sender}
    assert [t.sequence for t in door] == list(range(2, 2 + 4 * 512))
    assert [t.sequence for t in relay] == list(range(1, 1 + 4 * 256))
    n_bad = sum(b is not None for rnd in wl["rounds"] for _g, b in rnd["door"])
    assert 10 <= n_bad <= 40  # ~1% of 2,048


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_full_size_gives_the_smoke_digest(pkg):
    """TCP_BALANCES_DIGEST is what each package's node gives on the
    phase's full workload."""
    wl = cs.tcp_workload(**cs.TCP_SIZES)
    answers, digest = run_payments(pkg, wl)
    print(f"TCP_BALANCES_DIGEST = {digest!r}  # {pkg}")
    assert answers == {"tesSUCCESS": len(good_blobs(wl))}
    assert digest == cs.TCP_BALANCES_DIGEST


@pytest.mark.parametrize("kind", ["payment_flood", "hot_account_flood",
                                  "order_book_crossfire", "fee_gaming"])
def test_testkit_workloads_equal_to_jax(kind):
    """The port's testkit/workloads.py builds, from one seed, the same
    transactions (bytes) at the same steps and origins as the JAX
    package's, for every named workload."""
    import random
    import types

    import stellard_tpu.testkit.workloads as jax_wl
    import stellard_tpu_torch.testkit.workloads as port_wl

    scn = types.SimpleNamespace(steps=40, n_validators=4)
    out = {}
    for name, mod in (("jax", jax_wl), ("port", port_wl)):
        build = mod.build_spec_workload({"kind": kind, "n": 24})
        items = build(mod.TxFactory(seed=7, n_accounts=6), random.Random(11), scn)
        out[name] = [(step, origin, tx.serialize()) for step, origin, tx in items]
    assert out["port"] == out["jax"] and len(out["jax"]) > 24


def test_testkit_schedule_equal_to_jax():
    """The port's fault schedule: the same events, digest and JSON as the
    JAX package's, built from one seed."""
    import stellard_tpu.testkit.schedule as jax_sched
    import stellard_tpu_torch.testkit.schedule as port_sched

    def build(mod):
        s = mod.FaultSchedule(seed=5)
        s.partition(3, [0, 1], [2, 3], heal_at=9).kill(4, 2, revive_at=12)
        s.link_fault(5, 0, 3, drop=0.2, until=15).rotate_kills([1, 2, 3], 10, 6, 3, 30)
        return s

    jax, port = build(jax_sched), build(port_sched)
    assert port.describe() == jax.describe() and port.digest() == jax.digest()
    assert port.to_json() == jax.to_json()
    assert port_sched.FaultSchedule.from_json(jax.to_json()).digest() == jax.digest()
