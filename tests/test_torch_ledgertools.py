"""The port's offline ledger tools (node/ledgertools.py: dump, transaction
streams, replay) against the JAX package's.

One chain — genesis and four closes of a payment each, signed once and
applied by both packages' LedgerMasters, every ledger saved to each
package's node store — and two ways in, with a tolerance of zero:

- **Port runs of tests/test_ledgertools.py.** Its seven cases run again
  on the port's chain, with the port's dump_ledger, dump_transactions,
  load_transactions, replay_ledger, replay_range and LedgerMaster in their
  names.
- **Outputs paired with the JAX package's.** dump_ledger's JSON,
  dump_transactions' lines, load_transactions' counts, balances and
  hashes, and replay_ledger / replay_range's stats (all but the times)
  equal between the packages: with spy verifiers, and with the port's
  VerifyPlane and CudaHasher on the CPU (K1, K2 and K3's plain versions)
  against the JAX package's host verify. And chip_smoke's forgery at this
  size: the same forged ledger from both packages, which fails alone in
  a replayed span in both, its lane the only one the port's verify plane
  rejects.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

import chip_smoke as cs
import stellard_tpu.node.ledgertools as jlt
import stellard_tpu_torch.node.ledgertools as plt
import test_ledgertools as tlt
from stellard_tpu.engine.engine import TxParams as JaxTxParams
from stellard_tpu.node.ledgermaster import LedgerMaster as JaxLedgerMaster
from stellard_tpu.nodestore import make_database as jax_make_database
from stellard_tpu.protocol.sfields import sfBalance as jsfBalance
from stellard_tpu.protocol.sfields import sfTxnSignature as jsfTxnSignature
from stellard_tpu.protocol.sttx import SerializedTransaction as JaxSTTx
from stellard_tpu_torch.crypto.backend import CudaHasher
from stellard_tpu_torch.engine.engine import TxParams
from stellard_tpu_torch.node.ledgermaster import LedgerMaster
from stellard_tpu_torch.node.verifyplane import VerifyPlane
from stellard_tpu_torch.nodestore import make_database
from stellard_tpu_torch.protocol.sfields import sfBalance
from stellard_tpu_torch.protocol.sttx import SerializedTransaction
from stellard_tpu_torch.protocol.ter import TER

XRP = 1_000_000
TIMES = ("elapsed_s", "tx_per_s", "load_s", "seal_s")


def build_chains():
    """Both packages' chains over the same signed blobs: genesis (saved
    too, so that every closed ledger can be replayed), then four closes
    of one payment each. -> {"jax"|"port": (lm, db, ledgers)}, accounts."""
    accounts = [tlt.KeyPair.from_passphrase(f"lt-{i}") for i in range(4)]
    blobs = [tlt.payment(tlt.MASTER, i + 1, a.account_id, (1000 + i) * XRP).serialize()
             for i, a in enumerate(accounts)]
    out = {}
    for name, lm, db, parse, mode in (
        ("jax", JaxLedgerMaster(), jax_make_database(type="memory"), JaxSTTx.from_bytes,
         JaxTxParams.OPEN_LEDGER),
        ("port", LedgerMaster(), make_database(type="memory"), SerializedTransaction.from_bytes,
         TxParams.OPEN_LEDGER),
    ):
        lm.start_new_ledger(tlt.MASTER.account_id, close_time=1000)
        lm.closed_ledger().save(db)
        ledgers = []
        for i, blob in enumerate(blobs):
            ter, _ = lm.do_transaction(parse(blob), mode)
            assert int(ter) == 0
            closed, _ = lm.close_and_advance(2000 + i * 10, 30)
            closed.save(db)
            ledgers.append(closed)
        if hasattr(lm, "stop_seal_drainer"):
            lm.stop_seal_drainer()
        out[name] = (lm, db, ledgers)
    assert [led.hash() for led in out["jax"][2]] == [led.hash() for led in out["port"][2]]
    return out, accounts


@pytest.fixture(scope="module")
def chains():
    return build_chains()


# --------------------------------------------------------------------------
# port runs of tests/test_ledgertools.py


@pytest.fixture()
def chain(monkeypatch, chains):
    """test_ledgertools.py's chain fixture, on the port: its tools and
    LedgerMaster in the module's names."""
    for name in ("dump_ledger", "dump_transactions", "load_transactions",
                 "replay_ledger", "replay_range"):
        monkeypatch.setattr(tlt, name, getattr(plt, name))
    monkeypatch.setattr(tlt, "LedgerMaster", LedgerMaster)
    monkeypatch.setattr(tlt, "sfBalance", sfBalance)
    (lm, db, ledgers), accounts = chains[0]["port"], chains[1]
    return lm, db, ledgers[:3], accounts[:3]


class TestDumpLedgerPort(tlt.TestDumpLedger):
    pass


class TestTxStreamsPort(tlt.TestTxStreams):
    pass


class TestReplayPort(tlt.TestReplay):
    pass


def test_port_runs_use_the_port(chain):
    _lm, db, ledgers, _accounts = chain
    assert tlt.replay_ledger is plt.replay_ledger and tlt.LedgerMaster is LedgerMaster
    assert isinstance(ledgers[0], plt.Ledger) and isinstance(db, plt.Database)


# --------------------------------------------------------------------------
# outputs paired with the JAX package's


def without_times(stats: dict) -> dict:
    out = {k: v for k, v in stats.items() if k not in TIMES}
    if "ledgers" in out:
        out["ledgers"] = [without_times(s) for s in out["ledgers"]]
    return out


def test_dump_ledger_json_equal(chains):
    (_jlm, _jdb, jl), (_plm, _pdb, pl) = chains[0]["jax"], chains[0]["port"]
    for j, p in zip(jl, pl):
        assert plt.dump_ledger(p) == jlt.dump_ledger(j)


def test_dump_and_load_transactions_equal(chains):
    (_jlm, _jdb, jl), (_plm, _pdb, pl) = chains[0]["jax"], chains[0]["port"]
    jbuf, pbuf = io.StringIO(), io.StringIO()
    assert plt.dump_transactions(iter(pl), pbuf) == jlt.dump_transactions(iter(jl), jbuf) == 4
    assert pbuf.getvalue() == jbuf.getvalue()
    jlm, plm = JaxLedgerMaster(), LedgerMaster()
    for lm in (jlm, plm):
        lm.start_new_ledger(tlt.MASTER.account_id, close_time=1000)
    jbuf.seek(0)
    pbuf.seek(0)
    assert plt.load_transactions(pbuf, plm) == jlt.load_transactions(jbuf, jlm) == (4, 0)
    jlm.stop_seal_drainer()
    for a in chains[1]:
        assert (plm.current_ledger().account_root(a.account_id)[sfBalance].drops()
                == jlm.current_ledger().account_root(a.account_id)[jsfBalance].drops())
    assert plm.closed_ledger().hash() == jlm.closed_ledger().hash()
    assert plm.closed_ledger().seq == jlm.closed_ledger().seq


def _spy(log: list, reject_first=False):
    def verify_many(reqs):
        out = np.ones(len(reqs), bool)
        if reject_first and not log:
            out[0] = False
        log.append(len(reqs))
        return out
    return verify_many


@pytest.mark.parametrize("spy", ["none", "accept", "reject_first"])
def test_replay_ledger_stats_equal(chains, spy):
    (_jlm, jdb, jl), (_plm, pdb, pl) = chains[0]["jax"], chains[0]["port"]
    for j, p in zip(jl, pl):
        logs = {"jax": [], "port": []}
        kw = lambda n: {} if spy == "none" else {  # noqa: E731
            "verify_many": _spy(logs[n], spy == "reject_first")}
        got = plt.replay_ledger(pdb, p.hash(), **kw("port"))
        want = jlt.replay_ledger(jdb, j.hash(), **kw("jax"))
        assert without_times(got) == without_times(want)
        assert got["ok"] == (spy != "reject_first") and logs["port"] == logs["jax"]


@pytest.mark.parametrize("spy", ["none", "accept", "reject_first"])
def test_replay_range_stats_equal(chains, spy):
    (_jlm, jdb, jl), (_plm, pdb, pl) = chains[0]["jax"], chains[0]["port"]
    logs = {"jax": [], "port": []}
    kw = lambda n: {} if spy == "none" else {  # noqa: E731
        "verify_many": _spy(logs[n], spy == "reject_first")}
    got = plt.replay_range(pdb, [p.hash() for p in pl], **kw("port"))
    want = jlt.replay_range(jdb, [j.hash() for j in jl], **kw("jax"))
    assert without_times(got) == without_times(want)
    assert [s["ok"] for s in got["ledgers"]] == [spy != "reject_first"] + [True] * 3
    assert logs["port"] == logs["jax"] == ([] if spy == "none" else [4])


def test_replay_range_on_the_plain_kernels_equal(chains):
    """The port's replay with its VerifyPlane (K1's plain version) and
    CudaHasher (K2/K3's plain versions) on the CPU, the JAX package's with
    its host verify and default hasher: the same stats."""
    from stellard_tpu_torch.protocol import keys

    (_jlm, jdb, jl), (_plm, pdb, pl) = chains[0]["jax"], chains[0]["port"]
    plane = VerifyPlane(backend="cuda", routing="device", min_device_batch=1,
                        backend_opts={"device": "cpu"}, device_warm_timeout=900.0)
    hasher = CudaHasher(device="cpu")
    keys.host_verifies = 0
    try:
        got = plt.replay_range(pdb, [p.hash() for p in pl], hash_batch=hasher,
                               verify_many=plane.verify_many)
    finally:
        plane.stop()
    want = jlt.replay_range(jdb, [j.hash() for j in jl])
    assert without_times(got) == without_times(want) and got["ok"]
    assert keys.host_verifies == 0
    assert plane.get_json()["device_share"] == 1.0
    assert hasher.tree_transfers.readbacks == hasher.tree_calls == 2 * len(pl)
    assert hasher.host_nodes == 0 and hasher.device_nodes > 0


def jax_forge(ledger):
    """chip_smoke.forge_ledger, step for step, with the JAX package's
    classes."""
    entries = list(ledger.tx_entries())
    txid, blob, meta = entries[len(entries) // 2]
    tx = JaxSTTx.from_bytes(blob)
    sig = bytearray(tx.signature)
    sig[0] ^= 1
    tx.obj[jsfTxnSignature] = bytes(sig)
    forged = ledger.snapshot()
    forged.tx_map.del_item(txid)
    return forged, forged.add_transaction(tx.serialize(), meta)


def test_forged_ledger_fails_alone_in_both(chains):
    (_jlm, jdb, jl), (_plm, pdb, pl) = chains[0]["jax"], chains[0]["port"]
    p_forged, p_txid = cs.forge_ledger(pl[2])
    j_forged, j_txid = jax_forge(jl[2])
    assert p_txid == j_txid and p_forged.hash() == j_forged.hash() != pl[2].hash()
    assert p_forged.parent_hash == pl[1].hash()
    p_forged.save(pdb)
    j_forged.save(jdb)
    flags = []
    plane = VerifyPlane(backend="cuda", routing="device", min_device_batch=1,
                        backend_opts={"device": "cpu"}, device_warm_timeout=900.0)

    def verify_many(reqs):
        flags.append(np.asarray(plane.verify_many(reqs), bool))
        return flags[-1]

    try:
        got = plt.replay_range(pdb, [pl[1].hash(), p_forged.hash(), pl[3].hash()],
                               hash_batch=CudaHasher(device="cpu"), verify_many=verify_many)
    finally:
        plane.stop()
    want = jlt.replay_range(jdb, [jl[1].hash(), j_forged.hash(), jl[3].hash()])
    assert without_times(got) == without_times(want)
    assert [s["ok"] for s in got["ledgers"]] == [True, False, True]
    lane = got["ledgers"][0]["tx_count"] + [t for t, _b, _m in p_forged.tx_entries()].index(p_txid)
    assert len(flags) == 1 and np.flatnonzero(~flags[0]).tolist() == [lane]
    assert got["ledgers"][1]["results"][p_txid.hex()] == int(TER.temINVALID)
