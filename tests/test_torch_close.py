"""The close phase of chip_smoke.py, held against the JAX package.

A seeded payment flood (chip_smoke.close_workload) runs through the
port's standalone node — one batched verify a close on the verify plane,
do_transaction on each payment, close_and_advance sealed by CudaHasher —
on the CPU (device="cpu": K1, K2 and K3 take their plain versions), and
through the JAX package's LedgerMaster (its defaults) over the same
transaction blobs, each package starting from its own build of the same
AccountRoots. Every ledger hash, verdict and TER must be equal: the
tolerance is zero, since these are bytes.

The full-size run (1,000,000 accounts, 4 closes x 4,096 payments) is the
`slow` test that recomputes chip_smoke.py's constants through the JAX
package alone:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_close.py -m slow -q -s
"""

from __future__ import annotations

import pytest

import chip_smoke as cs
from stellard_tpu.engine.engine import TxParams as JaxTxParams
from stellard_tpu.node.ledgermaster import LedgerMaster as JaxLedgerMaster
from stellard_tpu.protocol.formats import LedgerEntryType as JaxLET
from stellard_tpu.protocol import sfields as jsf
from stellard_tpu.protocol.stamount import STAmount as JaxSTAmount
from stellard_tpu.protocol.stobject import STObject as JaxSTObject
from stellard_tpu.protocol.sttx import SerializedTransaction as JaxSTTx
from stellard_tpu.state import indexes as jindexes
from stellard_tpu.state.ledger import Ledger as JaxLedger
from stellard_tpu.state.shamap import SHAMapItem as JaxItem
from stellard_tpu_torch.crypto.backend import CudaHasher
from stellard_tpu_torch.node.verifyplane import VerifyPlane
from stellard_tpu_torch.protocol import keys as tkeys
from stellard_tpu_torch.protocol.ter import TER

SMALL = dict(n_accounts=2000, n_senders=64, n_closes=3, per_close=128, seed=5)


def jax_start_ledger(accounts) -> JaxLedger:
    """The start ledger built by the JAX package: its own AccountRoot
    serialization, the same header."""
    items = []
    for a in accounts:
        o = JaxSTObject()
        o[jsf.sfLedgerEntryType] = int(JaxLET.ltACCOUNT_ROOT)
        o[jsf.sfAccount] = a
        o[jsf.sfBalance] = JaxSTAmount.from_drops(cs.ACCOUNT_BALANCE)
        o[jsf.sfSequence] = 1
        o[jsf.sfFlags] = 0
        o[jsf.sfOwnerCount] = 0
        o[jsf.sfPreviousTxnID] = b"\x00" * 32
        o[jsf.sfPreviousTxnLgrSeq] = 0
        items.append(JaxItem(jindexes.account_root_index(a), o.serialize()))
    led = JaxLedger(**cs.start_header())
    led.state_map.bulk_update(items)
    led.closed = True
    return led


def run_jax_closes(wl: dict) -> list[dict]:
    """The JAX package's LedgerMaster (defaults: delta replay on, its
    default hasher, host verify in the engine) over the same blobs."""
    start = jax_start_ledger(wl["accounts"])
    lm = JaxLedgerMaster()
    lm.load_ledger(start)
    out = [{"hash": start.hash().hex()}]
    mode = JaxTxParams.OPEN_LEDGER | JaxTxParams.RETRY
    try:
        for k, entries in enumerate(wl["closes"]):
            txs = [JaxSTTx.from_bytes(blob) for blob, _kind, _good in entries]
            open_ters = [(tx.txid(), lm.do_transaction(tx, mode)[0]) for tx in txs]
            ledger, results = lm.close_and_advance(cs.START_CLOSE_TIME + 30 * (k + 1), 30)
            out.append({
                "seq": ledger.seq, "hash": ledger.hash().hex(),
                "digest": cs.results_digest(open_ters, results),
                "verdicts": [tx.check_sign() for tx in txs],
                "open_ters": [int(t) for _, t in open_ters],
                "close_ters": {txid: int(t) for txid, t in results.items()},
            })
    finally:
        lm.stop_seal_drainer()
    return out


def txids(wl: dict, close: int) -> list[bytes]:
    return [JaxSTTx.from_bytes(b).txid() for b, _k, _g in wl["closes"][close]]


@pytest.fixture(scope="module")
def small_runs():
    wl = cs.close_workload(**SMALL)
    plane = VerifyPlane(backend="cuda", routing="device",
                        backend_opts={"device": "cpu"})
    tkeys.host_verifies = 0
    try:
        port = cs.run_closes(wl, CudaHasher(device="cpu"), plane.verify_many)
    finally:
        plane.stop()
    host_verifies = tkeys.host_verifies
    return wl, port, run_jax_closes(wl), plane.get_json(), host_verifies


def test_start_ledger_hash_equal(small_runs):
    _wl, port, jax, _pj, _hv = small_runs
    assert port[0]["hash"] == jax[0]["hash"]


@pytest.mark.parametrize("close", range(SMALL["n_closes"]))
def test_close_equal_to_jax(small_runs, close):
    wl, port, jax, _pj, _hv = small_runs
    p, j = port[close + 1], jax[close + 1]
    assert p["seq"] == j["seq"] == cs.START_SEQ + close + 1
    assert p["hash"] == j["hash"]
    assert p["open_ters"] == j["open_ters"]
    assert p["close_ters"] == j["close_ters"]
    assert p["digest"] == j["digest"]
    assert p["verdicts"] == j["verdicts"] == [g for _b, _k, g in wl["closes"][close]]
    kinds = [k for _b, k, _g in wl["closes"][close]]
    want = [int(TER.tesSUCCESS) if k != "bad_sig" else int(TER.temINVALID) for k in kinds]
    assert p["open_ters"] == want
    # every good payment closes tesSUCCESS; a bad-signature one is absent
    closed = {txid for txid, k in zip(txids(wl, close), kinds) if k != "bad_sig"}
    assert set(p["close_ters"]) == closed
    assert set(p["close_ters"].values()) == {int(TER.tesSUCCESS)}


def test_workload_covers_every_kind(small_runs):
    wl, _port, _jax, _pj, _hv = small_runs
    kinds = [k for c in wl["closes"] for _b, k, _g in c]
    assert {"existing", "new_account", "bad_sig"} <= set(kinds)


def test_no_host_verify_and_all_on_the_plane(small_runs):
    _wl, _port, _jax, pj, host_verifies = small_runs
    assert host_verifies == 0
    assert pj["device_share"] == 1.0
    assert pj["device_batches"] == SMALL["n_closes"]


@pytest.mark.slow
def test_chip_smoke_constants_through_the_jax_package():
    """Recomputes chip_smoke.py's CLOSE_HASHES / CLOSE_DIGESTS at full
    size through the JAX package (its LedgerMaster, defaults)."""
    wl = cs.close_workload(**cs.CLOSE_SIZES)
    jax = run_jax_closes(wl)
    got = [c["hash"] for c in jax[1:]], [c["digest"] for c in jax[1:]]
    print("START_HASH =", jax[0]["hash"])
    print("CLOSE_HASHES =", got[0])
    print("CLOSE_DIGESTS =", got[1])
    assert jax[0]["hash"] == cs.START_HASH
    assert got == (cs.CLOSE_HASHES, cs.CLOSE_DIGESTS)


def test_genesis_chain_with_held_transactions_equal():
    """Both LedgerMasters from genesis: funding, a payment one sequence
    ahead (terPRE_SEQ, held as the node holds it) that the next open
    ledger re-applies once the gap fills, and the chain's history."""
    from stellard_tpu.testkit.workloads import TxFactory
    from stellard_tpu_torch.engine.engine import TxParams
    from stellard_tpu_torch.node.ledgermaster import LedgerMaster
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction

    fac = TxFactory(seed=8, n_accounts=3)
    a = fac.accounts
    fund = [tx.serialize() for tx in fac.fund_all(500 * 1_000_000)]
    seq = fac.next_seq(a[0])
    ahead = fac.payment_at_seq(a[0], seq + 1, a[1].account_id, 3_000_000, 10).serialize()
    gap = fac.payment_at_seq(a[0], seq, a[2].account_id, 2_000_000, 10).serialize()
    rounds = [fund, [ahead], [gap], []]
    chains = []
    for lm, parse, mode in (
        (JaxLedgerMaster(), JaxSTTx.from_bytes, JaxTxParams.OPEN_LEDGER | JaxTxParams.RETRY),
        (LedgerMaster(hash_batch=CudaHasher(device="cpu")), SerializedTransaction.from_bytes,
         TxParams.OPEN_LEDGER | TxParams.RETRY),
    ):
        lm.start_new_ledger(fac.master.account_id, close_time=530_000_000)
        log = [lm.closed_ledger().hash()]
        for k, blobs in enumerate(rounds):
            for blob in blobs:
                tx = parse(blob)
                ter, _applied = lm.do_transaction(tx, mode)
                if int(ter) == int(TER.terPRE_SEQ):
                    lm.add_held_transaction(tx)
                log.append(int(ter))
            led, results = lm.close_and_advance(530_000_000 + 30 * (k + 1), 30)
            log += [led.hash(), sorted((t, int(r)) for t, r in results.items()), len(lm.held)]
            assert lm.get_ledger_by_seq(led.seq) is led
        if hasattr(lm, "stop_seal_drainer"):
            lm.stop_seal_drainer()
        chains.append(log)
    assert chains[0] == chains[1]
    assert int(TER.terPRE_SEQ) in chains[1]
