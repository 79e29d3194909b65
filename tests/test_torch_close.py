"""The close phase of chip_smoke.py, held against the JAX package.

A seeded payment flood (chip_smoke.close_workload) runs through the
port's standalone node — one batched verify a close on the verify plane,
do_transaction on each payment, close_and_advance sealed by CudaHasher —
on the CPU (device="cpu": K1, K2 and K3 take their plain versions), and
through the JAX package's LedgerMaster (its defaults) over the same
transaction blobs, each package starting from its own build of the same
AccountRoots. Every ledger hash, verdict and TER must be equal: the
tolerance is zero, since these are bytes.

The book phase (chip_smoke.book_workload: gateways, trust lines, regular
keys, issuance, then offer crossings and cancels, regular-key AccountSets,
cross-currency path payments and merges; then path searches pre-ranked on
the path plane) goes on on the same chain, at a small size here.

The full-size run (1,000,000 accounts, 4 closes x 4,096 payments, then
the book phase's 4 closes and 64 path searches; the start ledger and the
8 closed ledgers saved to a segstore as they close) is the `slow` test
that recomputes chip_smoke.py's constants through the JAX package alone:

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


def _jax_close(lm, entries, k: int) -> dict:
    mode = JaxTxParams.OPEN_LEDGER | JaxTxParams.RETRY
    txs = [JaxSTTx.from_bytes(blob) for blob, _kind, _good in entries]
    open_ters = [(tx.txid(), lm.do_transaction(tx, mode)[0]) for tx in txs]
    before = lm.delta_stats.snapshot()
    ledger, results = lm.close_and_advance(cs.START_CLOSE_TIME + 30 * (k + 1), 30)
    return {
        "seq": ledger.seq, "hash": ledger.hash().hex(), "ledger": ledger,
        "results": results, "delta": cs.close_delta(lm, before),
        "digest": cs.results_digest(open_ters, results),
        "close_digest": cs.close_results_digest(results),
        "verdicts": [tx.check_sign() for tx in txs],
        "open_ters": [int(t) for _, t in open_ters],
        "close_ters": {txid: int(t) for txid, t in results.items()},
    }


def run_jax_closes(wl: dict, book=None, on_ledger=None, setup=None,
                   on_close=None) -> list[dict]:
    """The JAX package's LedgerMaster (defaults: delta replay on, its
    default hasher, host verify in the engine) over the same blobs. With
    ``book`` = (book workload, prune floor), the book phase goes on on
    the same chain: its closes, each followed by the JAX PathPlane's
    note_close, then its path searches as the JAX node's path_find door
    makes them (books_if_current, make_pre_rank with the host-routed
    evaluator) -> an extra last entry {"book": closes, "answers",
    "paths_digest", "prune_batches"}. ``on_ledger`` is called with the
    start ledger, then ``setup`` with the LedgerMaster, then
    ``on_close`` with each closed ledger and its results, as it closes
    (by default ``on_ledger`` with the ledger)."""
    start = jax_start_ledger(wl["accounts"])
    lm = JaxLedgerMaster()
    lm.load_ledger(start)
    out = [{"hash": start.hash().hex(), "ledger": start}]
    on_ledger = on_ledger or (lambda _ledger: None)
    on_ledger(start)
    if setup is not None:
        setup(lm)
    on_close = on_close or (lambda ledger, _results: on_ledger(ledger))
    try:
        for k, entries in enumerate(wl["closes"]):
            out.append(_jax_close(lm, entries, k))
            on_close(out[-1]["ledger"], out[-1]["results"])
        if book is not None:
            out.append(_jax_book(lm, *book, first_close=len(wl["closes"]),
                                 on_close=on_close))
    finally:
        lm.stop_seal_drainer()
    return out


def _jax_book(lm, bwl: dict, prune_floor: int, first_close: int,
              on_close=lambda _ledger, _results: None) -> dict:
    from stellard_tpu.crypto.backend import make_path_evaluator as jax_evaluator
    from stellard_tpu.paths import find_paths as jax_find_paths
    from stellard_tpu.paths.plane import PathPlane as JaxPathPlane

    plane = JaxPathPlane(evaluator=jax_evaluator(routing="host"), prune_floor=prune_floor)
    plane.note_close(lm.closed_ledger())
    closes = []
    for k, entries in enumerate(bwl["closes"]):
        closes.append(_jax_close(lm, entries, first_close + k))
        on_close(closes[-1]["ledger"], closes[-1]["results"])
        plane.note_close(lm.closed_ledger())
    ledger = lm.closed_ledger()
    answers = [
        jax_find_paths(ledger, src, dst, JaxSTAmount.from_json(amount.to_json()),
                       send_max=(None if send_max is None
                                 else JaxSTAmount.from_json(send_max.to_json())),
                       books=plane.books_if_current(ledger),
                       pre_rank=plane.make_pre_rank(ledger))
        for src, dst, amount, send_max in bwl["requests"]
    ]
    return {"book": closes, "answers": answers, "paths_digest": cs.paths_digest(answers),
            "prune_batches": plane.get_json()["prune_batches"]}


def txids(wl: dict, close: int) -> list[bytes]:
    return [JaxSTTx.from_bytes(b).txid() for b, _k, _g in wl["closes"][close]]


@pytest.fixture(scope="module")
def small_runs():
    wl = cs.close_workload(**SMALL)
    plane = VerifyPlane(backend="cuda", routing="device",
                        backend_opts={"device": "cpu"})
    tkeys.host_verifies = 0
    try:
        port, node = cs.run_closes(wl, CudaHasher(device="cpu"), plane.verify_many)
        node["lm"].stop_seal_drainer()
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


# the book phase at a small size: 4 gateways (8 IOUs), 48 traders, 24 with
# a regular key, 128 transactions a book close, 16 path searches; a prune
# floor low enough that the searches of this small graph are pre-ranked
SMALL_BOOK = dict(n_gateways=4, n_traders=48, n_regular=24, per_close=128,
                  n_merges=4, n_requests=16, seed=3)
SMALL_PRUNE_FLOOR = 3


@pytest.fixture(scope="module")
def small_book_runs():
    """The close phase and then the book phase on the same chain, through
    the port (the verify plane's K1 and the evaluator's K4 on the CPU,
    which take their plain versions; the seal on the default hasher) and
    through the JAX package."""
    from stellard_tpu_torch.crypto.backend import make_path_evaluator
    from stellard_tpu_torch.paths.plane import PathPlane

    wl = cs.close_workload(**SMALL)
    bwl = cs.book_workload(wl, **SMALL_BOOK)
    plane = VerifyPlane(backend="cuda", routing="device",
                        backend_opts={"device": "cpu"})
    paths = PathPlane(evaluator=make_path_evaluator(routing="device", device="cpu"),
                      prune_floor=SMALL_PRUNE_FLOOR)
    tkeys.host_verifies = 0
    try:
        _closes, node = cs.run_closes(wl, None, plane.verify_many)
        port = cs.run_book(node, bwl, plane.verify_many, paths, first_close=SMALL["n_closes"])
        node["lm"].stop_seal_drainer()
    finally:
        plane.stop()
    jax = run_jax_closes(wl, book=(bwl, SMALL_PRUNE_FLOOR))[-1]
    return bwl, port, jax, paths.get_json(), tkeys.host_verifies


@pytest.mark.parametrize("close", range(4))
def test_book_close_equal_to_jax(small_book_runs, close):
    bwl, port, jax, _pp, _hv = small_book_runs
    p, j = port["closes"][close], jax["book"][close]
    assert p["seq"] == j["seq"] == cs.START_SEQ + SMALL["n_closes"] + close + 1
    assert p["hash"] == j["hash"]
    assert p["open_ters"] == j["open_ters"] == cs._expect_open_ters(bwl["closes"][close])
    assert p["close_ters"] == j["close_ters"]
    assert p["digest"] == j["digest"]
    assert p["verdicts"] == j["verdicts"] == [g for _b, _k, g in bwl["closes"][close]]


def test_book_workload_covers_every_kind(small_book_runs):
    bwl, port, _jax, _pp, _hv = small_book_runs
    kinds = {k for c in bwl["closes"] for _b, k, _g in c}
    assert {"transfer_rate", "trust_set", "regular_key_set", "issue", "account_merge",
            "offer_ask", "offer_bid", "offer_cancel", "regular_key_account_set",
            "cross_payment", "bad_sig"} <= kinds
    # the book closes applied what they carried: offers crossed and rested
    closed = [t for c in port["closes"][2:] for t in c["close_ters"].values()]
    assert closed.count(int(TER.tesSUCCESS)) > len(closed) // 2


def test_book_paths_equal_to_jax(small_book_runs):
    """Every path answer equal (the digest covers every element and
    amount); the searches were pre-ranked on the plane, by the evaluator's
    device arm, in both packages alike."""
    _bwl, port, jax, pp, host_verifies = small_book_runs
    assert port["paths_digest"] == jax["paths_digest"]
    assert any(port["answers"])
    assert pp["prune_batches"] == jax["prune_batches"] > 0
    assert pp["evaluator"]["device_batches"] == pp["prune_batches"]
    assert pp["evaluator"]["host_batches"] == 0
    assert host_verifies == 0
    assert pp["index"]["full_rebuilds"] == 1 and pp["index"]["incremental_advances"] >= 2


def jax_chain_persist(tmp_path, save_stage):
    """-> (setup, on_close, persisted): the JAX node's close persistence
    (chip_smoke.ChainPersist around the JAX package's ClosePipeline,
    build_tx_rows and file-backed TxDatabase and CLF under tmp_path) for
    run_jax_closes; ``persisted()`` drains the pipeline and returns the
    ChainPersist."""
    from stellard_tpu.node.closepipeline import ClosePipeline as JaxClosePipeline
    from stellard_tpu.node.node import _results_from_meta, build_tx_rows
    from stellard_tpu.node.txdb import TxDatabase as JaxTxDatabase
    from stellard_tpu.state.clf import CLFMirror as JaxCLF, LedgerSqlDatabase as JaxSql

    box = {}

    def setup(lm):
        box["p"] = cs.ChainPersist(
            lm, JaxClosePipeline, JaxTxDatabase(str(tmp_path / "txdb.db")),
            JaxCLF(JaxSql(str(tmp_path / "clf.db"))), build_tx_rows, _results_from_meta,
            save_stage=save_stage)

    def persisted():
        box["p"].stop()
        return box["p"]

    return setup, lambda ledger, results: box["p"].submit(ledger, results), persisted


@pytest.mark.slow
def test_chip_smoke_constants_through_the_jax_package(tmp_path):
    """Recomputes chip_smoke.py's CLOSE_HASHES / CLOSE_DIGESTS, the book
    phase's BOOK_HASHES / BOOK_DIGESTS / PATHS_DIGEST, the replay
    phase's CLOSE_RESULT_DIGESTS / BOOK_RESULT_DIGESTS / STORE_DIGEST /
    SAVE_NODES and the default close's DELTAS / TXDB_DIGESTS /
    CLF_DIGESTS at full size through the JAX package (its LedgerMaster,
    defaults, with its node's persist_prep; its PathPlane with
    BOOK_PRUNE_FLOOR and the host-routed evaluator; its segstore with
    its defaults, saving the start ledger and then each closed ledger as
    the close pipeline's node-store stage, beside a file-backed txdb and
    CLF)."""
    from stellard_tpu.nodestore import make_database as jax_make_database

    wl = cs.close_workload(**cs.CLOSE_SIZES)
    bwl = cs.book_workload(wl, **cs.BOOK_SIZES)
    db = jax_make_database(type="segstore", path=str(tmp_path / "store"))
    saves = []
    save = lambda led: saves.append(cs.save_counted(led, db))  # noqa: E731
    setup, on_close, persisted = jax_chain_persist(tmp_path, save)
    jax = run_jax_closes(wl, book=(bwl, cs.BOOK_PRUNE_FLOOR), on_ledger=save,
                         setup=setup, on_close=on_close)
    persist = persisted()
    book = jax.pop()
    records = list(cs.segstore_records(db.backend))
    assert len(records) == db.backend.count() == sum(s["nodes"] for s in saves)
    store = cs.store_digest(records), [s["nodes"] for s in saves]
    db.close()
    closes = jax[1:] + book["book"]
    got = [c["hash"] for c in jax[1:]], [c["digest"] for c in jax[1:]]
    got_book = [c["hash"] for c in book["book"]], [c["digest"] for c in book["book"]]
    got_results = ([c["close_digest"] for c in jax[1:]],
                   [c["close_digest"] for c in book["book"]])
    deltas = [[c["delta"][k] for k in ("spliced", "fallback", "invalidated", "seal_adopt")]
              for c in closes]
    persisted_digests = ([persist.digests[c["seq"]]["txdb"] for c in closes],
                         [persist.digests[c["seq"]]["clf"] for c in closes])
    print("START_HASH =", jax[0]["hash"])
    print("CLOSE_HASHES =", got[0])
    print("CLOSE_DIGESTS =", got[1])
    print("BOOK_HASHES =", got_book[0])
    print("BOOK_DIGESTS =", got_book[1])
    print("PATHS_DIGEST =", book["paths_digest"])
    print("prune_batches =", book["prune_batches"])
    print("CLOSE_RESULT_DIGESTS =", got_results[0])
    print("BOOK_RESULT_DIGESTS =", got_results[1])
    print("STORE_DIGEST =", store[0])
    print("SAVE_NODES =", store[1])
    print("DELTAS =", deltas)
    print("TXDB_DIGESTS =", persisted_digests[0])
    print("CLF_DIGESTS =", persisted_digests[1])
    pipe = persist.pipeline.get_json()
    print("pipeline =", {k: pipe[k] for k in ("persisted", "failed", "depth_hwm")},
          "clf =", persist.clf.get_json())
    assert jax[0]["hash"] == cs.START_HASH
    assert got == (cs.CLOSE_HASHES, cs.CLOSE_DIGESTS)
    assert got_book == (cs.BOOK_HASHES, cs.BOOK_DIGESTS)
    assert book["paths_digest"] == cs.PATHS_DIGEST
    assert book["prune_batches"] > 0
    assert got_results == (cs.CLOSE_RESULT_DIGESTS, cs.BOOK_RESULT_DIGESTS)
    assert store == (cs.STORE_DIGEST, cs.SAVE_NODES)
    assert pipe["persisted"] == len(closes) and pipe["failed"] == 0
    assert deltas == cs.DELTAS
    assert persisted_digests == (cs.TXDB_DIGESTS, cs.CLF_DIGESTS)


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
