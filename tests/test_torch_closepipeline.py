"""The port's close pipeline, held to the contracts of
tests/test_closepipeline.py.

- strict order: the CLF commits land 1, 2, 3, never out of order;
- backpressure: a full queue blocks the submitter instead of growing,
  and a stop() during the wait fails the blocked entry;
- drain-on-stop: everything queued before stop() is persisted, and the
  CLF pointer (reopened from its file) is on the last close;
- read-your-writes: a queued-but-unpersisted ledger resolves by hash,
  by sequence and by a transaction it holds;
- byte-equivalence: a chain persisted through the pipeline stores the
  same txdb rows, CLF and node-store records as the same chain persisted
  in line, and as the JAX package's pipeline persists the JAX chain.
"""

from __future__ import annotations

import threading

import pytest

import chip_smoke as cs
from stellard_tpu.engine.engine import TxParams as JaxTxParams
from stellard_tpu.node.closepipeline import ClosePipeline as JaxClosePipeline
from stellard_tpu.node.ledgermaster import LedgerMaster as JaxLedgerMaster
from stellard_tpu.node.metrics import LatencyHist as JaxLatencyHist
from stellard_tpu.node.node import _results_from_meta as jax_results_from_meta
from stellard_tpu.node.node import build_tx_rows as jax_build_tx_rows
from stellard_tpu.node.txdb import TxDatabase as JaxTxDatabase
from stellard_tpu.nodestore import make_database as jax_make_database
from stellard_tpu.protocol.sttx import SerializedTransaction as JaxSTTx
from stellard_tpu.state.clf import CLFMirror as JaxCLF
from stellard_tpu.state.clf import LedgerSqlDatabase as JaxSql
from stellard_tpu_torch.crypto.backend import CudaHasher
from stellard_tpu_torch.engine.engine import TxParams
from stellard_tpu_torch.node.closepipeline import ClosePipeline, LatencyHist
from stellard_tpu_torch.node.ledgermaster import LedgerMaster
from stellard_tpu_torch.node.node import _results_from_meta, build_tx_rows
from stellard_tpu_torch.node.txdb import TxDatabase
from stellard_tpu_torch.nodestore import make_database
from stellard_tpu_torch.protocol.formats import TxType
from stellard_tpu_torch.protocol.keys import KeyPair
from stellard_tpu_torch.protocol.sfields import sfAmount, sfDestination
from stellard_tpu_torch.protocol.stamount import STAmount
from stellard_tpu_torch.protocol.sttx import SerializedTransaction
from stellard_tpu_torch.state.clf import CLFMirror, LedgerSqlDatabase

MASTER = KeyPair.from_passphrase("masterpassphrase")
DESTS = [KeyPair.from_passphrase(f"cp-dest-{i}").account_id for i in range(4)]


class FakeLedger:
    def __init__(self, seq):
        self.seq = seq

    def hash(self):
        return self.seq.to_bytes(32, "big")


def payments(n: int, start: int = 1) -> list[bytes]:
    out = []
    for i in range(n):
        tx = SerializedTransaction.build(
            TxType.ttPAYMENT, MASTER.account_id, start + i, 10,
            {sfAmount: STAmount.from_drops(250_000_000), sfDestination: DESTS[i % len(DESTS)]})
        tx.sign(MASTER)
        out.append(tx.serialize())
    return out


PORT = dict(lm=lambda: LedgerMaster(hash_batch=CudaHasher(device="cpu")),
            parse=SerializedTransaction.from_bytes, params=TxParams.OPEN_LEDGER | TxParams.RETRY,
            pipeline=ClosePipeline, txdb=TxDatabase, sql=LedgerSqlDatabase, clf=CLFMirror,
            rows=build_tx_rows, recover=_results_from_meta, store=make_database)
JAX = dict(lm=JaxLedgerMaster, parse=JaxSTTx.from_bytes,
           params=JaxTxParams.OPEN_LEDGER | JaxTxParams.RETRY, pipeline=JaxClosePipeline,
           txdb=JaxTxDatabase, sql=JaxSql, clf=JaxCLF, rows=jax_build_tx_rows,
           recover=jax_results_from_meta, store=jax_make_database)


def persisted_chain(pkg: dict, path, rounds, mode: str = "pipelined", depth: int = 8,
                    gate=None):
    """A genesis chain of one close per round of blobs, persisted as the
    JAX node persists its closes (chip_smoke.ChainPersist: node store,
    file-backed txdb and CLF under ``path``): through the close pipeline,
    or with its three stages called in line ("serial"). ``gate`` (an
    Event) holds every node-store save until it is set. -> (the
    ChainPersist, the node store, the closed ledgers, the LedgerMaster)."""
    path.mkdir(parents=True, exist_ok=True)
    db = pkg["store"](type="memory", async_writes=False)

    def save(ledger):
        if gate is not None:
            gate.wait(timeout=60)
        ledger.save(db)

    lm = pkg["lm"]()
    lm.start_new_ledger(MASTER.account_id, close_time=1000)
    persist = cs.ChainPersist(lm, pkg["pipeline"], pkg["txdb"](str(path / "txdb.db")),
                              pkg["clf"](pkg["sql"](str(path / "clf.db"))), pkg["rows"],
                              pkg["recover"], save_stage=save, depth=depth)
    ledgers = []
    for k, blobs in enumerate(rounds):
        for blob in blobs:
            _ter, ok = lm.do_transaction(pkg["parse"](blob), pkg["params"])
            assert ok
        ledger, results = lm.close_and_advance(2000 + 30 * k, 30)
        ledgers.append(ledger)
        if mode == "serial":
            p = persist.pipeline
            p.save_stage(ledger)
            p.txdb_stage(ledger, results)
            p.clf_stage(ledger)
            persist.digests[ledger.seq] = {"txdb": cs.txdb_digest(persist.txdb, ledger.seq),
                                           "clf": cs.clf_digest(persist.clf)}
        else:
            persist.submit(ledger, results)
    lm.stop_seal_drainer()
    return persist, db, ledgers, lm


def store_records(db) -> list:
    return sorted((o.hash, int(o.type), bytes(o.data)) for o in db.backend.iterate())


def test_full_queue_blocks_submitter_and_commits_in_order():
    release, started = threading.Event(), threading.Event()
    order = []

    def slow_save(_led):
        started.set()
        release.wait(timeout=30)

    pipe = ClosePipeline(save_stage=slow_save, txdb_stage=lambda led, results: None,
                         clf_stage=lambda led: order.append(led.seq), depth=1)
    pipe.submit_close(FakeLedger(1), {})  # drains into the worker
    assert started.wait(timeout=10)
    pipe.submit_close(FakeLedger(2), {})  # fills the depth-1 queue
    blocked_done = threading.Event()
    t = threading.Thread(target=lambda: (pipe.submit_close(FakeLedger(3), {}),
                                         blocked_done.set()))
    t.start()
    assert not blocked_done.wait(timeout=0.5), "submit did not block"
    release.set()
    assert blocked_done.wait(timeout=10), "submit never unblocked"
    t.join()
    assert pipe.stop(timeout=30)
    assert order == [1, 2, 3]
    assert pipe.backpressure_waits >= 1 and pipe.depth_hwm == 1


def test_stop_during_backpressure_fails_the_blocked_submitter():
    release, failed = threading.Event(), threading.Event()
    pipe = ClosePipeline(save_stage=lambda led: release.wait(timeout=30),
                         txdb_stage=lambda led, results: None, clf_stage=lambda led: None,
                         depth=1)
    pipe.submit_close(FakeLedger(1), {})
    pipe.submit_close(FakeLedger(2), {})
    t = threading.Thread(target=lambda: pipe.submit_close(FakeLedger(3), {},
                                                          on_failed=failed.set))
    t.start()
    stopper = threading.Thread(target=lambda: pipe.stop(timeout=30))
    stopper.start()
    assert failed.wait(timeout=10), "blocked submitter's on_failed never fired"
    release.set()
    stopper.join(timeout=30)
    t.join(timeout=10)
    assert not t.is_alive() and pipe.pending() == 0


def test_failed_persist_is_counted_and_the_worker_goes_on():
    failures, done = [], []
    boom = {"on": True}

    def bad_txdb(_led, _results):
        if boom["on"]:
            raise RuntimeError("disk on fire")

    pipe = ClosePipeline(save_stage=lambda led: None, txdb_stage=bad_txdb,
                         clf_stage=lambda led: None, depth=4)
    pipe.submit_close(FakeLedger(1), {}, on_failed=lambda: failures.append(1))
    assert pipe.flush(timeout=10)
    assert failures == [1] and pipe.failed == 1
    boom["on"] = False
    pipe.submit_close(FakeLedger(2), {}, done=lambda r: done.append(2))
    assert pipe.flush(timeout=10)
    assert done == [2] and pipe.persisted == 1
    assert pipe.stop(timeout=10)


def test_drain_on_stop_lands_everything_and_the_clf_pointer(tmp_path):
    rounds = [payments(15, 1 + 15 * k) for k in range(4)]
    persist, _db, ledgers, _lm = persisted_chain(PORT, tmp_path, rounds, depth=16)
    persist.stop()  # at once: whatever is still queued persists first
    persist.txdb.close()
    persist.clf.db.close()
    txdb = TxDatabase(str(tmp_path / "txdb.db"))
    clf = LedgerSqlDatabase(str(tmp_path / "clf.db"))
    try:
        for led in ledgers:
            assert txdb.get_ledger_header(seq=led.seq)["hash"] == led.hash()
        for blob in (b for r in rounds for b in r):
            assert txdb.get_transaction(SerializedTransaction.from_bytes(blob).txid()) is not None
        assert clf.get_state("LastClosedLedger") == ledgers[-1].hash()
    finally:
        txdb.close()
        clf.close()


def test_read_your_writes_while_queued(tmp_path):
    gate = threading.Event()
    rounds = [payments(5)]
    persist, _db, ledgers, _lm = persisted_chain(PORT, tmp_path, rounds, gate=gate)
    pipe, closed = persist.pipeline, ledgers[0]
    txid = SerializedTransaction.from_bytes(rounds[0][0]).txid()
    try:
        assert persist.txdb.get_transaction(txid) is None
        assert persist.txdb.get_ledger_header(seq=closed.seq) is None
        assert pipe.get(closed.hash()) is closed
        assert pipe.get_by_seq(closed.seq) is closed
        found = pipe.lookup_tx(txid)
        assert found is not None and found[0] is closed and found[1] == rounds[0][0]
        assert pipe.pending() == 1
    finally:
        gate.set()
        assert pipe.flush(timeout=60)
    assert persist.txdb.get_transaction(txid)["ledger_seq"] == closed.seq
    assert pipe.get(closed.hash()) is None and pipe.lookup_tx(txid) is None
    persist.stop()


def test_pipelined_equals_in_line_and_the_jax_pipeline(tmp_path):
    rounds = [payments(30, 1 + 30 * k) for k in range(3)]
    runs = {}
    for name, pkg, mode in (("pipelined", PORT, "pipelined"), ("serial", PORT, "serial"),
                            ("jax", JAX, "pipelined")):
        persist, db, ledgers, lm = persisted_chain(pkg, tmp_path / name, rounds, mode=mode)
        persist.stop()
        runs[name] = {
            "hashes": [led.hash() for led in ledgers],
            "digests": [persist.digests[led.seq] for led in ledgers],
            "records": store_records(db),
            "clf": persist.clf.last_closed_hash,
            "stages": persist.pipeline.get_json(),
        }
    p, s, j = runs["pipelined"], runs["serial"], runs["jax"]
    assert p["hashes"] == s["hashes"] == j["hashes"]
    assert p["digests"] == s["digests"] == j["digests"]
    assert p["records"] == s["records"] == j["records"]
    assert p["clf"] == s["clf"] == j["clf"] == p["hashes"][-1]
    assert p["stages"]["persisted"] == 3 and s["stages"]["persisted"] == 0
    assert set(p["stages"]["stages"]) == {"queue_wait", "nodestore", "txdb", "clf", "total"}
    assert p["stages"]["stages"]["total"]["count"] == 3


@pytest.mark.parametrize("stages", [False, True])
@pytest.mark.parametrize("interpolate", [False, True])
def test_latency_hist_equal_to_jax(interpolate, stages):
    """The pipeline's default decade buckets and the close stages'
    STAGE_BOUNDS, each with and without interpolation."""
    from stellard_tpu.node.tracer import STAGE_BOUNDS as JAX_STAGE_BOUNDS
    from stellard_tpu_torch.node.tracer import STAGE_BOUNDS

    assert STAGE_BOUNDS == JAX_STAGE_BOUNDS
    samples = [0.05, 0.5, 1.5, 3.0, 8.0, 40.0, 40.0, 120.0, 700.0, 6000.0]
    hists = [cls(bounds=STAGE_BOUNDS if stages else None, interpolate=interpolate)
             for cls in (LatencyHist, JaxLatencyHist)]
    for h in hists:
        assert h.quantile(0.5) == 0.0
        for ms in samples:
            h.record(ms)
    port, jax = hists
    assert port.get_json() == jax.get_json()
    for q in (0.1, 0.5, 0.9, 0.99, 1.0):
        assert port.quantile(q) == jax.quantile(q)
    if not interpolate and not stages:
        assert port.get_json()["p50_ms"] == 10.0  # the upper bound of the median's bucket
