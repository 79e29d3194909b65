"""The port's txdb (node/txdb.py), CLF (state/clf.py) and SHAMap.compare,
byte-equal to the JAX package's.

The close and book phases of chip_smoke.py at a small size run through
both packages with the JAX node's close persistence (chip_smoke.
ChainPersist: persist_prep beside the threaded seal, then the close
pipeline's node-store, txdb and CLF stages, file-backed): after every
close, its txdb rows, the whole CLF (tables and LCL state) and the
delta replay's splice counts and adoption are equal, and so are the
node stores. Then the two databases' APIs over the same rows, the CLF's
scoped transactions, full import and resume, and SHAMap.compare on
seeded trees.
"""

from __future__ import annotations

import hashlib
import random

import pytest

import chip_smoke as cs
import stellard_tpu.state.shamap as jax_shamap
import stellard_tpu_torch.state.shamap as port_shamap
import test_torch_close as ttc
from stellard_tpu.node.node import build_tx_rows as jax_build_tx_rows
from stellard_tpu.node.txdb import TxDatabase as JaxTxDatabase
from stellard_tpu.nodestore import make_database as jax_make_database
from stellard_tpu.state.clf import CLFMirror as JaxCLF
from stellard_tpu.state.clf import LedgerSqlDatabase as JaxSql
from stellard_tpu_torch.crypto.backend import CpuVerifier, CudaHasher, make_path_evaluator
from stellard_tpu_torch.node.txdb import TxDatabase
from stellard_tpu_torch.nodestore import make_database
from stellard_tpu_torch.paths.plane import PathPlane
from stellard_tpu_torch.state.clf import CLFMirror, LedgerSqlDatabase
from stellard_tpu_torch.state.ledger import Ledger


def txdb_tables(txdb) -> dict:
    with txdb._lock:
        return {t: txdb._conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                for t in ("Ledgers", "Transactions", "AccountTransactions", "Validations")}


def clf_tables(clf) -> dict:
    return {t: clf.db.query(f"SELECT * FROM {t} ORDER BY rowid")
            for t in ("StoreState", "accounts", "trustlines", "offers")}


@pytest.fixture(scope="module")
def persisted(tmp_path_factory):
    """The small close and book phases, persisted by both packages."""
    tmp = tmp_path_factory.mktemp("clf_txdb")
    wl = cs.close_workload(**ttc.SMALL)
    bwl = dict(cs.book_workload(wl, **ttc.SMALL_BOOK), requests=[])
    # the JAX package: its LedgerMaster (defaults) with its node's persistence
    jdb = jax_make_database(type="segstore", path=str(tmp / "jax" / "store"))
    (tmp / "jax").mkdir(exist_ok=True)
    setup, on_close, done = ttc.jax_chain_persist(tmp / "jax", lambda led: led.save(jdb))
    jax = ttc.run_jax_closes(wl, book=(bwl, ttc.SMALL_PRUNE_FLOOR),
                             on_ledger=lambda led: led.save(jdb), setup=setup, on_close=on_close)
    jpersist = done()
    jbook = jax.pop()
    # the port: its LedgerMaster (defaults) on CudaHasher(device="cpu"),
    # the plain K2/K3, with the same persistence through its own classes
    pdir = tmp / "port"
    pdir.mkdir()
    pdb = make_database(type="segstore", path=str(pdir / "store"))
    box = {}

    def attach(lm):
        from stellard_tpu_torch.node.closepipeline import ClosePipeline
        from stellard_tpu_torch.node.node import _results_from_meta, build_tx_rows

        box["p"] = cs.ChainPersist(lm, ClosePipeline, TxDatabase(str(pdir / "txdb.db")),
                                   CLFMirror(LedgerSqlDatabase(str(pdir / "clf.db"))),
                                   build_tx_rows, _results_from_meta,
                                   save_stage=lambda led: led.save(pdb))

    verify = CpuVerifier().verify_batch
    submit = lambda _k, led, results: box["p"].submit(led, results)  # noqa: E731
    closes, node = cs.run_closes(wl, CudaHasher(device="cpu"), verify, on_close=submit,
                                 on_start=lambda led: led.save(pdb), setup=attach)
    book = cs.run_book(node, bwl, verify, PathPlane(evaluator=make_path_evaluator(
        routing="host")), first_close=len(wl["closes"]), on_close=submit)
    box["p"].stop()
    node["lm"].stop_seal_drainer()
    out = {"jax": (jax[1:] + jbook["book"], jpersist, jdb),
           "port": (closes[1:] + book["closes"], box["p"], pdb), "lm": node["lm"]}
    yield out
    for _closes, p, db in (out["jax"], out["port"]):
        p.txdb.close()
        p.clf.db.close()
        db.close()


def test_every_close_equal_and_persisted_equal(persisted):
    jcloses, jp, _jdb = persisted["jax"]
    pcloses, pp, _pdb = persisted["port"]
    assert [c["hash"] for c in pcloses] == [c["hash"] for c in jcloses]
    assert [c["delta"] for c in pcloses] == [c["delta"] for c in jcloses]
    assert [pp.digests[c["seq"]] for c in pcloses] == [jp.digests[c["seq"]] for c in jcloses]
    # the delta replay ran: every close carried a speculation
    assert all(c["delta"]["seal_adopt"] != "none" for c in pcloses)
    assert sum(c["delta"]["spliced"] for c in pcloses) > 0
    tree = persisted["lm"].tree_json()
    assert all(tree[k] == 0 for k in cs.ABSORBED)


def test_txdb_and_clf_tables_byte_equal(persisted):
    _jc, jp, _jdb = persisted["jax"]
    pcloses, pp, _pdb = persisted["port"]
    assert txdb_tables(pp.txdb) == txdb_tables(jp.txdb)
    assert clf_tables(pp.clf) == clf_tables(jp.clf)
    assert pp.clf.get_json() == jp.clf.get_json()
    # the first commit imported the resumed state whole; the rest were deltas
    assert pp.clf.full_imports == 1 and pp.clf.commits == len(pcloses) - 1


def test_node_stores_equal(persisted):
    _jc, _jp, jdb = persisted["jax"]
    _pc, _pp, pdb = persisted["port"]
    assert cs.store_digest(cs.segstore_records(pdb.backend)) == cs.store_digest(
        cs.segstore_records(jdb.backend))


def test_txdb_answers_equal(persisted):
    jcloses, jp, _jdb = persisted["jax"]
    _pc, pp, _pdb = persisted["port"]
    port, jax = pp.txdb, jp.txdb
    ledger = jcloses[-1]["ledger"]
    some = [txid for txid, _b, _m in ledger.tx_entries()][:5]
    accounts = {r["account"] for t in some for r in [jax.get_transaction(t)]}
    for txid in some:
        assert port.get_transaction(txid) == jax.get_transaction(txid)
    for acct in accounts:
        for forward in (True, False):
            page = jax.account_transactions(acct, forward=forward, limit=3)
            assert port.account_transactions(acct, forward=forward, limit=3) == page
            if page:
                after = (page[-1]["ledger_seq"], page[-1]["txn_seq"])
                assert (port.account_transactions(acct, forward=forward, after=after)
                        == jax.account_transactions(acct, forward=forward, after=after))
    assert port.tx_history(start=3, limit=7) == jax.tx_history(start=3, limit=7)
    for seq in port.ledger_seqs():
        assert port.get_ledger_header(seq=seq) == jax.get_ledger_header(seq=seq)
    assert port.get_ledger_header() == jax.get_ledger_header()
    h = ledger.hash()
    assert port.get_ledger_header(ledger_hash=h) == jax.get_ledger_header(ledger_hash=h)
    assert port.ledger_seqs() == jax.ledger_seqs()
    lo, hi = port.ledger_seqs()[0], port.ledger_seqs()[-1]
    assert port.account_tx_index(lo, hi) == jax.account_tx_index(lo, hi)
    assert port.counts() == jax.counts()


def test_txdb_trim_and_validations_equal(tmp_path, persisted):
    jcloses, _jp, _jdb = persisted["jax"]
    got = {}
    for name, cls in (("port", TxDatabase), ("jax", JaxTxDatabase)):
        db = cls(str(tmp_path / f"{name}.db"))
        for c in jcloses:
            db.save_ledger(c["ledger"], jax_build_tx_rows(c["ledger"], c["results"]))
        db.save_validation(jcloses[0]["ledger"].hash(), b"\x02" * 33, 77, b"raw")
        db.save_header_dicts([{"hash": b"\x07" * 32, "seq": 9, "parent_hash": b"\x06" * 32,
                               "account_hash": b"\x05" * 32, "tx_hash": b"\x04" * 32}])
        trimmed = db.trim_below(jcloses[2]["seq"])
        got[name] = (trimmed, db.retain_floor, db.counts(), txdb_tables(db))
        db.close()
    assert got["port"] == got["jax"]


def test_clf_scoped_transaction_rolls_back(tmp_path):
    for cls in (LedgerSqlDatabase, JaxSql):
        db = cls(str(tmp_path / f"{cls.__module__}.db"))
        db.set_state("LastClosedLedger", b"\x01" * 32)
        with pytest.raises(RuntimeError):
            with db.transaction():
                db.set_state("LastClosedLedger", b"\x02" * 32)
                raise RuntimeError("crash mid-commit")
        assert db.get_state("LastClosedLedger") == b"\x01" * 32
        db.close()


def test_clf_out_of_lockstep_imports_whole_and_resumes(tmp_path, persisted):
    """A CLF whose pointer is not the parent's rebuilds from the full
    state (both packages alike), and load_last_known resumes the chain's
    last ledger from a node store."""
    jcloses, _jp, _jdb = persisted["jax"]
    lm = persisted["lm"]
    chains = {"jax": (jcloses[-2]["ledger"], jcloses[-1]["ledger"]),
              "port": tuple(lm.get_ledger_by_seq(c["seq"]) for c in jcloses[-2:])}
    got = {}
    for name, sql, mirror in (("port", LedgerSqlDatabase, CLFMirror), ("jax", JaxSql, JaxCLF)):
        prev, new = chains[name]
        clf = mirror(sql(str(tmp_path / f"{name}.clf")))
        clf.db.set_state("LastClosedLedger", b"\x99" * 32)
        clf.commit_ledger_close(new, prev)
        got[name] = (clf.full_imports, clf.commits, clf_tables(clf), clf.last_closed_hash)
        clf.db.close()
    assert got["port"] == got["jax"] and got["port"][0] == 1
    # resume: the port's CLF pointer over the port's node store
    _pc, pp, pdb = persisted["port"]
    led = pp.clf.load_last_known(pdb)
    assert led is not None and led.hash() == pp.clf.last_closed_hash == bytes.fromhex(
        jcloses[-1]["hash"])
    assert isinstance(led, Ledger)


def _seeded_pair(seed: int, n: int):
    """The same seeded edits through both packages' SHAMaps: a base
    tree, then a second version with sets, overwrites and deletes; some
    subtrees hashed, some not."""
    rng = random.Random(seed)
    keys = [hashlib.sha256(b"%d:%d" % (seed, i)).digest() for i in range(n)]
    sets = rng.sample(range(n), n // 10)
    dels = rng.sample(range(n), n // 20)
    out = {}
    for name, mod in (("port", port_shamap), ("jax", jax_shamap)):
        a = mod.SHAMap()
        a.bulk_update([mod.SHAMapItem(k, k * 2) for k in keys])
        if seed % 2:
            a.get_hash()  # hashed: shared subtrees are skipped by hash
        b = a.snapshot()
        b.bulk_update([mod.SHAMapItem(keys[i], b"new" + keys[i]) for i in sets]
                      + [mod.SHAMapItem(hashlib.sha256(b"x%d" % i).digest(), b"x")
                         for i in range(seed % 7)],
                      [keys[i] for i in dels if i not in sets])
        out[name] = (a, b)
    return out


def _plain(delta: dict) -> dict:
    return {k: tuple(None if it is None else (it.tag, it.data) for it in pair)
            for k, pair in delta.items()}


@pytest.mark.parametrize("seed", range(6))
def test_shamap_compare_equal_to_jax(seed):
    pair = _seeded_pair(seed, 600)
    (pa, pb), (ja, jb) = pair["port"], pair["jax"]
    for x, y, u, v in ((pb, pa, jb, ja), (pa, pb, ja, jb), (pa, pa, ja, ja)):
        assert _plain(x.compare(y)) == _plain(u.compare(v))
    delta = pb.compare(pa)
    assert delta and all((new is None) != (old is None) or new != old
                         for new, old in delta.values())
    with pytest.raises(ValueError):
        pb.compare(pa, limit=1)
