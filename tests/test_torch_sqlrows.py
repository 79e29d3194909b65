"""The port's multi-row SQLite writes (utils/sqlrows.py) leave the same
tables as one statement a row, across chunk edges and with repeated
keys, and the CLF's full import and the txdb's rows written through
them equal the JAX package's."""

import os
import sqlite3
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from stellard_tpu_torch.utils import sqlrows  # noqa: E402


def _db(limit=None):
    c = sqlite3.connect(":memory:")
    c.execute("CREATE TABLE t (k TEXT PRIMARY KEY, a INTEGER, b BLOB)")
    c.execute("CREATE TABLE u (k TEXT, v INTEGER)")
    if limit is not None:
        c.setlimit(sqlite3.SQLITE_LIMIT_VARIABLE_NUMBER, limit)
    return c


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    keys = [f"k{int(x)}" for x in rng.integers(0, n // 2, n)]  # repeats
    return [(k, int(i), rng.bytes(int(rng.integers(0, 9)))) for i, k in enumerate(keys)]


@pytest.mark.parametrize("limit", [None, 7, 3])
def test_insert_rows_equals_one_statement_a_row(limit):
    rows = _rows(1, 500)
    want, got = _db(), _db(limit)
    for r in rows:
        want.execute("INSERT OR REPLACE INTO t VALUES (?,?,?)", r)
        want.execute("INSERT INTO u VALUES (?,?)", r[:2])
    sqlrows.insert_rows(got, "INSERT OR REPLACE INTO t VALUES", rows)
    sqlrows.insert_rows(got, "INSERT INTO u VALUES", [r[:2] for r in rows])
    for q in ("SELECT * FROM t ORDER BY k", "SELECT rowid, * FROM u ORDER BY rowid"):
        assert got.execute(q).fetchall() == want.execute(q).fetchall()
    vars_ = got.getlimit(sqlite3.SQLITE_LIMIT_VARIABLE_NUMBER)
    assert sqlrows.rows_per_statement(got, 3) == max(1, min(sqlrows.MAX_ROWS, vars_ // 3))


@pytest.mark.parametrize("limit", [None, 5, 1])
def test_delete_in_equals_one_statement_a_key(limit):
    rows = [r[:2] for r in _rows(2, 300)]
    keys = sorted({k for k, _v in rows})[::3] + ["absent"]
    want, got = _db(), _db()
    for c in (want, got):
        c.executemany("INSERT INTO u VALUES (?,?)", rows)
    if limit is not None:
        got.setlimit(sqlite3.SQLITE_LIMIT_VARIABLE_NUMBER, limit)
    for k in keys:
        want.execute("DELETE FROM u WHERE k = ?", (k,))
    sqlrows.delete_in(got, "DELETE FROM u WHERE k IN", keys)
    q = "SELECT rowid, * FROM u ORDER BY rowid"
    assert got.execute(q).fetchall() == want.execute(q).fetchall()
    sqlrows.insert_rows(got, "INSERT INTO u VALUES", [])
    sqlrows.delete_in(got, "DELETE FROM u WHERE k IN", [])
    assert got.execute(q).fetchall() == want.execute(q).fetchall()


def _state_entries(seed):
    """(index, SLE bytes) of AccountRoots, trust lines and offers, the
    same entries built with either package."""
    from stellard_tpu.protocol.stamount import STAmount
    from stellard_tpu.protocol.formats import LedgerEntryType as LT
    from stellard_tpu.protocol import sfields as sf
    from stellard_tpu.protocol.stobject import STObject

    rng = np.random.default_rng(seed)
    out = []
    for i in range(300):
        o = STObject()
        kind = i % 3
        acct = rng.bytes(20)
        if kind == 0:
            o[sf.sfLedgerEntryType] = int(LT.ltACCOUNT_ROOT)
            o[sf.sfAccount] = acct
            o[sf.sfBalance] = STAmount.from_drops(int(rng.integers(1, 10**12)))
            o[sf.sfSequence] = int(rng.integers(1, 100))
            o[sf.sfFlags] = 0
            o[sf.sfOwnerCount] = int(rng.integers(0, 5))
            if i % 2:
                o[sf.sfRegularKey] = rng.bytes(20)
        elif kind == 1:
            cur = b"\x00" * 12 + b"USD" + b"\x00" * 5
            o[sf.sfLedgerEntryType] = int(LT.ltRIPPLE_STATE)
            o[sf.sfBalance] = STAmount.from_iou(cur, b"\x01" * 20, int(rng.integers(0, 999)), -2)
            o[sf.sfLowLimit] = STAmount.from_iou(cur, acct, 100, 0)
            o[sf.sfHighLimit] = STAmount.from_iou(cur, rng.bytes(20), 0, 0)
            o[sf.sfFlags] = 0
        else:
            cur = b"\x00" * 12 + b"EUR" + b"\x00" * 5
            o[sf.sfLedgerEntryType] = int(LT.ltOFFER)
            o[sf.sfAccount] = acct
            o[sf.sfSequence] = int(rng.integers(1, 100))
            o[sf.sfTakerPays] = STAmount.from_drops(int(rng.integers(1, 10**9)))
            o[sf.sfTakerGets] = STAmount.from_iou(cur, rng.bytes(20), int(rng.integers(1, 999)), 0)
            o[sf.sfFlags] = 0
        out.append((rng.bytes(32), o.serialize()))
    return out


def test_clf_store_entries_equal_jax_store_entry(monkeypatch):
    """The port's batched writes (store_entries, delete_entries; small
    chunks) leave the rows the JAX package's store_entry and
    delete_entry leave one at a time."""
    from stellard_tpu.state.clf import LedgerSqlDatabase as JaxDb
    from stellard_tpu.protocol.stobject import STObject as JaxObject
    from stellard_tpu_torch.state.clf import LedgerSqlDatabase as PortDb
    from stellard_tpu_torch.protocol.stobject import STObject as PortObject

    monkeypatch.setattr(sqlrows, "MAX_ROWS", 16)
    entries = _state_entries(3)
    jax, port = JaxDb(), PortDb()
    with jax.transaction():
        for index, blob in entries:
            jax.store_entry(index, JaxObject.from_bytes(blob))
    with port.transaction():
        port.store_entries((index, PortObject.from_bytes(blob)) for index, blob in entries)
    for table in ("accounts", "trustlines", "offers"):
        q = f"SELECT * FROM {table} ORDER BY 1"
        assert port.query(q) == jax.query(q)
        assert port.count(table) == 100
    gone = entries[::4]
    with jax.transaction():
        for index, blob in gone:
            jax.delete_entry(index, JaxObject.from_bytes(blob))
    with port.transaction():
        port.delete_entries((index, PortObject.from_bytes(blob)) for index, blob in gone)
    for table in ("accounts", "trustlines", "offers"):
        q = f"SELECT * FROM {table} ORDER BY 1"
        assert port.query(q) == jax.query(q)
        assert port.count(table) == 75


def test_txdb_rows_equal_jax(monkeypatch):
    """The port's txdb rows, written as multi-row statements (small
    chunks), equal the JAX package's executemany rows, with a ledger's
    transactions saved again (its account rows deleted and rewritten)."""
    from stellard_tpu.node.txdb import TxDatabase as JaxTxDb
    from stellard_tpu_torch.node.txdb import TxDatabase as PortTxDb

    monkeypatch.setattr(sqlrows, "MAX_ROWS", 16)
    rng = np.random.default_rng(4)
    accounts = [rng.bytes(20) for _ in range(12)]

    def rows(seq, n):
        return [(rng.bytes(32), "ttPAYMENT", accounts[int(rng.integers(12))],
                 int(rng.integers(1, 50)), seq, "tesSUCCESS", rng.bytes(40), rng.bytes(60),
                 [accounts[int(j)] for j in rng.integers(0, 12, int(rng.integers(1, 4)))], i)
                for i in range(n)]

    batches = [rows(5, 70), rows(6, 45)]
    batches.append(batches[0][:30])  # saved again
    jax, port = JaxTxDb(), PortTxDb()
    for b in batches:
        jax.save_transactions(b)
        port.save_transactions(b)
    for q in ("SELECT * FROM Transactions ORDER BY TransID",
              "SELECT rowid, * FROM AccountTransactions ORDER BY rowid"):
        assert port._conn.execute(q).fetchall() == jax._conn.execute(q).fetchall()
