"""Relational history store: transactions + account index + ledger headers.

Reference: src/ripple_app/data (DatabaseCon over SQLite, schemas in
DBInit.cpp) — transaction.db holds Transactions and AccountTransactions
(the `account_tx` / `tx` RPC backing), ledger.db holds Ledgers headers.
SQLite here too (stdlib), WAL mode, single writer thread via the
JobQueue's jtWAL seam when file-backed.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Optional

from ..utils import sqlrows

__all__ = ["TxDatabase"]


class TxDatabase:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._in_batch = False
        # retention floor: rows strictly below this ledger seq were
        # deleted by trim_below (sql_trim rotation). account_tx uses it
        # to reject markers/windows pointing into trimmed history with
        # a clean lgrIdxInvalid instead of a silent empty page.
        self.retain_floor = 0
        cur = self._conn.cursor()
        cur.execute("PRAGMA journal_mode=WAL")
        # reference: DBInit.cpp TxnDBInit / LedgerDBInit
        cur.execute(
            """CREATE TABLE IF NOT EXISTS Transactions (
                 TransID TEXT PRIMARY KEY, TransType TEXT, FromAcct TEXT,
                 FromSeq INTEGER, LedgerSeq INTEGER, Status TEXT,
                 RawTxn BLOB, TxnMeta BLOB)"""
        )
        cur.execute(
            """CREATE TABLE IF NOT EXISTS AccountTransactions (
                 TransID TEXT, Account TEXT, LedgerSeq INTEGER,
                 TxnSeq INTEGER)"""
        )
        cur.execute(
            """CREATE INDEX IF NOT EXISTS AcctTxIndex ON
                 AccountTransactions(Account, LedgerSeq, TxnSeq)"""
        )
        # the per-row DELETE in save_transactions keys on TransID; without
        # this index it full-scans the table per tx — O(n^2) over a run
        # (reference: DBInit.cpp:62-63 AcctTxIDIndex)
        cur.execute(
            """CREATE INDEX IF NOT EXISTS AcctTxIDIndex ON
                 AccountTransactions(TransID)"""
        )
        # retention trimming deletes by ledger-seq range (reference:
        # DBInit.cpp TxLgrIndex / AcctTxLgrIndex back the same walk)
        cur.execute(
            """CREATE INDEX IF NOT EXISTS TxLgrIndex ON
                 Transactions(LedgerSeq)"""
        )
        cur.execute(
            """CREATE INDEX IF NOT EXISTS AcctTxLgrIndex ON
                 AccountTransactions(LedgerSeq)"""
        )
        cur.execute(
            """CREATE TABLE IF NOT EXISTS Ledgers (
                 LedgerHash TEXT PRIMARY KEY, LedgerSeq INTEGER,
                 PrevHash TEXT, TotalCoins INTEGER, ClosingTime INTEGER,
                 PrevClosingTime INTEGER, CloseTimeRes INTEGER,
                 CloseFlags INTEGER, AccountSetHash TEXT, TransSetHash TEXT)"""
        )
        cur.execute(
            """CREATE TABLE IF NOT EXISTS Validations (
                 LedgerHash TEXT, NodePubKey TEXT, SignTime INTEGER,
                 RawData BLOB)"""
        )
        self._conn.commit()

    def batch(self):
        """One commit for many writes (a closed ledger's tx set persists as
        a single SQLite transaction instead of a commit/fsync per tx)."""
        import contextlib

        @contextlib.contextmanager
        def _batch():
            with self._lock:
                self._in_batch = True
            try:
                yield self
                with self._lock:
                    self._conn.commit()
            finally:
                with self._lock:
                    self._in_batch = False

        return _batch()

    def _commit(self) -> None:
        if not self._in_batch:
            self._conn.commit()

    # -- transactions -----------------------------------------------------

    def save_transactions(self, rows: list[tuple]) -> None:
        """Persist a closed ledger's tx rows: three multi-row writes
        instead of 3+len(affected) executes per tx (sqlite statement
        dispatch was ~25% of the flood apply path). Each row is
        (txid, tx_type, account, seq, ledger_seq, status, raw, meta,
        affected_accounts, txn_seq)."""
        with self._lock:
            self._insert_tx_rows(rows)
            self._commit()

    def get_transaction(self, txid: bytes) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT TransType, FromAcct, FromSeq, LedgerSeq, Status, "
                "RawTxn, TxnMeta FROM Transactions WHERE TransID = ?",
                (txid.hex(),),
            ).fetchone()
        if row is None:
            return None
        return {
            "type": row[0],
            "account": bytes.fromhex(row[1]),
            "seq": row[2],
            "ledger_seq": row[3],
            "status": row[4],
            "raw": row[5],
            "meta": row[6],
        }

    def account_transactions(
        self,
        account: bytes,
        min_ledger: int = -1,
        max_ledger: int = 1 << 62,
        limit: int = 200,
        forward: bool = True,
        after: "tuple[int, int] | None" = None,
    ) -> list[dict]:
        """reference: handlers/AccountTx.cpp SQL walk. ``after`` is an
        EXCLUSIVE (ledger_seq, txn_seq) resume point in walk order (the
        marker/resumeToken role, AccountTx.cpp:91-93)."""
        order = "ASC" if forward else "DESC"
        resume = ""
        args: list = [account.hex(), min_ledger, max_ledger]
        if after is not None:
            al, at = int(after[0]), int(after[1])
            cmp = ">" if forward else "<"
            resume = (
                f" AND (A.LedgerSeq {cmp} ? OR "
                f"(A.LedgerSeq = ? AND A.TxnSeq {cmp} ?))"
            )
            args += [al, al, at]
        args.append(limit)
        with self._lock:
            rows = self._conn.execute(
                f"""SELECT T.TransID, T.TransType, T.FromAcct, T.FromSeq,
                     T.LedgerSeq, T.Status, T.RawTxn, T.TxnMeta, A.TxnSeq
                    FROM AccountTransactions A JOIN Transactions T
                      ON A.TransID = T.TransID
                    WHERE A.Account = ? AND A.LedgerSeq BETWEEN ? AND ?{resume}
                    ORDER BY A.LedgerSeq {order}, A.TxnSeq {order} LIMIT ?""",
                args,
            ).fetchall()
        return [
            {
                "txid": bytes.fromhex(r[0]),
                "type": r[1],
                "account": bytes.fromhex(r[2]),
                "seq": r[3],
                "ledger_seq": r[4],
                "status": r[5],
                "raw": r[6],
                "meta": r[7],
                "txn_seq": r[8],
            }
            for r in rows
        ]

    def tx_history(self, start: int = 0, limit: int = 20) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT TransID, TransType, FromAcct, FromSeq, LedgerSeq, "
                "Status, RawTxn, TxnMeta FROM Transactions "
                "ORDER BY LedgerSeq DESC LIMIT ? OFFSET ?",
                (limit, start),
            ).fetchall()
        return [
            {
                "txid": bytes.fromhex(r[0]),
                "type": r[1],
                "account": bytes.fromhex(r[2]),
                "seq": r[3],
                "ledger_seq": r[4],
                "status": r[5],
                "raw": r[6],
                "meta": r[7],
            }
            for r in rows
        ]

    # -- whole-ledger persist (close-pipeline txdb stage) -----------------

    def save_ledger(self, ledger, rows: list[tuple]) -> None:
        """Header + all tx rows in ONE sqlite transaction (one fsync per
        closed ledger instead of two, and a crash can never leave the
        header stored without its rows). `rows` is save_transactions'
        row shape, usually pre-materialized at close time."""
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO Ledgers VALUES (?,?,?,?,?,?,?,?,?,?)",
                self._header_row(ledger),
            )
            self._insert_tx_rows(rows)
            self._conn.commit()

    @staticmethod
    def _header_row(ledger) -> tuple:
        return (
            ledger.hash().hex(),
            ledger.seq,
            ledger.parent_hash.hex(),
            ledger.tot_coins,
            ledger.close_time,
            ledger.parent_close_time,
            ledger.close_resolution,
            ledger.close_flags,
            ledger.account_hash.hex(),
            ledger.tx_hash.hex(),
        )

    def _insert_tx_rows(self, rows: list[tuple]) -> None:
        """Three multi-row writes over pre-built rows; caller holds the
        lock and owns the commit."""
        tx_rows = []
        del_rows = []
        acct_rows = []
        for (txid, tx_type, account, seq, ledger_seq, status, raw, meta,
             affected, txn_seq) in rows:
            h = txid.hex()
            tx_rows.append((h, tx_type, account.hex(), seq, ledger_seq,
                            status, raw, meta))
            del_rows.append(h)
            for acct in affected:
                acct_rows.append((h, acct.hex(), ledger_seq, txn_seq))
        # multi-row statements (utils/sqlrows.py): the close pipeline's
        # worker steps once a chunk, not once a row, beside a busy thread
        sqlrows.insert_rows(self._conn, "INSERT OR REPLACE INTO Transactions VALUES",
                            tx_rows)
        sqlrows.delete_in(self._conn, "DELETE FROM AccountTransactions WHERE TransID IN",
                          del_rows)
        sqlrows.insert_rows(self._conn, "INSERT INTO AccountTransactions VALUES",
                            acct_rows)

    # -- ledger headers ---------------------------------------------------

    def save_ledger_header(self, ledger) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO Ledgers VALUES (?,?,?,?,?,?,?,?,?,?)",
                self._header_row(ledger),
            )
            self._commit()

    def save_header_dicts(self, headers: list[dict]) -> None:
        """Header rows from parsed header DICTS (state.ledger.parse_header
        keys plus ``hash``) — the shard-import feed holds raw header
        records, never Ledger objects. One transaction for the batch."""
        rows = [
            (
                h["hash"].hex(), h["seq"], h["parent_hash"].hex(),
                h.get("tot_coins", 0), h.get("close_time", 0),
                h.get("parent_close_time", 0),
                h.get("close_resolution", 0), h.get("close_flags", 0),
                h["account_hash"].hex(), h["tx_hash"].hex(),
            )
            for h in headers
        ]
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO Ledgers VALUES (?,?,?,?,?,?,?,?,?,?)",
                rows,
            )
            self._commit()

    def get_ledger_header(self, seq: Optional[int] = None,
                          ledger_hash: Optional[bytes] = None) -> Optional[dict]:
        q = "SELECT LedgerHash, LedgerSeq, PrevHash, TotalCoins, ClosingTime, \
             PrevClosingTime, CloseTimeRes, CloseFlags, AccountSetHash, \
             TransSetHash FROM Ledgers WHERE "
        arg: tuple
        if ledger_hash is not None:
            q += "LedgerHash = ?"
            arg = (ledger_hash.hex(),)
        elif seq is not None:
            q += "LedgerSeq = ?"
            arg = (seq,)
        else:
            # newest stored ledger (reference: getNewestLedgerInfo)
            q += "LedgerSeq = (SELECT MAX(LedgerSeq) FROM Ledgers)"
            arg = ()
        with self._lock:
            row = self._conn.execute(q, arg).fetchone()
        if row is None:
            return None
        return {
            "hash": bytes.fromhex(row[0]),
            "seq": row[1],
            "parent_hash": bytes.fromhex(row[2]),
            "total_coins": row[3],
            "close_time": row[4],
            "parent_close_time": row[5],
            "close_resolution": row[6],
            "close_flags": row[7],
            "account_hash": bytes.fromhex(row[8]),
            "tx_hash": bytes.fromhex(row[9]),
        }

    def ledger_seqs(self) -> list[int]:
        """All stored ledger sequences, ascending (gaps possible after an
        LCL switch — callers must not assume contiguity)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT LedgerSeq FROM Ledgers ORDER BY LedgerSeq"
            ).fetchall()
        return [r[0] for r in rows]

    def account_tx_index(self, min_ledger: int,
                         max_ledger: int) -> list[tuple]:
        """Export the account-tx index rows for seqs in [min, max] —
        (account_bytes, ledger_seq, txn_seq, txid_bytes) — the rows a
        history-shard seal captures BEFORE trim_below deletes them, so
        below-floor account_tx pages from cold storage with the same
        (ledger_seq, txn_seq) marker order."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT Account, LedgerSeq, TxnSeq, TransID "
                "FROM AccountTransactions "
                "WHERE LedgerSeq BETWEEN ? AND ? "
                "ORDER BY LedgerSeq, TxnSeq",
                (min_ledger, max_ledger),
            ).fetchall()
        return [
            (bytes.fromhex(r[0]), r[1], r[2], bytes.fromhex(r[3]))
            for r in rows
        ]

    def trim_below(self, ledger_seq: int) -> dict:
        """Delete transaction/ledger history rows STRICTLY below the
        retention horizon — the SQL half of online deletion (the
        NodeStore sweep bounds the tree store; without this the txdb
        mirror grows forever under [node_db] online_delete rotation).
        One transaction, then a WAL truncate so the file's high-water
        mark actually stops climbing. Returns rows deleted per table."""
        with self._lock:
            cur = self._conn.cursor()
            hashes = [
                r[0] for r in cur.execute(
                    "SELECT LedgerHash FROM Ledgers WHERE LedgerSeq < ?",
                    (ledger_seq,),
                )
            ]
            deleted = {}
            cur.executemany(
                "DELETE FROM Validations WHERE LedgerHash = ?",
                [(h,) for h in hashes],
            )
            deleted["validations"] = max(cur.rowcount, 0)
            cur.execute(
                "DELETE FROM Transactions WHERE LedgerSeq < ?",
                (ledger_seq,),
            )
            deleted["transactions"] = cur.rowcount
            cur.execute(
                "DELETE FROM AccountTransactions WHERE LedgerSeq < ?",
                (ledger_seq,),
            )
            deleted["account_transactions"] = cur.rowcount
            cur.execute(
                "DELETE FROM Ledgers WHERE LedgerSeq < ?", (ledger_seq,)
            )
            deleted["ledgers"] = cur.rowcount
            self._conn.commit()
            # the floor rises only once the deletion actually
            # committed: a failed trim must not lock out history whose
            # rows are all still present
            self.retain_floor = max(self.retain_floor, int(ledger_seq))
            # bound the WAL too: a delete-heavy transaction otherwise
            # leaves the whole trimmed range sitting in the -wal file
            cur.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        return deleted

    def counts(self) -> dict:
        """Row counts per table (observability + the disk-bound test)."""
        with self._lock:
            cur = self._conn.cursor()
            return {
                "transactions": cur.execute(
                    "SELECT COUNT(*) FROM Transactions"
                ).fetchone()[0],
                "account_transactions": cur.execute(
                    "SELECT COUNT(*) FROM AccountTransactions"
                ).fetchone()[0],
                "ledgers": cur.execute(
                    "SELECT COUNT(*) FROM Ledgers"
                ).fetchone()[0],
            }

    def save_validation(self, ledger_hash: bytes, node_public: bytes,
                        sign_time: int, raw: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO Validations VALUES (?,?,?,?)",
                (ledger_hash.hex(), node_public.hex(), sign_time, raw),
            )
            self._commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()
