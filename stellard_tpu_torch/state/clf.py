"""The Stellar CLF layer: canonical-ledger persistence + typed SQL mirror.

Role parity with the reference's second (Stellar-specific) ledger plane
(src/ledger/): alongside the rippled-style NodeStore, every
ledger close is committed to a SQL database in one atomic transaction —

- ``StoreState``: the last-closed-ledger hash and its serialized header
  (LedgerDatabase.h:10-63 kLastClosedLedger/kLastClosedLedgerContent),
- typed row mirrors of the ledger entries: ``accounts`` / ``trustlines``
  / ``offers`` (AccountEntry/TrustLine/OfferEntry.cpp), updated from the
  SHAMap delta between the previous and new ledger (LedgerMaster::catchUp,
  LegacyCLF::getDeltaSince) or rebuilt from a full ledger walk
  (importLedgerState).

The scoped-transaction rule is the crash-safety contract
(LedgerDatabase.h ScopedTransaction): either the whole close lands (state
hash + rows) or none of it does, so a kill -9 mid-commit resumes from the
previous consistent ledger.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Optional

from ..protocol.formats import LedgerEntryType
from ..protocol.sfields import (
    sfAccount,
    sfBalance,
    sfFlags,
    sfHighLimit,
    sfLedgerEntryType as _LE_TYPE_FIELD,
    sfLowLimit,
    sfOwnerCount,
    sfRegularKey,
    sfSequence,
    sfTakerGets,
    sfTakerPays,
)
from ..protocol.stobject import STObject
from ..utils import sqlrows

__all__ = ["LedgerSqlDatabase", "CLFMirror"]

_SCHEMA = [
    "PRAGMA journal_mode=WAL;",
    "PRAGMA synchronous=NORMAL;",
    """CREATE TABLE IF NOT EXISTS StoreState (
        StateName TEXT PRIMARY KEY,
        State     BLOB
    );""",
    """CREATE TABLE IF NOT EXISTS accounts (
        account_id  TEXT PRIMARY KEY,
        balance     INTEGER,
        sequence    INTEGER,
        owner_count INTEGER,
        flags       INTEGER,
        regular_key TEXT
    );""",
    """CREATE TABLE IF NOT EXISTS trustlines (
        index_hex   TEXT PRIMARY KEY,
        low_account  TEXT,
        high_account TEXT,
        currency    TEXT,
        balance_str TEXT,
        low_limit   TEXT,
        high_limit  TEXT,
        flags       INTEGER
    );""",
    """CREATE TABLE IF NOT EXISTS offers (
        index_hex   TEXT PRIMARY KEY,
        account_id  TEXT,
        sequence    INTEGER,
        taker_pays  TEXT,
        taker_gets  TEXT,
        flags       INTEGER
    );""",
    "CREATE INDEX IF NOT EXISTS offers_by_account ON offers(account_id);",
    "CREATE INDEX IF NOT EXISTS lines_by_low ON trustlines(low_account);",
    "CREATE INDEX IF NOT EXISTS lines_by_high ON trustlines(high_account);",
]

K_LCL_HASH = "LastClosedLedger"
K_LCL_CONTENT = "LastClosedLedgerContent"


_UPSERT = {
    "accounts": "INSERT OR REPLACE INTO accounts VALUES",
    "trustlines": "INSERT OR REPLACE INTO trustlines VALUES",
    "offers": "INSERT OR REPLACE INTO offers VALUES",
}
_DELETE = {
    "accounts": "DELETE FROM accounts WHERE account_id IN",
    "trustlines": "DELETE FROM trustlines WHERE index_hex IN",
    "offers": "DELETE FROM offers WHERE index_hex IN",
}


def _entry_row(index: bytes, sle: STObject) -> Optional[tuple[str, tuple]]:
    """(table, row) of an entry's typed mirror; None for the
    directory/amendment/fee singletons, which have no row (reference
    LedgerEntry::makeEntry returns null for them too)."""
    letype = LedgerEntryType(sle[_LE_TYPE_FIELD])
    if letype == LedgerEntryType.ltACCOUNT_ROOT:
        return "accounts", (
            sle[sfAccount].hex(),
            sle[sfBalance].drops(),
            sle.get(sfSequence, 0),
            sle.get(sfOwnerCount, 0),
            sle.get(sfFlags, 0),
            (sle.get(sfRegularKey) or b"").hex(),
        )
    if letype == LedgerEntryType.ltRIPPLE_STATE:
        low = sle[sfLowLimit]
        high = sle[sfHighLimit]
        return "trustlines", (
            index.hex(),
            low.issuer.hex(),
            high.issuer.hex(),
            low.currency.hex(),
            sle[sfBalance].value_text(),
            low.value_text(),
            high.value_text(),
            sle.get(sfFlags, 0),
        )
    if letype == LedgerEntryType.ltOFFER:
        return "offers", (
            index.hex(),
            sle[sfAccount].hex(),
            sle.get(sfSequence, 0),
            repr(sle[sfTakerPays]),
            repr(sle[sfTakerGets]),
            sle.get(sfFlags, 0),
        )
    return None


class LedgerSqlDatabase:
    """SQLite CLF store with explicit scoped transactions."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        # autocommit mode: transaction boundaries are ONLY the explicit
        # BEGIN/COMMIT of the scoped transaction (python sqlite3's
        # implicit-BEGIN magic would otherwise fight the scope)
        self._conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None
        )
        self._lock = threading.RLock()
        with self._lock:
            for stmt in _SCHEMA:
                self._conn.execute(stmt)

    # -- state store ------------------------------------------------------

    def get_state(self, name: str) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT State FROM StoreState WHERE StateName=?", (name,)
            ).fetchone()
        return row[0] if row else None

    def set_state(self, name: str, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO StoreState (StateName, State) VALUES (?, ?)",
                (name, value),
            )

    # -- scoped transaction ----------------------------------------------

    def transaction(self):
        """`with db.transaction():` — commit on clean exit, rollback on
        exception (the reference ScopedTransaction contract)."""
        return _Scoped(self)

    # -- typed rows --------------------------------------------------------

    def store_entry(self, index: bytes, sle: STObject) -> None:
        entry = _entry_row(index, sle)
        if entry is not None:
            table, row = entry
            with self._lock:
                sqlrows.insert_rows(self._conn, _UPSERT[table], [row])

    def store_entries(self, entries) -> None:
        """store_entry over (index, sle) pairs, a table's rows in chunks
        of multi-row statements (utils/sqlrows.py): the full import's
        million rows step a few hundred times, not once a row."""
        pending: dict[str, list] = {table: [] for table in _UPSERT}
        with self._lock:
            for index, sle in entries:
                entry = _entry_row(index, sle)
                if entry is None:
                    continue
                rows = pending[entry[0]]
                rows.append(entry[1])
                if len(rows) >= sqlrows.MAX_ROWS:
                    sqlrows.insert_rows(self._conn, _UPSERT[entry[0]], rows)
                    rows.clear()
            for table, rows in pending.items():
                sqlrows.insert_rows(self._conn, _UPSERT[table], rows)

    def delete_entry(self, index: bytes, sle: STObject) -> None:
        self.delete_entries([(index, sle)])

    def delete_entries(self, entries) -> None:
        """delete_entry over (index, sle) pairs, an IN list a table."""
        keys: dict[str, list] = {table: [] for table in _DELETE}
        for index, sle in entries:
            letype = LedgerEntryType(sle[_LE_TYPE_FIELD])
            if letype == LedgerEntryType.ltACCOUNT_ROOT:
                keys["accounts"].append(sle[sfAccount].hex())
            elif letype == LedgerEntryType.ltRIPPLE_STATE:
                keys["trustlines"].append(index.hex())
            elif letype == LedgerEntryType.ltOFFER:
                keys["offers"].append(index.hex())
        with self._lock:
            for table, ks in keys.items():
                sqlrows.delete_in(self._conn, _DELETE[table], ks)

    def drop_all_entries(self) -> None:
        with self._lock:
            for table in ("accounts", "trustlines", "offers"):
                self._conn.execute(f"DELETE FROM {table}")

    def count(self, table: str) -> int:
        with self._lock:
            return self._conn.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]

    def query(self, sql: str, args: tuple = ()) -> list:
        with self._lock:
            return self._conn.execute(sql, args).fetchall()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class _Scoped:
    def __init__(self, db: LedgerSqlDatabase):
        self.db = db

    def __enter__(self):
        self.db._lock.acquire()
        self.db._conn.execute("BEGIN")
        return self.db

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.db._conn.commit()
            else:
                self.db._conn.rollback()
        finally:
            self.db._lock.release()
        return False


class CLFMirror:
    """The stellar::LedgerMaster role: keep the SQL mirror in lockstep
    with the closed-ledger chain."""

    def __init__(self, db: LedgerSqlDatabase):
        self.db = db
        self.commits = 0
        self.full_imports = 0

    @property
    def last_closed_hash(self) -> Optional[bytes]:
        raw = self.db.get_state(K_LCL_HASH)
        return raw if raw else None

    # -- close commit -------------------------------------------------------

    def commit_ledger_close(self, new_ledger, prev_ledger=None) -> None:
        """One atomic SQL transaction: entry-row delta + LCL state
        (reference: commitLedgerClose → catchUp → updateDBFromLedger)."""
        stored = self.last_closed_hash
        if prev_ledger is None or stored != prev_ledger.hash():
            # mirror out of lockstep (fresh db, or we skipped ledgers):
            # rebuild from the full state walk
            self.import_ledger_state(new_ledger)
            return
        delta = new_ledger.state_map.compare(prev_ledger.state_map)
        stores, deletes = [], []
        for tag, (new_item, old_item) in delta.items():
            # the engine pinned a parsed mirror on every item it
            # wrote (Ledger.write_entry); reuse it — re-parsing every
            # changed entry was the commit's dominant Python cost,
            # and on the close-pipeline worker it stole GIL time
            # from the next ledger's apply
            item, out = (new_item, stores) if new_item is not None else (old_item, deletes)
            if item is not None:
                sle = item.parsed
                out.append((tag, sle if sle is not None else STObject.from_bytes(item.data)))
        # each entry is one row of one table (an account's row is keyed by
        # its AccountRoot's tag), so the deletes and the stores touch
        # different rows and go as two batches (utils/sqlrows.py)
        with self.db.transaction():
            self.db.delete_entries(deletes)
            self.db.store_entries(stores)
            self._write_lcl_state(new_ledger)
        self.commits += 1

    def import_ledger_state(self, ledger) -> None:
        """Full rebuild (reference importLedgerState): drop rows, walk the
        whole state tree, then swap the LCL pointer — atomically."""
        with self.db.transaction():
            self.db.drop_all_entries()
            self.db.store_entries(
                (item.tag,
                 item.parsed if item.parsed is not None else STObject.from_bytes(item.data))
                for item in ledger.state_map.items())
            self._write_lcl_state(ledger)
        self.full_imports += 1

    def _write_lcl_state(self, ledger) -> None:
        self.db.set_state(K_LCL_HASH, ledger.hash())
        self.db.set_state(K_LCL_CONTENT, ledger.header_bytes())

    # -- resume -------------------------------------------------------------

    def load_last_known(self, nodestore, hash_batch=None, lazy=False):
        """reference loadLastKnownCLF: resume the chain from the SQL state
        pointer, rebuilding the ledger from the NodeStore; returns the
        Ledger or None when there is nothing (or something broken) saved.
        `lazy` opens the trees with on-demand node faulting (O(1) boot
        regardless of state size, out-of-core plane)."""
        from .ledger import Ledger

        lkcl = self.last_closed_hash
        if not lkcl:
            return None
        try:
            led = Ledger.load(nodestore, lkcl, hash_batch=hash_batch,
                              lazy=lazy)
        except (KeyError, ValueError):
            return None
        return led

    def get_json(self) -> dict:
        return {
            "last_closed": (self.last_closed_hash or b"").hex(),
            "accounts": self.db.count("accounts"),
            "trustlines": self.db.count("trustlines"),
            "offers": self.db.count("offers"),
            "commits": self.commits,
            "full_imports": self.full_imports,
        }
