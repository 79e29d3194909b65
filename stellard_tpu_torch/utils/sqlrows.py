"""Many rows in few SQLite statements.

Python's sqlite3 releases the GIL around every step of a statement (and
``executemany`` steps once a row), and a thread that gave the GIL up
waits up to the switch interval (5 ms) to take it back while another
thread runs Python. So a persist worker writing one row a step beside a
busy thread writes a few hundred rows a second. These helpers put as
many rows into one statement as SQLite's variable limit allows (at most
``MAX_ROWS``), so such a worker steps once a chunk. The rows land in the
given order, as one statement a row would land them.
"""

from __future__ import annotations

import sqlite3

__all__ = ["insert_rows", "delete_in", "rows_per_statement"]

MAX_ROWS = 4096


def rows_per_statement(conn: sqlite3.Connection, ncols: int) -> int:
    """Rows of ``ncols`` values that one statement on ``conn`` may bind."""
    limit = conn.getlimit(sqlite3.SQLITE_LIMIT_VARIABLE_NUMBER)
    return max(1, min(MAX_ROWS, limit // ncols))


def insert_rows(conn: sqlite3.Connection, head: str, rows: list[tuple]) -> None:
    """``head`` (``"INSERT OR REPLACE INTO t VALUES"``) over ``rows``,
    every row of one width, a multi-row VALUES list a chunk."""
    if not rows:
        return
    ncols = len(rows[0])
    k = rows_per_statement(conn, ncols)
    one = "(" + ",".join("?" * ncols) + ")"
    for i in range(0, len(rows), k):
        chunk = rows[i : i + k]
        conn.execute(f"{head} {','.join([one] * len(chunk))}",
                     [v for row in chunk for v in row])


def delete_in(conn: sqlite3.Connection, head: str, keys: list) -> None:
    """``head`` (``"DELETE FROM t WHERE c IN"``) over ``keys``, an IN
    list a chunk."""
    k = rows_per_statement(conn, 1)
    for i in range(0, len(keys), k):
        chunk = keys[i : i + k]
        conn.execute(f"{head} ({','.join('?' * len(chunk))})", chunk)
