"""Built-in NodeStore backends: memory, null, sqlite.

Reference: src/ripple_core/nodestore/backend/{Memory,Null}Factory.cpp and
src/ripple_app/node/SqliteFactory.cpp. The reference's LevelDB/RocksDB
roles are filled by sqlite-WAL here (stdlib, zero deps); the Backend seam
means a real LSM store can be registered without touching callers.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator, Optional

from .core import Backend, NodeObject, NodeObjectType, register_backend

__all__ = ["MemoryBackend", "NullBackend", "SqliteBackend"]


class MemoryBackend(Backend):
    """reference: backend/MemoryFactory.cpp"""

    name = "memory"

    def __init__(self, **_):
        self._map: dict[bytes, NodeObject] = {}
        self._lock = threading.Lock()

    def fetch(self, hash: bytes) -> Optional[NodeObject]:
        with self._lock:
            return self._map.get(hash)

    def store_batch(self, batch: list[NodeObject]) -> None:
        with self._lock:
            for obj in batch:
                self._map[obj.hash] = obj

    def iterate(self) -> Iterator[NodeObject]:
        with self._lock:
            objs = list(self._map.values())
        yield from objs


class NullBackend(Backend):
    """Discards everything (reference: backend/NullFactory.cpp)."""

    name = "null"

    def __init__(self, **_):
        pass

    def fetch(self, hash: bytes) -> Optional[NodeObject]:
        return None

    def store_batch(self, batch: list[NodeObject]) -> None:
        pass

    def iterate(self) -> Iterator[NodeObject]:
        return iter(())


class SqliteBackend(Backend):
    """Durable backend over sqlite WAL (reference:
    src/ripple_app/node/SqliteFactory.cpp — same schema shape: one table,
    hash primary key, type + blob columns).

    WAL hygiene: sqlite's passive autocheckpoint cannot keep up with a
    sustained store_batch flood (readers + back-to-back commits keep the
    WAL pinned), so the -wal file grows without bound. After every
    ``WAL_CHECKPOINT_BYTES`` of batched writes we force a
    ``wal_checkpoint(TRUNCATE)``, which blocks briefly but resets the
    WAL to zero — bounded disk beats a stall-free unbounded log.

    ``synchronous=`` is the ``[node_db]`` passthrough to PRAGMA
    synchronous (off|normal|full|extra) — the sqlite flavor of the
    segstore durability knob."""

    name = "sqlite"

    WAL_CHECKPOINT_BYTES = 16 << 20

    _SYNC_LEVELS = ("off", "normal", "full", "extra")

    def __init__(self, path: str = ":memory:", synchronous: str = "",
                 **_):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._path = path
        self._wal_bytes = 0
        self.wal_checkpoints = 0
        sync_level = (synchronous or "normal").lower()
        if sync_level not in self._SYNC_LEVELS:
            # a durability toggle must not fail open into a default
            raise ValueError(
                f"[node_db] synchronous must be one of "
                f"{self._SYNC_LEVELS}, got {synchronous!r}"
            )
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(f"PRAGMA synchronous={sync_level.upper()}")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS nodes ("
                " hash BLOB PRIMARY KEY, type INTEGER, data BLOB)"
            )
            self._conn.commit()

    def fetch(self, hash: bytes) -> Optional[NodeObject]:
        with self._lock:
            row = self._conn.execute(
                "SELECT type, data FROM nodes WHERE hash=?", (hash,)
            ).fetchone()
        if row is None:
            return None
        return NodeObject(NodeObjectType(row[0]), hash, row[1])

    def store_batch(self, batch: list[NodeObject]) -> None:
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO nodes (hash, type, data) VALUES (?,?,?)",
                [(o.hash, int(o.type), o.data) for o in batch],
            )
            self._conn.commit()
            self._wal_bytes += sum(len(o.data) + 40 for o in batch)
            if self._wal_bytes >= self.WAL_CHECKPOINT_BYTES:
                self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
                self._wal_bytes = 0
                self.wal_checkpoints += 1

    def iterate(self) -> Iterator[NodeObject]:
        with self._lock:
            rows = self._conn.execute("SELECT hash, type, data FROM nodes").fetchall()
        for h, t, d in rows:
            yield NodeObject(NodeObjectType(t), h, d)

    def get_json(self) -> dict:
        return {
            "backend": self.name,
            "wal_checkpoints": self.wal_checkpoints,
        }

    def close(self) -> None:
        with self._lock:
            try:
                self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            except sqlite3.Error:
                pass
            self._conn.close()


register_backend("memory", MemoryBackend)
register_backend("null", NullBackend)
register_backend("sqlite", SqliteBackend)


class CppLogBackend(Backend):
    """Native log-structured backend (native/src/nodestore.cc) — the
    C++ store filling the LevelDB/RocksDB role (SURVEY §2.8): append-only
    data log + in-memory hash index, replayed on open.

    ``compression="zlib"`` fills the snappy role (the reference vendors
    snappy for its LevelDB blocks): blobs are deflated before the append
    when that saves space, flagged in the record's type byte (high bit),
    so compressed and raw records coexist and old stores read unchanged.
    SHAMap inner nodes (child-hash vectors) are near-incompressible, but
    serialized account/tx leaves deflate well."""

    name = "cpplog"

    _ZLIB_FLAG = 0x80  # type-byte high bit: NodeObjectType is 0..4

    def __init__(self, path: str = "nodestore.cpplog",
                 compression: str = "", **_):
        from ..native import CppLogLib

        self._db = CppLogLib(path)
        self._path = path
        if compression not in ("", "none", "zlib"):
            raise ValueError(f"unknown nodestore compression {compression!r}")
        self._compress = compression == "zlib"

    def fetch(self, hash: bytes) -> Optional[NodeObject]:
        got = self._db.get(hash)
        if got is None:
            return None
        type_byte, blob = got
        if type_byte & self._ZLIB_FLAG:
            import zlib

            type_byte &= ~self._ZLIB_FLAG
            blob = zlib.decompress(blob)
        return NodeObject(NodeObjectType(type_byte), hash, blob)

    def store_batch(self, batch: list[NodeObject]) -> None:
        if self._compress:
            import zlib

            for obj in batch:
                packed = zlib.compress(obj.data, 1)
                if len(packed) < len(obj.data):
                    self._db.put(obj.hash, int(obj.type) | self._ZLIB_FLAG,
                                 packed)
                else:  # incompressible (e.g. inner-node hash vectors)
                    self._db.put(obj.hash, int(obj.type), obj.data)
        else:
            for obj in batch:
                self._db.put(obj.hash, int(obj.type), obj.data)
        self._db.sync()

    def iterate(self) -> Iterator[NodeObject]:
        """Full segment scan — online deletion, export, and the
        crash-recovery audits need iteration on every durable backend.
        Prefers the native callback scan (cpplog_iterate); ONLY a stale
        prebuilt library without the symbol falls back to parsing the
        log file directly (same record layout the replay reads) — a
        native scan error is corruption (an indexed record that cannot
        be read back) and must propagate, never silently degrade to a
        best-effort prefix of the records."""
        if getattr(self._db.lib, "has_cpplog_iterate", False):
            records = self._db.iterate()
        else:
            records = self._scan_log()
        for key, type_byte, blob in records:
            if type_byte & self._ZLIB_FLAG:
                import zlib

                type_byte &= ~self._ZLIB_FLAG
                blob = zlib.decompress(blob)
            yield NodeObject(NodeObjectType(type_byte), key, blob)

    def _scan_log(self):
        """Python fallback: parse the on-disk log
        ([u32 body_len | u8 flags | 32B key | u8 type | blob] records).
        sync() first so buffered appends are visible; content-addressed
        keys mean a duplicate record carries identical bytes, so
        first-wins matches the native index's behavior."""
        import struct

        self._db.sync()
        with open(self._path, "rb") as f:
            data = f.read()
        seen: set[bytes] = set()
        off = 0
        end = len(data)
        while off + 37 <= end:
            body_len = struct.unpack_from("<I", data, off)[0]
            if body_len < 1 or off + 37 + body_len > end:
                break  # torn tail
            key = data[off + 5: off + 37]
            if key not in seen:
                seen.add(key)
                yield (key, data[off + 37],
                       data[off + 38: off + 37 + body_len])
            off += 37 + body_len

    def get_json(self) -> dict:
        return {"backend": self.name, "objects": self._db.count()}

    def close(self) -> None:
        self._db.close()


# registered unconditionally: construction raises a clean error when the
# native toolchain is unavailable, and the one-time build cost lands on
# first use, never at import
register_backend("cpplog", CppLogBackend)
