"""History shards: trimmed ledger ranges sealed as offline-verifiable
cold-storage units (rippled's history-shard role: online deletion's
*trimming* turned into *tiering*).

Online deletion bounds a validator's disk near the live set by sweeping
nodes only reachable from ledgers below the retain floor — which also
makes deep ``account_tx`` and cold-node catch-up below the floor
unanswerable (``lgrIdxInvalid``). With ``[node_db] shards=<dir>`` the
retired range is SEALED into a shard file *before* the sweep deletes
it, so history tiers to cold storage instead of vanishing:

- **record section**: every node that was about to be swept (ledger
  headers, state/tx tree nodes), in the exact segstore record layout
  ``[u32 body_len LE | u8 flags | 32B key | u8 type | blob]`` — the
  same self-verifying bytes (key == SHA-512-half(blob)) the
  ``fetch_segment``/GetSegments catch-up door already moves, so a cold
  node ingests shards with the machinery it already has
  (node/inbound.SegmentCatchup, unchanged);
- **account index**: ``(account, ledger_seq, txn_seq, txid)`` rows
  exported from the txdb SQL mirror before ``trim_below`` drops them,
  so ``account_tx`` below the floor routes here (rpc/handlers.py) and
  pages with the same marker semantics;
- **offline verification contract** (doc/storage.md): per-record
  content hashes, a whole-file CRC, and the header chain — every seq
  in [lo, hi] has a stored header and consecutive headers link by
  parent_hash — are all checkable from the file alone, no live node.

``CombinedSegmentSource`` splices shards into the segment manifest
(ids offset by ``SHARD_SEG_BASE``) so a cold node whose serving peer
has trimmed a range syncs it from shards over the SAME wire path.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Iterator, Optional

from ..utils.hashes import (
    HP_INNER_NODE, HP_LEAF_NODE, HP_LEDGER_MASTER, HP_TX_NODE, HP_TXN_ID,
    sha512_half,
)

__all__ = [
    "HistoryShardStore", "CombinedSegmentSource", "collect_retired",
    "mark_live", "rotate_into_shards", "verify_shard_blob",
    "SHARD_SEG_BASE", "SHARD_FILE_BASE",
]

_MAGIC = b"SHARD1\x00\x00"
_VERSION = 1
_HDR = struct.Struct("<IIIQQQQ")  # version, lo, hi, rec_off/len, acct_off/len
_HDR_SIZE = len(_MAGIC) + _HDR.size + 64  # + first/last ledger hash
_ACCT_ROW = struct.Struct("<20sII32s")  # account, ledger_seq, txn_seq, txid
_REC_HEADER = 37  # u32 body_len + u8 flags + 32B key (segstore layout)

# manifest-id offset for shard rows in the combined GetSegments door:
# far above any plausible segstore segment id, well below the 44-bit
# loc shift, so the two id spaces can never collide
SHARD_SEG_BASE = 1 << 30

# id offset for the WHOLE-FILE shard distribution door (archive
# backfill): ``SHARD_FILE_BASE + sid`` serves the complete shard file
# (header + records + account index + CRC) so a fetching archive can
# run the full offline-verification contract against the transferred
# image before installing it. Disjoint from — and above — the
# record-section id space at SHARD_SEG_BASE.
SHARD_FILE_BASE = 1 << 31

# NodeObjectType values (nodestore.core) — plain ints here so the shard
# format is self-contained for offline verifiers
_T_LEDGER = 1
_T_ACCOUNT_NODE = 3
_T_TRANSACTION_NODE = 4


def _pack_records(records: list) -> bytes:
    """[(key, type_byte, blob)] -> segstore-layout record image."""
    out = bytearray()
    for key, type_byte, blob in records:
        out += struct.pack("<IB", len(blob) + 1, 0)
        out += key
        out.append(type_byte & 0xFF)
        out += blob
    return bytes(out)


def _iter_records_py(data: bytes) -> Iterator[tuple[bytes, int, int, int]]:
    """(key, type, blob_off, blob_len) per clean record in `data`."""
    off, end = 0, len(data)
    while off + _REC_HEADER <= end:
        body_len = struct.unpack_from("<I", data, off)[0]
        if body_len < 1 or off + _REC_HEADER + body_len > end:
            break
        yield (
            data[off + 5: off + 37],
            data[off + _REC_HEADER],
            off + _REC_HEADER + 1,
            body_len - 1,
        )
        off += _REC_HEADER + body_len


def collect_retired(fetch, headers: list[dict], live: set,
                    ) -> list[tuple[bytes, int, bytes]]:
    """Gather every node of the retiring ledgers that the sweep is about
    to delete: walk each header's state/tx tree through raw stored
    blobs (no SHAMap materialization — the ledgercleaner mark walk's
    shape), keeping nodes NOT in `live` (nodes shared with retained
    ledgers stay in the live store and need no cold copy). `fetch` is
    ``hash -> blob|None``; `headers` rows are txdb ``get_ledger_header``
    dicts. Returns [(key, type_byte, blob)] with headers first — a
    shard is self-describing even when its trees share everything."""
    from ..state.shamap import ZERO256

    inner_prefix = HP_INNER_NODE.to_bytes(4, "big")
    out: list[tuple[bytes, int, bytes]] = []
    seen: set[bytes] = set()

    def walk(root_hash: bytes, type_byte: int) -> None:
        stack = [root_hash]
        while stack:
            h = stack.pop()
            if h == ZERO256 or h in seen or h in live:
                continue
            seen.add(h)
            blob = fetch(h)
            if blob is None:
                continue  # history gap: seal what exists
            out.append((h, type_byte, blob))
            if blob[:4] == inner_prefix:
                for i in range(16):
                    stack.append(blob[4 + 32 * i: 36 + 32 * i])

    for hdr in headers:
        h = hdr["hash"]
        if h not in seen:
            blob = fetch(h)
            if blob is not None:
                seen.add(h)
                out.append((h, _T_LEDGER, blob))
    for hdr in headers:
        walk(hdr["account_hash"], _T_ACCOUNT_NODE)
        walk(hdr["tx_hash"], _T_TRANSACTION_NODE)
    return out


def mark_live(fetch, headers: list[dict], live: set) -> None:
    """Add every node reachable from `headers`' roots (plus the header
    objects) to `live` — the retained-set mark walk in fetch-callable
    form, shared by the testkit's in-scenario rotation."""
    from ..state.shamap import ZERO256

    inner_prefix = HP_INNER_NODE.to_bytes(4, "big")
    for hdr in headers:
        live.add(hdr["hash"])
        for root in (hdr["account_hash"], hdr["tx_hash"]):
            stack = [root]
            while stack:
                h = stack.pop()
                if h == ZERO256 or h in live:
                    continue
                blob = fetch(h)
                if blob is None:
                    continue
                live.add(h)
                if blob[:4] == inner_prefix:
                    for i in range(16):
                        stack.append(blob[4 + 32 * i: 36 + 32 * i])


def verify_shard_blob(blob: bytes) -> dict:
    """The offline verification contract run against RAW SHARD BYTES
    alone — the archive-import gate (doc/archive.md). Checks magic +
    header geometry, the whole-file CRC, every record's content hash,
    and the lo..hi ledger-header chain anchored at the header's
    first/last ledger hashes; the records count is DERIVED during the
    pass (it lives in the store index, not the file), so a fetched
    image is installable without trusting anything but its bytes. On
    success the report carries the parsed geometry (`lo`/`hi`/
    `rec_off`/`rec_len`/`acct_off`/`acct_len`/`records`/`first_hash`/
    `last_hash`) an importer needs to index the file."""
    report: dict = {"ok": False}
    if len(blob) < _HDR_SIZE + 4 or blob[:8] != _MAGIC:
        report["error"] = "bad magic/size"
        return report
    version, lo, hi, rec_off, rec_len, acct_off, acct_len = \
        _HDR.unpack_from(blob, len(_MAGIC))
    first_hash = blob[len(_MAGIC) + _HDR.size: len(_MAGIC) + _HDR.size + 32]
    last_hash = blob[len(_MAGIC) + _HDR.size + 32: _HDR_SIZE]
    report.update({"lo": lo, "hi": hi})
    if version != _VERSION:
        report["error"] = "bad version"
        return report
    if not (0 < lo <= hi):
        report["error"] = "bad range"
        return report
    if (rec_off != _HDR_SIZE or acct_off != rec_off + rec_len
            or acct_len < 4 or acct_off + acct_len + 4 != len(blob)):
        report["error"] = "bad geometry"
        return report
    body, crc = blob[:-4], struct.unpack("<I", blob[-4:])[0]
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        report["error"] = "crc mismatch"
        return report
    (n_acct,) = struct.unpack_from("<I", blob, acct_off)
    if 4 + n_acct * _ACCT_ROW.size != acct_len:
        report["error"] = "bad acct index"
        return report
    rec_img = blob[rec_off: rec_off + rec_len]
    n_checked = bad = consumed = 0
    headers: dict[int, dict] = {}
    ledger_prefix = HP_LEDGER_MASTER.to_bytes(4, "big")
    for key, type_byte, off, ln in _iter_records_py(rec_img):
        node = rec_img[off: off + ln]
        if sha512_half(node) != key:
            bad += 1
        n_checked += 1
        consumed = off + ln
        if type_byte == _T_LEDGER and node[:4] == ledger_prefix:
            from ..state.ledger import parse_header

            h = parse_header(node[4:])
            headers[h["seq"]] = {
                "hash": key, "parent_hash": h["parent_hash"],
            }
    report["records"] = n_checked
    report["bad_records"] = bad
    chain_ok = True
    for seq in range(lo, hi + 1):
        if seq not in headers:
            chain_ok = False
            break
        if seq > lo and \
                headers[seq]["parent_hash"] != headers[seq - 1]["hash"]:
            chain_ok = False
            break
    report["header_chain_ok"] = chain_ok
    report["first_hash_ok"] = headers.get(lo, {}).get("hash") == first_hash
    report["last_hash_ok"] = headers.get(hi, {}).get("hash") == last_hash
    report["ok"] = (
        bad == 0 and consumed == rec_len and chain_ok
        and report["first_hash_ok"] and report["last_hash_ok"]
    )
    if report["ok"]:
        report.update({
            "rec_off": rec_off, "rec_len": rec_len,
            "acct_off": acct_off, "acct_len": acct_len,
            "first_hash": first_hash, "last_hash": last_hash,
        })
    elif "error" not in report:
        report["error"] = "content verification failed"
    return report


class _Shard:
    __slots__ = ("sid", "path", "lo", "hi", "rec_off", "rec_len",
                 "acct_off", "acct_len", "records", "bytes",
                 "first_hash", "last_hash", "_txid_index")

    def __init__(self, sid, path, lo, hi, rec_off, rec_len, acct_off,
                 acct_len, records, nbytes, first_hash, last_hash):
        self.sid = sid
        self.path = path
        self.lo = lo
        self.hi = hi
        self.rec_off = rec_off
        self.rec_len = rec_len
        self.acct_off = acct_off
        self.acct_len = acct_len
        self.records = records
        self.bytes = nbytes
        self.first_hash = first_hash
        self.last_hash = last_hash
        self._txid_index: Optional[dict] = None  # txid -> (blob_off, len)


class HistoryShardStore:
    """Directory of sealed shard files + a JSON index (``shards.json``).

    Thread-safe: sealing happens on the close pipeline's drain worker,
    reads come from RPC threads and the overlay serving path."""

    INDEX_NAME = "shards.json"

    def __init__(self, path: str):
        self.root = path
        os.makedirs(path, exist_ok=True)
        self._lock = threading.RLock()
        self._shards: dict[int, _Shard] = {}
        self._fds: dict[int, int] = {}
        # counters (get_counts.history_shards)
        self.sealed = 0
        self.sealed_records = 0
        self.sealed_bytes = 0
        self.segment_reads = 0
        self.account_tx_queries = 0
        self.account_tx_rows = 0
        self.tx_faults = 0
        self.verifies = 0
        # archive-backfill import counters
        self.imported = 0
        self.imported_bytes = 0
        self.import_rejects = 0
        self._load_index()

    # -- open --------------------------------------------------------------

    def _index_path(self) -> str:
        return os.path.join(self.root, self.INDEX_NAME)

    def _load_index(self) -> None:
        try:
            with open(self._index_path()) as f:
                idx = json.load(f)
        except (OSError, ValueError):
            idx = {"shards": []}
        for row in idx.get("shards", []):
            path = os.path.join(self.root, row["file"])
            if not os.path.exists(path):
                continue  # manual deletion: drop the row, keep the rest
            sh = _Shard(
                int(row["id"]), path, int(row["lo"]), int(row["hi"]),
                int(row["rec_off"]), int(row["rec_len"]),
                int(row["acct_off"]), int(row["acct_len"]),
                int(row["records"]), int(row["bytes"]),
                bytes.fromhex(row["first_hash"]),
                bytes.fromhex(row["last_hash"]),
            )
            self._shards[sh.sid] = sh

    def _write_index_locked(self) -> None:
        rows = [
            {
                "id": sh.sid, "file": os.path.basename(sh.path),
                "lo": sh.lo, "hi": sh.hi,
                "rec_off": sh.rec_off, "rec_len": sh.rec_len,
                "acct_off": sh.acct_off, "acct_len": sh.acct_len,
                "records": sh.records, "bytes": sh.bytes,
                "first_hash": sh.first_hash.hex(),
                "last_hash": sh.last_hash.hex(),
            }
            for sh in sorted(self._shards.values(), key=lambda s: s.sid)
        ]
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": _VERSION, "shards": rows}, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._index_path())

    # -- seal ---------------------------------------------------------------

    def seal(self, lo: int, hi: int,
             records: list[tuple[bytes, int, bytes]],
             acct_rows: list[tuple[bytes, int, int, bytes]],
             first_hash: bytes, last_hash: bytes) -> int:
        """Write one shard covering validated seqs [lo, hi]. `records`
        are (key, type_byte, blob) — self-verifying, headers included;
        `acct_rows` are (account20, ledger_seq, txn_seq, txid). The file
        lands atomically (tmp + rename + fsync): a crash mid-seal leaves
        the previous shard set intact and the sweep that follows a
        FAILED seal is the caller's responsibility to skip.

        STREAMED: records are written one at a time with an incremental
        CRC — a multi-GB retired range never materializes a second (or
        third) in-RAM copy of its byte image — and the store lock is
        held only to allocate the shard id and to publish the finished
        file, so concurrent shard READS never stall behind the write
        and its fsync."""
        with self._lock:
            sid = max(self._shards, default=0) + 1
        rec_len = sum(
            _REC_HEADER + 1 + len(blob) for _k, _t, blob in records
        )
        acct_len = 4 + _ACCT_ROW.size * len(acct_rows)
        rec_off = _HDR_SIZE
        acct_off = rec_off + rec_len
        head = _MAGIC + _HDR.pack(
            _VERSION, lo, hi, rec_off, rec_len, acct_off, acct_len,
        ) + first_hash + last_hash
        name = f"shard-{sid:06d}.shard"
        path = os.path.join(self.root, name)
        tmp = path + ".tmp"
        crc = 0
        total = 0
        with open(tmp, "wb") as f:
            def emit(chunk: bytes) -> None:
                nonlocal crc, total
                f.write(chunk)
                crc = zlib.crc32(chunk, crc)
                total += len(chunk)

            emit(head)
            for key, type_byte, blob in records:
                emit(struct.pack("<IB", len(blob) + 1, 0))
                emit(key)
                emit(bytes((type_byte & 0xFF,)))
                emit(blob)
            emit(struct.pack("<I", len(acct_rows)))
            for acct, seq, txn_seq, txid in acct_rows:
                emit(_ACCT_ROW.pack(acct[:20], seq, txn_seq, txid))
            f.write(struct.pack("<I", crc & 0xFFFFFFFF))
            total += 4
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        with self._lock:
            sh = _Shard(sid, path, lo, hi, rec_off, rec_len,
                        acct_off, acct_len, len(records), total,
                        first_hash, last_hash)
            self._shards[sid] = sh
            self._write_index_locked()
            self.sealed += 1
            self.sealed_records += len(records)
            self.sealed_bytes += total
            return sid

    # -- introspection ------------------------------------------------------

    def shards(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "id": sh.sid, "lo": sh.lo, "hi": sh.hi,
                    "records": sh.records, "bytes": sh.bytes,
                    "first_hash": sh.first_hash.hex(),
                    "last_hash": sh.last_hash.hex(),
                }
                for sh in sorted(self._shards.values(),
                                 key=lambda s: s.sid)
            ]

    def covers(self, seq: int) -> Optional[int]:
        """Shard id whose range contains `seq`, else None."""
        with self._lock:
            for sh in self._shards.values():
                if sh.lo <= seq <= sh.hi:
                    return sh.sid
        return None

    def range(self) -> Optional[tuple[int, int]]:
        with self._lock:
            if not self._shards:
                return None
            return (min(s.lo for s in self._shards.values()),
                    max(s.hi for s in self._shards.values()))

    def get_json(self) -> dict:
        with self._lock:
            return {
                "shards": len(self._shards),
                "range": list(self.range() or ()),
                "sealed": self.sealed,
                "sealed_records": self.sealed_records,
                "sealed_bytes": self.sealed_bytes,
                "segment_reads": self.segment_reads,
                "account_tx_queries": self.account_tx_queries,
                "account_tx_rows": self.account_tx_rows,
                "tx_faults": self.tx_faults,
                "verifies": self.verifies,
                "imported": self.imported,
                "imported_bytes": self.imported_bytes,
                "import_rejects": self.import_rejects,
                "contiguous_floor": self.contiguous_floor(),
            }

    def contiguous_floor(self) -> int:
        """Highest seq covered by an UNBROKEN run of sealed shards
        starting at the store's lowest covered seq (0 = empty). This is
        the archive's verified floor: every result whose window closes
        at or below it is backed by offline-verified shard bytes and
        immutable, so the read plane may cache it forever."""
        with self._lock:
            spans = sorted((sh.lo, sh.hi) for sh in self._shards.values())
        if not spans:
            return 0
        hi = spans[0][1]
        for s_lo, s_hi in spans[1:]:
            if s_lo > hi + 1:
                break
            hi = max(hi, s_hi)
        return hi

    # -- the segment-manifest door (cold catch-up) -------------------------

    def segments(self) -> list[dict]:
        """Manifest rows in the segstore ``segments()`` shape, ids
        offset by SHARD_SEG_BASE — the record section is byte-served so
        the existing SegmentCatchup ingest verifies it unchanged.

        Shard rows additionally advertise the sealed range (``lo``/
        ``hi``) and the full on-disk file size (``file_bytes``) so
        catch-up and archive peers SELECT by seq range without probing;
        the wire encoder rides all three nonzero-only, keeping legacy
        manifest frames byte-identical."""
        with self._lock:
            return [
                {
                    "id": SHARD_SEG_BASE + sh.sid,
                    "size": sh.rec_len,
                    "live_bytes": sh.rec_len,
                    "active": False,
                    "lo": sh.lo,
                    "hi": sh.hi,
                    "file_bytes": sh.bytes,
                }
                for sh in sorted(self._shards.values(),
                                 key=lambda s: s.sid)
            ]

    def _fd(self, sh: _Shard) -> int:
        fd = self._fds.get(sh.sid)
        if fd is None:
            fd = os.open(sh.path, os.O_RDONLY)
            self._fds[sh.sid] = fd
        return fd

    def fetch_segment(self, seg_id: int, offset: int = 0,
                      length: Optional[int] = None,
                      ) -> Optional[tuple[dict, bytes]]:
        """One bounded chunk of a shard's RECORD section (same contract
        as segstore.fetch_segment: meta carries the full section size).
        Ids at or above SHARD_FILE_BASE serve the WHOLE shard file
        instead — the archive-backfill distribution door."""
        if seg_id >= SHARD_FILE_BASE:
            return self._fetch_file(seg_id, offset, length)
        sid = seg_id - SHARD_SEG_BASE
        with self._lock:
            sh = self._shards.get(sid)
            if sh is None:
                return None
            off = max(0, int(offset))
            n = sh.rec_len - off
            if length is not None:
                n = min(n, int(length))
            data = b""
            if n > 0:
                data = os.pread(self._fd(sh), n, sh.rec_off + off)
            self.segment_reads += 1
            return (
                {
                    "id": seg_id,
                    "size": sh.rec_len,
                    "live_bytes": sh.rec_len,
                    "active": False,
                },
                data,
            )

    def _fetch_file(self, seg_id: int, offset: int = 0,
                    length: Optional[int] = None,
                    ) -> Optional[tuple[dict, bytes]]:
        """One bounded chunk of the COMPLETE shard file (header +
        records + account index + CRC): the transferred image is
        exactly what ``verify_shard_blob`` checks and ``import_shard``
        installs, so a fetching archive trusts nothing but the bytes."""
        sid = seg_id - SHARD_FILE_BASE
        with self._lock:
            sh = self._shards.get(sid)
            if sh is None:
                return None
            off = max(0, int(offset))
            n = sh.bytes - off
            if length is not None:
                n = min(n, int(length))
            data = b""
            if n > 0:
                data = os.pread(self._fd(sh), n, off)
            self.segment_reads += 1
            return (
                {
                    "id": seg_id,
                    "size": sh.bytes,
                    "live_bytes": sh.bytes,
                    "active": False,
                },
                data,
            )

    # -- archive import (shard distribution network) -----------------------

    def import_shard(self, data: bytes) -> dict:
        """Verify-then-install a peer-fetched shard image. The bytes
        run the FULL offline contract in memory (``verify_shard_blob``)
        BEFORE anything touches the store directory — a failed
        verification retains zero hostile bytes. A range the store
        already holds is an idempotent duplicate; a partial overlap is
        rejected (two honest seals never straddle a rotation point)."""
        report = verify_shard_blob(data)
        if not report["ok"]:
            with self._lock:
                self.import_rejects += 1
            return {
                "ok": False,
                "error": report.get("error", "verify failed"),
                "report": report,
            }
        lo, hi = report["lo"], report["hi"]
        with self._lock:
            for sh in self._shards.values():
                if sh.lo == lo and sh.hi == hi:
                    return {"ok": True, "duplicate": True, "id": sh.sid,
                            "lo": lo, "hi": hi}
                if sh.hi >= lo and sh.lo <= hi:
                    self.import_rejects += 1
                    return {"ok": False, "error": "overlapping range"}
            sid = max(self._shards, default=0) + 1
        path = os.path.join(self.root, f"shard-{sid:06d}.shard")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        with self._lock:
            sh = _Shard(sid, path, lo, hi,
                        report["rec_off"], report["rec_len"],
                        report["acct_off"], report["acct_len"],
                        report["records"], len(data),
                        report["first_hash"], report["last_hash"])
            self._shards[sid] = sh
            self._write_index_locked()
            self.imported += 1
            self.imported_bytes += len(data)
        return {"ok": True, "id": sid, "lo": lo, "hi": hi,
                "records": report["records"]}

    def iter_records(self, sid: int) -> Iterator[tuple[bytes, int, bytes]]:
        """(key, type_byte, blob) per record of one shard — the import
        fan-out walk (archive nodestore + txdb feed)."""
        with self._lock:
            sh = self._shards.get(sid)
            if sh is None:
                return
            data = os.pread(self._fd(sh), sh.rec_len, sh.rec_off)
        for key, type_byte, off, ln in _iter_records_py(data):
            yield key, type_byte, data[off: off + ln]

    def acct_rows(self, sid: int) -> list[tuple[bytes, int, int, bytes]]:
        """(account20, ledger_seq, txn_seq, txid) rows of one shard."""
        with self._lock:
            sh = self._shards.get(sid)
        if sh is None:
            return []
        raw = self._acct_rows(sh)
        if len(raw) < 4:
            return []
        (n,) = struct.unpack_from("<I", raw, 0)
        out = []
        pos = 4
        for _ in range(n):
            if pos + _ACCT_ROW.size > len(raw):
                break
            out.append(_ACCT_ROW.unpack_from(raw, pos))
            pos += _ACCT_ROW.size
        return out

    def tx_blob(self, sid: int, txid: bytes,
                ) -> Optional[tuple[bytes, bytes]]:
        """(raw_tx, meta) for one txid of one shard (import feed +
        byte-match audits)."""
        with self._lock:
            sh = self._shards.get(sid)
        if sh is None:
            return None
        return self._tx_blob(sh, txid)

    # -- account_tx below the retain floor ---------------------------------

    def _acct_rows(self, sh: _Shard) -> bytes:
        with self._lock:
            return os.pread(self._fd(sh), sh.acct_len, sh.acct_off)

    def _txid_index(self, sh: _Shard) -> dict:
        """txid -> (file_off, blob_len) over the shard's TX-tree leaf
        records, built once per shard on first account_tx touch (the
        native segrecs_scan pass when available)."""
        with self._lock:
            idx = sh._txid_index
            if idx is not None:
                return idx
        from ..native import scan_segment_records

        # None without the native library: the Python mirror below
        recs = scan_segment_records(sh.path, sh.rec_off)
        entries: dict[bytes, tuple[int, int]] = {}
        tx_prefix = HP_TX_NODE.to_bytes(4, "big")
        if recs is not None:
            with self._lock:
                fd = self._fd(sh)
            for key, type_byte, blob_off, blob_len in recs:
                if blob_off + blob_len > sh.rec_off + sh.rec_len:
                    break  # past the record section (acct rows / crc)
                if type_byte != _T_TRANSACTION_NODE or blob_len < 36:
                    continue
                if os.pread(fd, 4, blob_off) != tx_prefix:
                    continue  # inner node of the tx tree
                txid = os.pread(fd, 32, blob_off + blob_len - 32)
                entries[txid] = (blob_off, blob_len)
        else:
            with self._lock:
                data = os.pread(self._fd(sh), sh.rec_len, sh.rec_off)
            for key, type_byte, off, ln in _iter_records_py(data):
                if type_byte != _T_TRANSACTION_NODE or ln < 36:
                    continue
                if data[off: off + 4] != tx_prefix:
                    continue
                txid = data[off + ln - 32: off + ln]
                entries[txid] = (sh.rec_off + off, ln)
        with self._lock:
            sh._txid_index = entries
        return entries

    def _tx_blob(self, sh: _Shard, txid: bytes,
                 ) -> Optional[tuple[bytes, bytes]]:
        """(raw_tx, meta) decoded on demand from the shard file."""
        loc = self._txid_index(sh).get(txid)
        if loc is None:
            return None
        off, ln = loc
        with self._lock:
            blob = os.pread(self._fd(sh), ln, off)
        self.tx_faults += 1
        # TX_MD leaf: 4B prefix + VL(tx) || VL(meta) + 32B tag
        from ..protocol.serializer import BinaryParser

        p = BinaryParser(blob[4:-32])
        return p.read_vl(), p.read_vl()

    def account_tx(self, account: bytes, min_ledger: int, max_ledger: int,
                   limit: int = 200, forward: bool = True,
                   after: Optional[tuple[int, int]] = None) -> list[dict]:
        """txdb.account_transactions-shaped rows served from shards —
        same walk order, same EXCLUSIVE (ledger_seq, txn_seq) resume
        marker, so the handler merges the two tiers seamlessly."""
        self.account_tx_queries += 1
        acct20 = account[:20]
        hits: list[tuple[int, int, bytes, _Shard]] = []
        with self._lock:
            shards = [
                sh for sh in self._shards.values()
                if sh.hi >= min_ledger and sh.lo <= max_ledger
            ]
        for sh in shards:
            raw = self._acct_rows(sh)
            if len(raw) < 4:
                continue
            (n,) = struct.unpack_from("<I", raw, 0)
            pos = 4
            for _ in range(n):
                if pos + _ACCT_ROW.size > len(raw):
                    break
                a, lseq, tseq, txid = _ACCT_ROW.unpack_from(raw, pos)
                pos += _ACCT_ROW.size
                if a != acct20 or not (min_ledger <= lseq <= max_ledger):
                    continue
                if after is not None:
                    al, at = after
                    if forward:
                        if (lseq, tseq) <= (al, at):
                            continue
                    elif (lseq, tseq) >= (al, at):
                        continue
                hits.append((lseq, tseq, txid, sh))
        hits.sort(key=lambda r: (r[0], r[1]), reverse=not forward)
        out = []
        for lseq, tseq, txid, sh in hits[:limit]:
            got = self._tx_blob(sh, txid)
            if got is None:
                continue  # index row without a record: skip, not crash
            raw_tx, meta = got
            out.append({
                "txid": txid,
                "ledger_seq": lseq,
                "txn_seq": tseq,
                "raw": raw_tx,
                "meta": meta,
                "shard": sh.sid,
            })
            self.account_tx_rows += 1
        return out

    # -- offline verification ----------------------------------------------

    def verify(self, sid: int) -> dict:
        """The offline verification contract (doc/storage.md): CRC over
        the whole file, every record's content hash, and the header
        chain — run against the file alone."""
        with self._lock:
            sh = self._shards.get(sid)
        if sh is None:
            return {"ok": False, "error": "unknown shard"}
        self.verifies += 1
        with open(sh.path, "rb") as f:
            blob = f.read()
        report: dict = {"ok": False, "id": sid, "lo": sh.lo, "hi": sh.hi}
        if len(blob) < _HDR_SIZE + 4 or blob[:8] != _MAGIC:
            report["error"] = "bad magic/size"
            return report
        body, crc = blob[:-4], struct.unpack("<I", blob[-4:])[0]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            report["error"] = "crc mismatch"
            return report
        rec_img = blob[sh.rec_off: sh.rec_off + sh.rec_len]
        n_checked = bad = 0
        headers: dict[int, dict] = {}
        ledger_prefix = HP_LEDGER_MASTER.to_bytes(4, "big")
        for key, type_byte, off, ln in _iter_records_py(rec_img):
            node = rec_img[off: off + ln]
            if sha512_half(node) != key:
                bad += 1
            n_checked += 1
            if type_byte == _T_LEDGER and node[:4] == ledger_prefix:
                from ..state.ledger import parse_header

                h = parse_header(node[4:])
                headers[h["seq"]] = {
                    "hash": key, "parent_hash": h["parent_hash"],
                }
        report["records"] = n_checked
        report["bad_records"] = bad
        chain_ok = True
        for seq in range(sh.lo, sh.hi + 1):
            if seq not in headers:
                chain_ok = False
                break
            if seq > sh.lo and \
                    headers[seq]["parent_hash"] != headers[seq - 1]["hash"]:
                chain_ok = False
                break
        report["header_chain_ok"] = chain_ok
        report["first_hash_ok"] = (
            headers.get(sh.lo, {}).get("hash") == sh.first_hash
        )
        report["last_hash_ok"] = (
            headers.get(sh.hi, {}).get("hash") == sh.last_hash
        )
        report["ok"] = (
            bad == 0 and n_checked == sh.records and chain_ok
            and report["first_hash_ok"] and report["last_hash_ok"]
        )
        return report

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                try:
                    os.close(fd)
                except OSError:
                    pass
            self._fds.clear()


def rotate_into_shards(db, shardstore: HistoryShardStore,
                       retired: list[dict], retained: list[dict],
                       acct_rows: Optional[list] = None) -> Optional[int]:
    """One whole rotation against a nodestore Database: seal the
    `retired` ledgers (header dicts: hash/seq/account_hash/tx_hash)
    into a shard, then sweep everything not reachable from `retained`
    out of the live store. The embedder/testkit form of what
    OnlineDeleter does on the drain worker — seal FIRST, delete only
    what sealed. Returns the new shard id, or None when there was
    nothing to retire."""
    if not retired:
        return None
    retired = sorted(retired, key=lambda h: h["seq"])

    def fetch(h: bytes):
        obj = db.fetch(h, populate_cache=False)
        return obj.data if obj is not None else None

    live: set = set()
    mark_live(fetch, retained, live)
    records = collect_retired(fetch, retired, live)
    sid = shardstore.seal(
        retired[0]["seq"], retired[-1]["seq"], records,
        list(acct_rows or ()),
        first_hash=retired[0]["hash"], last_hash=retired[-1]["hash"],
    )
    db.begin_sweep()
    db.apply_sweep(live)
    return sid


class CombinedSegmentSource:
    """segstore backend + shard store behind ONE fetch_segment door:
    the manifest concatenates live segments and shard rows, and ids at
    or above SHARD_SEG_BASE route to the shard store. Wired as
    ``vn.segment_source`` so a cold peer below the leader's trim floor
    syncs the gap from shards over the unchanged GetSegments path."""

    def __init__(self, backend, shardstore: HistoryShardStore):
        self.backend = backend
        self.shardstore = shardstore

    def segments(self) -> list[dict]:
        return self.backend.segments() + self.shardstore.segments()

    def fetch_segment(self, seg_id: int, offset: int = 0,
                      length: Optional[int] = None):
        if seg_id >= SHARD_SEG_BASE:
            return self.shardstore.fetch_segment(
                seg_id, offset=offset, length=length
            )
        return self.backend.fetch_segment(
            seg_id, offset=offset, length=length
        )
