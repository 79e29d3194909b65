"""Loader for the node store's native primitives (native/src/nodestore.cc).

The repo's ``native/src/nodestore.cc`` holds the C++ side of the node
store: the segstore key index (``segidx_*``), its record packer and log
replay (``segstore_pack``, ``segstore_replay``), the record-range scanner
(``segrecs_scan``) and the flat cpplog backend (``cpplog_*``). It needs
only libc, so this package compiles that one source with ``g++`` at first
use into ``build/stellard_tpu_torch/`` beside the package (git-ignored),
named by a digest of the source and flags, and binds only those symbols.
It never runs ``make`` and never writes under ``native/``.

Every consumer keeps a pure-Python mirror (nodestore/segstore.py), so
``load_native()`` returns None when no compiler is found or the build
fails, and the store runs the same semantics slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = [
    "load_native",
    "CppLogLib",
    "SegIdxNative",
    "scan_segment_records",
]

_REPO = Path(__file__).resolve().parent.parent
SOURCE = _REPO / "native" / "src" / "nodestore.cc"
BUILD_DIR = _REPO / "build" / "stellard_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libnodestore-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("g++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return True


def load_native() -> Optional[ctypes.CDLL]:
    """Build (once) and dlopen the node-store library; None if
    unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SOURCE.exists():
            return None
        out = lib_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
            _bind(lib)
        except (OSError, AttributeError):
            return None
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    sigs = {
        "segidx_new": ([ctypes.c_uint64], ctypes.c_void_p),
        "segidx_free": ([ctypes.c_void_p], None),
        "segidx_count": ([ctypes.c_void_p], ctypes.c_uint64),
        "segidx_put_batch": ([ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, u64p],
                             ctypes.c_int),
        "segidx_get": ([ctypes.c_void_p, ctypes.c_char_p], ctypes.c_int64),
        "segidx_remove": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64], ctypes.c_int),
        "segidx_filter_new": ([ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, u8p], None),
        "segidx_dump": ([ctypes.c_void_p, u8p, ctypes.c_uint64], ctypes.c_uint64),
        "segidx_load": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64], ctypes.c_int),
        "segstore_pack": ([ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p,
                           ctypes.c_char_p, u64p, u8p, ctypes.c_uint64], ctypes.c_int64),
        "segstore_replay": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                             ctypes.c_uint64, u64p, u64p], ctypes.c_int64),
        "segrecs_scan": ([ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, u8p, u8p,
                          u64p, u64p], ctypes.c_int64),
        "cpplog_open": ([ctypes.c_char_p], ctypes.c_void_p),
        "cpplog_put": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint8, ctypes.c_char_p,
                        ctypes.c_uint32], ctypes.c_int),
        "cpplog_get": ([ctypes.c_void_p, ctypes.c_char_p, u8p, ctypes.c_uint64],
                       ctypes.c_int64),
        "cpplog_count": ([ctypes.c_void_p], ctypes.c_uint64),
        "cpplog_sync": ([ctypes.c_void_p], ctypes.c_int),
        "cpplog_close": ([ctypes.c_void_p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.CPPLOG_ITER_CB = ctypes.CFUNCTYPE(
        ctypes.c_int, ctypes.c_void_p, u8p, ctypes.c_uint8, u8p, ctypes.c_uint32,
    )
    lib.cpplog_iterate.argtypes = [ctypes.c_void_p, lib.CPPLOG_ITER_CB, ctypes.c_void_p]
    lib.cpplog_iterate.restype = ctypes.c_int64
    # capability flags the consumers test (the library is built from the
    # checkout's own source, so every symbol is present)
    lib.has_segstore = True
    lib.has_segrecs_scan = True
    lib.has_cpplog_iterate = True


class SegIdxNative:
    """Native open-addressed key→loc index for the segstore backend
    (key = 32-byte content hash, loc = (seg_id << 44) | record_offset).
    NOT thread-safe — the owning backend serializes access under its own
    lock. The pure-Python mirror lives in nodestore/segstore.py."""

    def __init__(self, cap_hint: int = 0):
        self.lib = load_native()
        if self.lib is None:
            raise RuntimeError("native segstore primitives unavailable")
        self._h = self.lib.segidx_new(cap_hint)
        if not self._h:
            raise MemoryError("segidx_new failed")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self.lib.segidx_free(h)

    def __len__(self) -> int:
        return int(self.lib.segidx_count(self._h))

    def get(self, key: bytes):
        loc = self.lib.segidx_get(self._h, key)
        return None if loc < 0 else int(loc)

    def put_batch(self, packed_keys: bytes, locs: list[int]) -> None:
        n = len(locs)
        arr = (ctypes.c_uint64 * n)(*locs)
        if self.lib.segidx_put_batch(self._h, n, packed_keys, arr) != 0:
            raise ValueError("segidx_put_batch: loc out of range")

    def remove(self, key: bytes, expect_loc=None) -> bool:
        exp = (2**64 - 1) if expect_loc is None else int(expect_loc)
        return bool(self.lib.segidx_remove(self._h, key, exp))

    def filter_new(self, packed_keys: bytes, n: int) -> bytes:
        """Byte mask: 1 where keys[i] is absent from the index (in-batch
        duplicates also masked off after their first occurrence)."""
        out = (ctypes.c_uint8 * n)()
        self.lib.segidx_filter_new(self._h, n, packed_keys, out)
        return bytes(out)

    def dump(self) -> bytes:
        """Checkpoint image: live entries as [32B key | u64 loc LE]."""
        n = len(self)
        out = (ctypes.c_uint8 * (n * 40))()
        got = self.lib.segidx_dump(self._h, out, n)
        return bytes(out[: int(got) * 40])

    def load(self, blob: bytes) -> None:
        n = len(blob) // 40
        if self.lib.segidx_load(self._h, blob, n) != 0:
            raise ValueError("segidx_load: corrupt checkpoint entry")

    def pack_records(self, packed_keys: bytes, types: bytes, buf,
                     offsets) -> bytes:
        """One-call append image from the flat-buffer node encoding."""
        n = len(types)
        arr = (ctypes.c_uint64 * (n + 1))(*offsets)
        cap = (len(buf) if not isinstance(buf, memoryview) else buf.nbytes) \
            + n * 38
        out = (ctypes.c_uint8 * cap)()
        got = self.lib.segstore_pack(
            n, packed_keys, types, bytes(buf), arr, out, cap
        )
        if got < 0:
            raise ValueError("segstore_pack failed")
        return bytes(out[: int(got)])

    def replay(self, path: str, seg_id: int, start: int) -> tuple:
        """Scan one segment file into the index; returns
        (clean_end_offset, records, bytes)."""
        recs = ctypes.c_uint64(0)
        byts = ctypes.c_uint64(0)
        end = self.lib.segstore_replay(
            self._h, path.encode(), seg_id, start,
            ctypes.byref(recs), ctypes.byref(byts),
        )
        if end < 0:
            raise OSError(f"segstore_replay failed: {path}")
        return int(end), int(recs.value), int(byts.value)


def scan_segment_records(path: str, start: int = 0):
    """Index a file of segment-format records in one native pass:
    [(key, type_byte, blob_offset, blob_len)] for every clean record —
    key/type/offset only, blobs stay on disk. Returns None when the
    native library is unavailable (callers fall back to a Python loop)."""
    lib = load_native()
    if lib is None:
        return None
    p = path.encode()
    n = lib.segrecs_scan(p, start, 0, None, None, None, None)
    if n < 0:
        raise OSError(f"segrecs_scan failed: {path}")
    n = int(n)
    if n == 0:
        return []
    keys = (ctypes.c_uint8 * (32 * n))()
    types = (ctypes.c_uint8 * n)()
    offs = (ctypes.c_uint64 * n)()
    lens = (ctypes.c_uint64 * n)()
    got = lib.segrecs_scan(p, start, n, keys, types, offs, lens)
    if got < 0:
        raise OSError(f"segrecs_scan failed: {path}")
    got = min(int(got), n)  # a concurrently-truncated tail fills fewer
    kb = bytes(keys)
    return [
        (kb[32 * i: 32 * i + 32], int(types[i]), int(offs[i]), int(lens[i]))
        for i in range(got)
    ]


class CppLogLib:
    """ctypes handle for one cpplog store. Thread-safe via a Python lock
    (the C side shares one FILE* between reads and appends)."""

    def __init__(self, path: str):
        self.lib = load_native()
        if self.lib is None:
            raise RuntimeError("native library unavailable")
        self._handle = self.lib.cpplog_open(path.encode())
        if not self._handle:
            raise OSError(f"cpplog_open failed: {path}")
        self._lock = threading.Lock()
        self._buf = (ctypes.c_uint8 * 65536)()

    def put(self, key: bytes, type_byte: int, blob: bytes) -> None:
        assert len(key) == 32
        with self._lock:
            rc = self.lib.cpplog_put(
                self._handle, key, type_byte, blob, len(blob)
            )
        if rc != 0:
            raise OSError("cpplog_put failed")

    def get(self, key: bytes) -> Optional[tuple[int, bytes]]:
        assert len(key) == 32
        with self._lock:
            n = self.lib.cpplog_get(
                self._handle, key, self._buf, len(self._buf)
            )
            if n <= -2:
                # -2 - needed_length: retry with an exact-size buffer
                # (one-off; the shared buffer keeps its normal size)
                need = int(-2 - n)
                big = (ctypes.c_uint8 * need)()
                n = self.lib.cpplog_get(self._handle, key, big, need)
                if n < 0:
                    raise OSError("cpplog_get failed after resize")
                raw = bytes(big[: int(n)])
                return raw[0], raw[1:]
            if n < 0:
                return None
            raw = bytes(self._buf[: int(n)])
        return raw[0], raw[1:]

    def count(self) -> int:
        with self._lock:
            return int(self.lib.cpplog_count(self._handle))

    def iterate(self):
        """Yield every live (key, type_byte, blob) record. The native
        callback scan snapshots into a Python list under the store lock
        (the C side shares one FILE* with appends), then yields outside
        it so consumers can interleave fetches/puts."""
        out: list[tuple[bytes, int, bytes]] = []

        def cb(_ctx, key, type_byte, blob, length):
            out.append((
                bytes(key[:32]), int(type_byte),
                bytes(blob[:length]) if length else b"",
            ))
            return 0

        cfun = self.lib.CPPLOG_ITER_CB(cb)
        with self._lock:
            n = self.lib.cpplog_iterate(self._handle, cfun, None)
        if n < 0:
            raise OSError("cpplog_iterate failed")
        return iter(out)

    def sync(self) -> None:
        with self._lock:
            rc = self.lib.cpplog_sync(self._handle)
        if rc != 0:
            # the store is failed (earlier torn write) or fsync failed:
            # callers must NOT believe the batch is durable
            raise OSError("cpplog_sync failed")

    def close(self) -> None:
        with self._lock:
            if self._handle:
                self.lib.cpplog_close(self._handle)
                self._handle = None
