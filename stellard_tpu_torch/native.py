"""Loader for the repo's native host code (``native/src/*.cc``).

Three builds, each compiled with ``g++`` at first use into
``build/stellard_tpu_torch/`` beside the package (git-ignored), named by
a digest of its sources and flags, under a file lock of the build
directory (``ops.build._build_lock``, on a file of its own so that g++
runs beside nvcc: several processes of one host may start together,
and one builds while the others wait and load it). It never runs
``make`` and never writes under ``native/``:

- ``libnodestore-<digest>.so`` from ``nodestore.cc``: the segstore key
  index, its record packer and log replay, the record-range scanner and
  the flat cpplog backend (``load_native``);
- ``libnativehost-<digest>.so`` from ``sha512.cc``, ``ed25519_host.cc``
  and ``ed25519_verify.cc``, linked together (the verifier calls the
  other two's ``sha512_parts`` and ``sc_reduce_batch``): h =
  SHA512(R||A||M) mod l and full Ed25519 verification (``load_host``;
  ``Ed25519HostPrep``, ``Ed25519NativeVerify``);
- ``_stser-<digest>.so`` from ``stser.cc``, a CPython extension built
  against the running interpreter's headers: the STObject codec and the
  SHAMap node pack and merge (``load_stser``). The file is this
  package's own: the extension keeps its field table and callbacks in
  file-static globals, so a process that also loads the JAX package's
  copy must not share one library with it.

Every consumer keeps a pure-Python mirror, so each loader returns None
when no compiler is found or the build fails (``status`` says why), and
the same semantics run slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional

from .ops.build import _build_lock

__all__ = [
    "load_native",
    "load_host",
    "load_stser",
    "native_available",
    "build_all",
    "arms",
    "status",
    "CppLogLib",
    "SegIdxNative",
    "Ed25519HostPrep",
    "Ed25519NativeVerify",
    "scan_segment_records",
]

_REPO = Path(__file__).resolve().parent.parent
_SRC = _REPO / "native" / "src"
SOURCE = _SRC / "nodestore.cc"
HOST_SOURCES = (_SRC / "sha512.cc", _SRC / "ed25519_host.cc", _SRC / "ed25519_verify.cc")
STSER_SOURCE = _SRC / "stser.cc"
BUILD_DIR = _REPO / "build" / "stellard_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lock = threading.Lock()
# library name -> the loaded library or module, None once it failed
_loaded: dict[str, object] = {}
# library name -> why it is unavailable
_why: dict[str, str] = {}


def _stser_flags() -> list[str]:
    # the running interpreter's headers: an extension built for another
    # Python dlopens anyway and misreads the object layouts
    return [*CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}"]


def _digest_path(stem: str, sources, flags, tag: str = "") -> Path:
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(flags).encode())
    digest.update(tag.encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def lib_path() -> Path:
    return _digest_path("libnodestore", [SOURCE], CXX_FLAGS)


def host_lib_path() -> Path:
    return _digest_path("libnativehost", HOST_SOURCES, CXX_FLAGS)


def stser_path() -> Path:
    # the interpreter's ABI tag too: one checkout, several Pythons
    return _digest_path("_stser", [STSER_SOURCE], _stser_flags(),
                        sysconfig.get_config_var("SOABI") or "")


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++")) or shutil.which("g++")


def _build(out: Path, sources, flags) -> Optional[str]:
    """Compile `sources` into `out` unless it is there; None when it is,
    else why not."""
    if out.exists():
        return None
    missing = [str(s) for s in sources if not s.exists()]
    if missing:
        return f"missing source {missing[0]}"
    cxx = _compiler()
    if cxx is None:
        return "no C++ compiler (g++) on PATH"
    with _build_lock(".host.lock"):
        if out.exists():  # another process built it while this one waited
            return None
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            r = subprocess.run([cxx, *flags, "-o", str(tmp), *map(str, sources)],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            tmp.unlink(missing_ok=True)
            return f"{type(exc).__name__}: {exc}"
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            return f"g++ failed: {r.stderr.strip()[-400:]}"
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return None


def _load(name: str, path_fn, sources, flags, open_fn):
    """Build (once) and open one library; None (and `_why[name]`) when
    it is unavailable. A library already tried is read without the lock,
    so a process forked while another thread builds does not wait on a
    lock that no thread of its own holds."""
    if name in _loaded:
        return _loaded[name]
    with _lock:
        if name in _loaded:
            return _loaded[name]
        path = path_fn()
        why = _build(path, sources, flags)
        lib = None
        if why is None:
            try:
                lib = open_fn(path)
            except (OSError, AttributeError, ImportError) as exc:
                why = f"{type(exc).__name__}: {exc}"
        if why is not None:
            _why[name] = why
        _loaded[name] = lib
        return lib


def _open_nodestore(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    _bind(lib)
    return lib


def _open_host(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    _bind_host(lib)
    return lib


def _open_stser(path: Path):
    import importlib.machinery
    import importlib.util

    loader = importlib.machinery.ExtensionFileLoader("_stser", str(path))
    spec = importlib.util.spec_from_loader("_stser", loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def load_native() -> Optional[ctypes.CDLL]:
    """Build (once) and dlopen the node-store library; None if
    unavailable."""
    return _load("nodestore", lib_path, [SOURCE], CXX_FLAGS, _open_nodestore)


def load_host() -> Optional[ctypes.CDLL]:
    """Build (once) and dlopen the host crypto library (Ed25519 h prep
    and verify); None if unavailable."""
    return _load("host", host_lib_path, HOST_SOURCES, CXX_FLAGS, _open_host)


def load_stser():
    """Build (once) and import this package's ``_stser`` extension (the
    STObject codec and the SHAMap pack and merge); None if
    unavailable."""
    return _load("stser", stser_path, [STSER_SOURCE], _stser_flags(), _open_stser)


def native_available() -> bool:
    """Whether the host crypto library builds and loads here."""
    return load_host() is not None


def build_all() -> dict:
    """Build and load all three (a process that starts others builds
    them first, so that no child compiles); -> ``status()``."""
    load_native()
    load_host()
    load_stser()
    return status()


def arms() -> dict:
    """Which host paths run in C in this process: K1's h prep and the
    native verifier (the host library), the STObject codec (off with
    ``STELLARD_NATIVE_STSER=0``), the SHAMap node pack and merge; with
    each library's path or why it is unavailable. Builds nothing: a
    library this process has not loaded yet reads as not native
    (``build_all`` first, where that matters)."""
    from .protocol.stobject import _get_stser
    from .state.shamap import _resolve_native_merge, _resolve_native_pack

    host = _loaded.get("host") is not None
    stser = _loaded.get("stser") is not None
    return {"h_prep": host, "native_verify": host,
            "codec": stser and _get_stser() is not None,
            "pack": stser and _resolve_native_pack() is not None,
            "merge": stser and _resolve_native_merge() is not None,
            "libraries": status()}


def status() -> dict:
    """Each library tried so far: its path, or why it is unavailable.
    Takes no lock: a build in progress does not hold a status read."""
    paths = {"nodestore": lib_path, "host": host_lib_path, "stser": stser_path}
    return {name: (str(paths[name]()) if lib is not None
                   else f"unavailable: {_why.get(name, '?')}")
            for name, lib in dict(_loaded).items()}


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


def _bind_host(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    sigs = {
        # packed 32B R, packed 32B A, packed messages, offsets[n+1], out (32B LE h), n
        "ed25519_h_batch": ([ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, u64p, u8p,
                             ctypes.c_uint64], None),
        "sc_reduce_batch": ([ctypes.c_char_p, u8p, ctypes.c_uint64], None),
        # packed 32B keys, packed messages, offsets[n+1], packed 64B signatures,
        # out (n bytes, 1 = valid), n
        "ed25519_verify_batch": ([ctypes.c_char_p, ctypes.c_char_p, u64p, ctypes.c_char_p,
                                  u8p, ctypes.c_uint64], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _offsets(messages):
    """The n+1 boundaries of `messages` packed back to back (uint64)."""
    import numpy as np

    offsets = np.zeros(len(messages) + 1, np.uint64)
    np.cumsum(np.fromiter(map(len, messages), np.uint64, len(messages)), out=offsets[1:])
    return offsets


def _ptr(arr, ctype=ctypes.c_uint64):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _require_host() -> ctypes.CDLL:
    lib = load_host()
    if lib is None:
        raise RuntimeError(f"native host library unavailable: {_why.get('host', '?')}")
    return lib


class Ed25519HostPrep:
    """Batched h = SHA512(R||A||M) mod l over the C kernel
    (ed25519_host.cc, up to 8 threads a call, started and joined inside
    it): K1's host prep in one ctypes call, the GIL released."""

    def __init__(self):
        self.lib = _require_host()

    def h_batch(self, rs: bytes, pubs: bytes, messages, n: int):
        """rs/pubs: packed 32-byte-per-element buffers; messages: a
        sequence of bytes. -> [n, 32] uint8 h scalars (LE, mod l)."""
        import numpy as np

        if not isinstance(messages, list):
            messages = list(messages)
        if len(messages) != n or len(rs) != 32 * n or len(pubs) != 32 * n:
            raise ValueError(
                f"h_batch: inconsistent batch (n={n}, msgs={len(messages)}, "
                f"rs={len(rs)}, pubs={len(pubs)})"
            )
        out = np.empty((n, 32), np.uint8)
        offsets = _offsets(messages)
        self.lib.ed25519_h_batch(rs, pubs, b"".join(messages), _ptr(offsets),
                                 _ptr(out, ctypes.c_uint8), n)
        return out

    def sc_reduce(self, wide: bytes, n: int):
        """n 64-byte LE integers (packed) mod l -> [n, 32] uint8."""
        import numpy as np

        if len(wide) != 64 * n:
            raise ValueError(f"sc_reduce: {len(wide)} bytes for n={n}")
        out = np.empty((n, 32), np.uint8)
        self.lib.sc_reduce_batch(wide, _ptr(out, ctypes.c_uint8), n)
        return out


class Ed25519NativeVerify:
    """Batched full Ed25519 verification over the C++ kernel
    (ed25519_verify.cc): the libsodium role of the reference
    (StellarPublicKey::verifySignature, canonical S included), the whole
    batch in one call with the GIL released."""

    def __init__(self):
        self.lib = _require_host()

    def verify_batch(self, publics, messages, signatures):
        """publics/signatures: sequences of 32/64-byte strings; messages:
        sequence of bytes. -> bool ndarray of each item's validity.
        Items of the wrong length are rejected without reaching C."""
        import numpy as np

        n = len(publics)
        if not (len(messages) == len(signatures) == n):
            raise ValueError("verify_batch: ragged batch")
        idx = [i for i in range(n) if len(publics[i]) == 32 and len(signatures[i]) == 64]
        out = np.zeros(n, bool)
        if not idx:
            return out
        msgs = [messages[i] for i in idx]
        offsets = _offsets(msgs)
        raw = np.zeros(len(idx), np.uint8)
        self.lib.ed25519_verify_batch(
            b"".join(publics[i] for i in idx), b"".join(msgs), _ptr(offsets),
            b"".join(signatures[i] for i in idx), _ptr(raw, ctypes.c_uint8), len(idx),
        )
        out[idx] = raw.astype(bool)
        return out


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
