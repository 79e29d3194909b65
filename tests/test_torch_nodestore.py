"""The port's node store (nodestore/, native.py) against the JAX package's.

Two ways in, with a tolerance of zero (these are bytes):

- **Port runs of the JAX node-store tests.** The node-store classes of
  tests/test_segstore.py (segstore basics, durability modes,
  checkpointed open, torn-tail recovery, online deletion, compaction,
  the segment read door, cpplog iteration, sqlite WAL hygiene, the
  Database façade) run again with the port's ``make_database``,
  ``SegStoreBackend``, ``NodeObject`` and ``NodeObjectType`` in their
  names, with segstore's index both native (the port's own build of
  native/src/nodestore.cc) and in its Python mirror. After each case,
  every store it left on disk is opened by both packages, which must
  read the same (key, type, blob) set: the port's files are the JAX
  package's format, checkpoint included.
- **Stores written by one package, read by the other.** The same
  batches through both packages' segstore write byte-identical segment
  files; a store written by either package (either index arm) opens in
  the other, which reads every object, appends, and hands it back. The
  backend cases of tests/test_state.py run through both packages the
  same way.
"""

from __future__ import annotations

import os

import pytest

import stellard_tpu.nodestore as jax_ns
import stellard_tpu_torch.nodestore as port_ns
import test_segstore as ts
from stellard_tpu_torch.native import load_native

FILE_BACKENDS = ("segstore", "sqlite", "cpplog")


def need_native(pkg: str, native: bool) -> None:
    """Skip a native-index case where that package's library did not
    build (decided when the test runs: every worker collects the same
    cases)."""
    if native and (load_native() is None if pkg == "port" else True not in JAX_NATIVE):
        pytest.skip(f"{pkg}: no native node-store library here")


JAX_NATIVE = ts.NATIVE_MODES


def contents(pkg, type_: str, path: str) -> list:
    """Every (key, type, blob) of the store at `path`, opened by `pkg`'s
    node store (segstore through its Python index)."""
    kw = {"use_native": False} if type_ == "segstore" else {}
    db = pkg.make_database(type_, path=path, async_writes=False, **kw)
    try:
        return sorted((o.hash, int(o.type), o.data) for o in db.backend.iterate())
    finally:
        db.close()


class Twin:
    """Puts the port into test_segstore's names and notes every store
    the test body opens, so that each can be read by both packages
    after the test."""

    def __init__(self, monkeypatch):
        self.opened: list[tuple[str, str]] = []

        def make_database(type="memory", **kwargs):
            if type in FILE_BACKENDS and "path" in kwargs:
                self.opened.append((type, kwargs["path"]))
            return port_ns.make_database(type, **kwargs)

        monkeypatch.setattr(ts, "make_database", make_database)
        monkeypatch.setattr(ts, "SegStoreBackend", port_ns.SegStoreBackend)
        monkeypatch.setattr(ts, "NodeObject", port_ns.NodeObject)
        monkeypatch.setattr(ts, "NodeObjectType", port_ns.NodeObjectType)
        monkeypatch.setattr(ts, "NATIVE_MODES",
                            [False] + ([True] if load_native() is not None else []))

    def check(self) -> int:
        checked = 0
        for type_, path in dict.fromkeys(self.opened):
            if not os.path.exists(path):
                continue
            assert contents(port_ns, type_, path) == contents(jax_ns, type_, path), path
            checked += 1
        return checked


@pytest.fixture(params=[False, True], ids=lambda p: "native" if p else "py")
def use_native(request):
    need_native("port", request.param)
    return request.param


@pytest.fixture(autouse=True)
def twin(monkeypatch):
    t = Twin(monkeypatch)
    yield t
    t.check()


class TestSegStoreBasicsPort(ts.TestSegStoreBasics):
    pass


class TestDurabilityModesPort(ts.TestDurabilityModes):
    pass


class TestCheckpointedOpenPort(ts.TestCheckpointedOpen):
    pass


class TestTornTailRecoveryPort(ts.TestTornTailRecovery):
    pass


class TestOnlineDeletionPort(ts.TestOnlineDeletion):
    pass


class TestCompactionPort(ts.TestCompaction):
    pass


class TestSegmentReadDoorPort(ts.TestSegmentReadDoor):
    pass


class TestCppLogIteratePort(ts.TestCppLogIterate):
    pass


class TestSqliteWalHygienePort(ts.TestSqliteWalHygiene):
    pass


class TestDatabaseFacadePort(ts.TestDatabaseFacade):
    pass


def test_port_runs_use_the_port(twin, tmp_path):
    db = ts.make_database(type="segstore", path=str(tmp_path / "ns"))
    assert isinstance(db, port_ns.Database)
    assert type(db.backend) is port_ns.SegStoreBackend
    assert db.get_json()["backend_stats"]["native_index"] == (load_native() is not None)
    ts._store_packed(db, ts._blobs(5))
    db.close()
    assert twin.check() == 1


# --------------------------------------------------------------------------
# stores written by one package, read by the other

PACKAGES = {"jax": jax_ns, "port": port_ns}
ARMS = [(p, n) for p in ("jax", "port") for n in (False, True)]
ARM_IDS = [f"{p}-{'native' if n else 'py'}" for p, n in ARMS]


def _write(pkg, path: str, native: bool, batches) -> dict:
    db = pkg.make_database(type="segstore", path=path, segment_bytes=1 << 16,
                           use_native=native)
    for i, pairs in enumerate(batches):
        ts._store_packed(db, pairs)
        if i == len(batches) // 2:
            db.backend.checkpoint()
    stats = db.backend.get_json()
    db.close()
    return stats


def _segment_files(path) -> dict:
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path)) if name.endswith(".seg")}


BATCHES = [ts._blobs(150, tag=f"x{i}", size=32 * (1 + i % 4)) for i in range(8)]
BATCHES.append(BATCHES[2][:40] + ts._blobs(20, tag="tail"))  # dedup inside a store


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
def test_same_batches_same_segment_files(tmp_path, arm):
    """Both packages, either index arm, write the same bytes for the same
    batches: records, segment rolls and dedup decisions alike."""
    pkg, native = arm
    need_native(pkg, native)
    ref = _write(jax_ns, str(tmp_path / "ref"), False, BATCHES)
    got = _write(PACKAGES[pkg], str(tmp_path / "got"), native, BATCHES)
    assert _segment_files(tmp_path / "got") == _segment_files(tmp_path / "ref")
    assert len(_segment_files(tmp_path / "ref")) > 1
    keys = ("objects", "segments", "records", "bytes_appended", "dedup_skips", "appends")
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}


CROSS = [(w, r) for w in ARMS for r in ARMS if w[0] != r[0]]


@pytest.mark.parametrize(
    ("writer", "reader"), CROSS,
    ids=[f"{ARM_IDS[ARMS.index(w)]}-to-{ARM_IDS[ARMS.index(r)]}" for w, r in CROSS])
def test_store_written_by_one_opens_in_the_other(tmp_path, writer, reader):
    need_native(*writer)
    need_native(*reader)
    path = str(tmp_path / "ns")
    _write(PACKAGES[writer[0]], path, writer[1], BATCHES)
    want = dict(p for batch in BATCHES for p in batch)
    db = PACKAGES[reader[0]].make_database(type="segstore", path=path,
                                           segment_bytes=1 << 16, use_native=reader[1])
    assert db.backend.opened_from_checkpoint
    assert db.backend.count() == len(want)
    for k, b in want.items():
        assert db.fetch(k).data == b
    more = ts._blobs(30, tag="reader-side")
    ts._store_packed(db, more)
    db.close()
    db = PACKAGES[writer[0]].make_database(type="segstore", path=path, use_native=writer[1])
    for k, b in list(want.items()) + more:
        assert db.fetch(k).data == b
    db.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_tail_written_by_one_recovers_in_the_other(tmp_path, writer):
    path = tmp_path / "ns"
    reader = "port" if writer == "jax" else "jax"
    db = PACKAGES[writer].make_database(type="segstore", path=str(path), use_native=False)
    survivors = ts._blobs(25, tag="survivor")
    ts._store_packed(db, survivors)
    db.backend._active_f.flush()  # a crash: no close, no checkpoint
    seg = path / sorted(p for p in os.listdir(path) if p.endswith(".seg"))[-1]
    clean = seg.stat().st_size
    with open(seg, "ab") as f:
        f.write(ts.struct.pack("<IB", 500, 0) + b"\xAA" * 40)
    db2 = PACKAGES[reader].make_database(type="segstore", path=str(path), use_native=False)
    assert seg.stat().st_size == clean
    assert db2.backend.replayed_records == 25
    for k, b in survivors:
        assert db2.fetch(k).data == b
    db2.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("backend", ["sqlite", "cpplog"])
def test_other_file_backends_cross_read(tmp_path, writer, backend):
    path = str(tmp_path / f"nodes.{backend}")
    pairs = ts._blobs(60, size=96)
    db = PACKAGES[writer].make_database(backend, path=path)
    db.backend.store_batch([
        PACKAGES[writer].NodeObject(PACKAGES[writer].NodeObjectType.ACCOUNT_NODE, k, b)
        for k, b in pairs])
    db.close()
    assert contents(port_ns, backend, path) == contents(jax_ns, backend, path) == sorted(
        (k, int(port_ns.NodeObjectType.ACCOUNT_NODE), b) for k, b in pairs)


# --------------------------------------------------------------------------
# the backend cases of tests/test_state.py, through both packages


def h(i: int) -> bytes:
    import hashlib

    return hashlib.sha256(i.to_bytes(8, "big")).digest()


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_roundtrip_both_packages(backend, tmp_path):
    blobs = {h(i): h(i + 1000) * 2 for i in range(100)}
    got = {}
    for name, pkg in PACKAGES.items():
        kw = {"path": str(tmp_path / f"{name}.db")} if backend == "sqlite" else {}
        db = pkg.make_database(backend, async_writes=False, **kw)
        for k, v in blobs.items():
            db.store(pkg.NodeObjectType.ACCOUNT_NODE, k, v)
        got[name] = ([db.fetch(k).data for k in blobs], db.fetch(h(10_000)),
                     sorted(db.get_json().items()))
        db.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == list(blobs.values()) and got["port"][1] is None


def test_async_writer_visibility_both_packages():
    for pkg in PACKAGES.values():
        db = pkg.make_database("memory")
        for i in range(500):
            db.store(pkg.NodeObjectType.TRANSACTION_NODE, h(i), h(i))
        assert all(db.fetch(h(i)).data == h(i) for i in range(500))
        db.sync()
        assert db.backend.fetch(h(0)) is not None
        db.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sqlite_persistence_across_packages(tmp_path, writer):
    """test_state.py::test_sqlite_persistence, the reopen in the other
    package."""
    path = str(tmp_path / "n.db")
    reader = "port" if writer == "jax" else "jax"
    db = PACKAGES[writer].make_database("sqlite", path=path)
    db.store(PACKAGES[writer].NodeObjectType.LEDGER, h(1), b"header")
    db.close()
    db2 = PACKAGES[reader].make_database("sqlite", path=path, async_writes=False)
    got = db2.fetch(h(1))
    assert got.data == b"header" and int(got.type) == int(port_ns.NodeObjectType.LEDGER)
    db2.close()


def test_null_and_unknown_backends_both_packages():
    for pkg in PACKAGES.values():
        db = pkg.make_database("null", async_writes=False)
        db.store(pkg.NodeObjectType.LEDGER, h(1), b"x")
        db.sync()
        assert db.backend.fetch(h(1)) is None
        with pytest.raises(KeyError):
            pkg.make_database("levelddb")


def test_writer_error_surfaces_in_the_port():
    """test_state.py::test_writer_error_surfaces on the port's façade."""
    class Boom(port_ns.Backend):
        def store_batch(self, batch):
            raise OSError("disk full")

        def fetch(self, hash):
            return None

    db = port_ns.Database(Boom())
    db.store(port_ns.NodeObjectType.LEDGER, h(1), b"x")
    with pytest.raises(RuntimeError, match="writer failed"):
        db.sync()


def test_port_native_library_is_built_outside_native_dir():
    from stellard_tpu_torch import native

    if load_native() is None:
        pytest.skip("no C++ compiler here: segstore runs its Python mirror")
    path = native.lib_path()
    assert path.exists() and native.BUILD_DIR in path.parents
    assert (native.SOURCE.parent.parent / "src") == native.SOURCE.parent
    assert not str(path).startswith(str(native.SOURCE.parent.parent) + os.sep)


def test_scan_segment_records_reads_every_record(tmp_path):
    """The port's one-pass record scanner over a segment file: each
    record's key, type and blob span, as the segment door reads them."""
    from stellard_tpu_torch.native import scan_segment_records

    if load_native() is None:
        pytest.skip("no native node-store library here")
    db = port_ns.make_database(type="segstore", path=str(tmp_path / "ns"), use_native=True)
    for batch in BATCHES[:3]:
        ts._store_packed(db, batch)
    db.sync()
    seg = sorted(p for p in os.listdir(tmp_path / "ns") if p.endswith(".seg"))[0]
    raw = (tmp_path / "ns" / seg).read_bytes()
    got = [(k, t, raw[off: off + n]) for k, t, off, n in
           scan_segment_records(str(tmp_path / "ns" / seg))]
    _meta, door = db.backend.fetch_segment(int(seg[4:-4]))
    want, off = [], 0
    while off + 37 <= len(door):
        n = ts.struct.unpack_from("<I", door, off)[0]
        want.append((door[off + 5: off + 37], door[off + 37], door[off + 38: off + 37 + n]))
        off += 37 + n
    assert got == want and len(got) == sum(len(b) for b in BATCHES[:3])
    db.close()
