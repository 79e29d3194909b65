"""Ledger persistence of the port (SHAMap.flush / from_store, Ledger.save
/ load, the node serializations, the eager node cache) against the JAX
package's.

A chain built by the JAX package — chip_smoke's close and book workloads
at the small size of tests/test_torch_close.py: payments, trust lines,
issuance, offers that cross and rest, cancels, regular keys and merges —
is saved to a JAX node store; the port loads every ledger from it (same
hash, same state and transaction items); the port saves those ledgers to
a fresh store of its own, which holds the same (key, type, blob) records
and took the same number of nodes per save, in memory, sqlite and
segstore (native index and Python mirror); and the JAX package loads the
port's store. The port's own chain (its LedgerMaster over the same
blobs) saves the same store as well. The persistence cases of
tests/test_state.py and tests/test_segstore.py run through both
packages. Tolerance: zero (these are bytes).
"""

from __future__ import annotations

import hashlib
import os

import pytest

import chip_smoke as cs
import stellard_tpu.nodestore as jax_ns
import stellard_tpu.state.hotcache as jax_hotcache
import stellard_tpu.state.shamap as jax_shamap
import stellard_tpu_torch.nodestore as port_ns
import stellard_tpu_torch.state.hotcache as port_hotcache
import stellard_tpu_torch.state.shamap as port_shamap
import test_torch_close as ttc
from stellard_tpu.node.ledgermaster import LedgerMaster as JaxLedgerMaster
from stellard_tpu.protocol.formats import LedgerEntryType as JaxLET
from stellard_tpu.protocol.sfields import sfLedgerEntryType as jsfLET
from stellard_tpu.protocol.sfields import sfSequence as jsfSequence
from stellard_tpu.protocol.stobject import STObject as JaxSTObject
from stellard_tpu.state.ledger import Ledger as JaxLedger
from stellard_tpu_torch.native import load_native
from stellard_tpu_torch.protocol.formats import LedgerEntryType
from stellard_tpu_torch.protocol.sfields import sfLedgerEntryType, sfSequence
from stellard_tpu_torch.protocol.stobject import STObject
from stellard_tpu_torch.state.ledger import Ledger

PACKAGES = {"jax": jax_ns, "port": port_ns}
LEDGERS = {"jax": JaxLedger, "port": Ledger}
ARMS = ["memory", "sqlite", "segstore-py", "segstore-native"]
_HEADER = ("seq", "parent_hash", "tot_coins", "fee_pool", "inflation_seq",
           "close_time", "parent_close_time", "close_resolution", "close_flags")


def open_store(pkg: str, arm: str, tmp_path, name: str):
    """`pkg`'s store of kind `arm`; segstore's native index is the
    port's build for both packages' stores (the JAX package's own runs in
    tests/test_segstore.py), so the JAX side keeps its Python mirror."""
    ns = PACKAGES[pkg]
    if arm == "segstore-native" and load_native() is None:
        pytest.skip("no native node-store library here")
    if arm == "memory":
        return ns.make_database("memory", async_writes=False)
    if arm == "sqlite":
        return ns.make_database("sqlite", path=str(tmp_path / f"{name}.sqlite"))
    return ns.make_database(type="segstore", path=str(tmp_path / name),
                            use_native=arm == "segstore-native" and pkg == "port")


def records(db) -> list:
    if db.backend.name == "segstore":
        got = list(cs.segstore_records(db.backend))
        assert len(got) == db.backend.count()
        return sorted(got)
    db.sync()
    return sorted((o.hash, int(o.type), o.data) for o in db.backend.iterate())


def copy_store(src, pkg: str):
    """A memory store of `pkg` holding every object of `src` (the memory
    backend cannot be opened by another process or package)."""
    ns = PACKAGES[pkg]
    db = ns.make_database("memory", async_writes=False)
    db.backend.store_batch([ns.NodeObject(ns.NodeObjectType(t), k, b)
                            for k, t, b in records(src)])
    return db


def leaves(ledger, tree: str) -> list:
    return [(lf.item.tag, lf.item.data, int(lf.type))
            for lf in getattr(ledger, tree).leaves()]


def same_ledger(a, b) -> None:
    assert a.hash() == b.hash()
    assert [getattr(a, k) for k in _HEADER] == [getattr(b, k) for k in _HEADER]
    assert leaves(a, "state_map") == leaves(b, "state_map")
    assert leaves(a, "tx_map") == leaves(b, "tx_map")


@pytest.fixture(scope="module")
def jax_chain():
    """The start ledger and 7 closed ledgers of the JAX LedgerMaster over
    chip_smoke's workloads at the small size (3 payment closes, then the
    book phase's 4 closes: setup, issuance, two order-book closes)."""
    wl = cs.close_workload(**ttc.SMALL)
    bwl = cs.book_workload(wl, **ttc.SMALL_BOOK)
    start = ttc.jax_start_ledger(wl["accounts"])
    lm = JaxLedgerMaster()
    lm.load_ledger(start)
    ledgers = [start]
    try:
        for k, entries in enumerate(wl["closes"] + bwl["closes"]):
            ledgers.append(ttc._jax_close(lm, entries, k)["ledger"])
    finally:
        lm.stop_seal_drainer()
    return wl, bwl, ledgers


def save_chain(ledgers, db) -> list:
    return [cs.save_counted(led, db) for led in ledgers]


def test_chain_covers_every_kind(jax_chain):
    _wl, bwl, ledgers = jax_chain
    kinds = {k for c in bwl["closes"] for _b, k, _g in c}
    assert {"trust_set", "issue", "offer_ask", "offer_bid", "offer_cancel",
            "account_merge", "regular_key_set"} <= kinds
    assert len(ledgers) == 8 and all(len(list(led.tx_entries())) for led in ledgers[1:])


@pytest.mark.parametrize("arm", ARMS)
def test_port_loads_every_jax_ledger(jax_chain, tmp_path, arm):
    _wl, _bwl, ledgers = jax_chain
    jdb = open_store("jax", arm, tmp_path, "jax")
    save_chain(ledgers, jdb)
    if arm == "memory":
        pdb = copy_store(jdb, "port")
    else:
        jdb.close()
        pdb = open_store("port", arm, tmp_path, "jax")
    for led in ledgers:
        same_ledger(Ledger.load(pdb, led.hash()), led)
    pdb.close()


@pytest.mark.parametrize("arm", ARMS)
def test_port_saves_the_same_records(jax_chain, tmp_path, arm):
    """The port saves the ledgers it loaded into a fresh store: the same
    (key, type, blob) records and the same nodes per save as the JAX
    package's save of the same chain; a segstore's segment files are
    byte-identical. Then the JAX package loads every ledger from the
    port's store."""
    _wl, _bwl, ledgers = jax_chain
    jdb = open_store("jax", arm, tmp_path, "jax")
    jax_saves = save_chain(ledgers, jdb)
    source = copy_store(jdb, "port")
    port_ledgers = [Ledger.load(source, led.hash()) for led in ledgers]
    pdb = open_store("port", arm, tmp_path, "port")
    port_saves = save_chain(port_ledgers, pdb)
    key = lambda saves: [(s["seq"], s["hash"], s["nodes"], s["bytes"]) for s in saves]  # noqa: E731
    assert key(port_saves) == key(jax_saves)
    assert records(pdb) == records(jdb)
    assert cs.store_digest(records(pdb)) == cs.store_digest(records(jdb))
    if arm.startswith("segstore"):
        jdb.close()
        pdb.close()
        seg = lambda d: {n: (d / n).read_bytes() for n in sorted(os.listdir(d))  # noqa: E731
                         if n.endswith(".seg")}
        assert seg(tmp_path / "port") == seg(tmp_path / "jax")
        jdb2 = jax_ns.make_database(type="segstore", path=str(tmp_path / "port"),
                                    use_native=False)
    elif arm == "sqlite":
        pdb.close()
        jdb2 = jax_ns.make_database("sqlite", path=str(tmp_path / "port.sqlite"))
    else:
        jdb2 = copy_store(pdb, "jax")
    for led in ledgers:
        assert JaxLedger.load(jdb2, led.hash()).hash() == led.hash()
    jdb2.close()


def test_port_chain_saves_the_jax_store(jax_chain, tmp_path):
    """The port's own LedgerMaster over the same blobs (its default
    close), each ledger saved as it closes: the same records and nodes
    per save as the JAX package's chain."""
    from stellard_tpu_torch.crypto.backend import CpuVerifier, make_path_evaluator
    from stellard_tpu_torch.paths.plane import PathPlane

    wl, bwl, ledgers = jax_chain
    jdb = open_store("jax", "segstore-py", tmp_path, "jax")
    jax_saves = save_chain(ledgers, jdb)
    pdb = port_ns.make_database(type="segstore", path=str(tmp_path / "port"))
    saves = []
    save = lambda _k, led, _results=None: saves.append(cs.save_counted(led, pdb))  # noqa: E731
    verify = CpuVerifier().verify_batch
    _out, node = cs.run_closes(wl, None, verify, on_close=save,
                               on_start=lambda led: save(-1, led))
    cs.run_book(node, dict(bwl, requests=[]), verify,
                PathPlane(evaluator=make_path_evaluator(routing="host")),
                first_close=len(wl["closes"]), on_close=save)
    node["lm"].stop_seal_drainer()
    key = lambda s: [(r["seq"], r["hash"], r["nodes"], r["bytes"]) for r in s]  # noqa: E731
    assert key(saves) == key(jax_saves)
    assert cs.store_digest(records(pdb)) == cs.store_digest(records(jdb))


# --------------------------------------------------------------------------
# the persistence cases of tests/test_state.py and tests/test_segstore.py,
# through both packages


def h(i: int) -> bytes:
    return hashlib.sha256(i.to_bytes(8, "big")).digest()


def both_maps(n: int, data=lambda i: h(i) * 2):
    out = {}
    for name, mod in (("jax", jax_shamap), ("port", port_shamap)):
        m = mod.SHAMap()
        for i in range(n):
            m.set_item(mod.SHAMapItem(h(i), data(i)))
        out[name] = (mod, m)
    return out


def test_flush_and_rebuild_from_store():
    got = {}
    for name, (mod, m) in both_maps(200).items():
        db = PACKAGES[name].make_database("memory", async_writes=False)
        writes = []

        def store(hh, d, db=db, writes=writes, name=name):
            writes.append((hh, bytes(d)))
            db.store(PACKAGES[name].NodeObjectType.ACCOUNT_NODE, hh, d)

        root_hash = m.get_hash()
        m.flush(store)

        def fetch(hh, db=db):
            o = db.fetch(hh)
            return o.data if o else None

        m2 = mod.SHAMap.from_store(root_hash, fetch)
        assert m2.get_hash() == root_hash and len(m2) == 200
        assert all(m2.get(h(i)).data == h(i) * 2 for i in range(200))
        got[name] = writes
    assert got["port"] == got["jax"]


def _mk_sles(pkg: str, n: int) -> list:
    out = []
    for i in range(n):
        if pkg == "jax":
            sle = JaxSTObject()
            sle[jsfLET] = int(JaxLET.ltDIR_NODE)
            sle[jsfSequence] = i
        else:
            sle = STObject()
            sle[sfLedgerEntryType] = int(LedgerEntryType.ltDIR_NODE)
            sle[sfSequence] = i
        out.append(sle)
    return out


ROOT = hashlib.sha256(b"root account").digest()[:20]


def test_save_load_roundtrip_both_ways():
    """test_state.py::test_save_load_roundtrip, each package's save loaded
    by the other."""
    saved = {}
    for pkg in ("jax", "port"):
        db = PACKAGES[pkg].make_database("memory", async_writes=False)
        led = LEDGERS[pkg].genesis(ROOT)
        for i, sle in enumerate(_mk_sles(pkg, 50)):
            led.write_entry(h(i), sle)
        led.add_transaction(b"tx1", b"meta1")
        saved[pkg] = (led, led.save(db), db)
    assert saved["port"][1] == saved["jax"][1]
    for writer, reader in (("jax", "port"), ("port", "jax")):
        led, lh, db = saved[writer]
        led2 = LEDGERS[reader].load(copy_store(db, reader), lh)
        assert led2.hash() == lh and led2.seq == led.seq and led2.tot_coins == led.tot_coins
        assert led2.read_entry(h(7)).serialize() == led.read_entry(h(7)).serialize()
        assert led2.get_transaction(led.add_transaction(b"tx1", b"meta1")) == (b"tx1", b"meta1")


def test_flush_is_incremental():
    counts = {}
    for name, (mod, m) in both_maps(100, data=lambda i: b"v").items():
        writes: list = []
        known: set = set()
        sizes = []
        m.flush(lambda hh, d, w=writes: w.append(hh), known)
        sizes.append(list(writes))
        writes.clear()
        m.flush(lambda hh, d, w=writes: w.append(hh), known)
        sizes.append(list(writes))
        m.set_item(mod.SHAMapItem(h(0), b"changed"))
        writes.clear()
        m.flush(lambda hh, d, w=writes: w.append(hh), known)
        sizes.append(list(writes))
        counts[name] = sizes
    first, again, changed = counts["port"]
    assert len(first) > 100 and again == [] and 0 < len(changed) <= 10
    assert counts["port"] == counts["jax"]


def test_load_corrupt_header_raises():
    for pkg in ("jax", "port"):
        ns = PACKAGES[pkg]
        db = ns.make_database("memory", async_writes=False)
        lh = LEDGERS[pkg].genesis(ROOT).save(db)
        bad = bytearray(db.fetch(lh).data)
        bad[8] ^= 0xFF  # totCoins in the stored header
        db.store(ns.NodeObjectType.LEDGER, lh, bytes(bad))
        flushed = set(db.flushed)
        with pytest.raises(ValueError, match="hash mismatch"):
            LEDGERS[pkg].load(db, lh)
        assert db.flushed == flushed  # a failed load claims nothing


def test_flush_to_second_store_writes_everything():
    got = {}
    for name, (mod, m) in both_maps(50, data=lambda i: b"v").items():
        ns = PACKAGES[name]
        db_a = ns.make_database("memory", async_writes=False)
        db_b = ns.make_database("memory", async_writes=False)
        root = m.get_hash()
        n_a = m.flush(db_a.store_fn(ns.NodeObjectType.ACCOUNT_NODE), db_a.flushed)
        n_b = m.flush(db_b.store_fn(ns.NodeObjectType.ACCOUNT_NODE), db_b.flushed)
        assert n_a == n_b > 50

        def fetch_b(hh, db_b=db_b):
            o = db_b.fetch(hh)
            return o.data if o else None

        assert mod.SHAMap.from_store(root, fetch_b).get_hash() == root
        got[name] = (n_a, records(db_b))
    assert got["port"] == got["jax"]


def test_from_store_detects_corrupt_node():
    for name, (mod, m) in both_maps(20, data=lambda i: b"v").items():
        ns = PACKAGES[name]
        db = ns.make_database("memory", async_writes=False)
        root = m.get_hash()
        m.flush(db.store_fn(ns.NodeObjectType.ACCOUNT_NODE), db.flushed)
        victim = next(o for o in db.backend.iterate() if o.data[:4] == b"MLN\x00")
        bad = bytearray(victim.data)
        bad[-1] ^= 0xFF
        db.backend.store_batch([type(victim)(victim.type, victim.hash, bytes(bad))])
        db._cache.clear()

        def fetch(hh, db=db):
            o = db.fetch(hh)
            return o.data if o else None

        mod.inner_node_cache().clear()
        with pytest.raises(ValueError, match="content hash mismatch"):
            mod.SHAMap.from_store(root, fetch)


def test_missing_node_raises_missing_node_error():
    m = port_shamap.SHAMap()
    for i in range(20):
        m.set_item(port_shamap.SHAMapItem(h(i), b"v"))
    port_shamap.inner_node_cache().clear()
    with pytest.raises(port_shamap.MissingNodeError):
        port_shamap.SHAMap.from_store(m.get_hash(), lambda _h: None)


@pytest.mark.parametrize("use_native", [False, True], ids=lambda n: "native" if n else "py")
def test_ledger_save_load_roundtrip_segstore(tmp_path, use_native):
    """test_segstore.py::test_ledger_save_load_roundtrip through the port,
    its records equal to the JAX package's."""
    from stellard_tpu.protocol.keys import KeyPair

    if use_native and load_native() is None:
        pytest.skip("no native node-store library here")
    master = KeyPair.from_passphrase("masterpassphrase").account_id
    got = {}
    for pkg in ("jax", "port"):
        db = PACKAGES[pkg].make_database(type="segstore", path=str(tmp_path / pkg),
                                         use_native=use_native and pkg == "port")
        genesis = LEDGERS[pkg].genesis(master)
        lh = genesis.save(db)
        db.sync()
        loaded = LEDGERS[pkg].load(db, lh)
        assert loaded.hash() == lh
        assert loaded.state_map.get_hash() == genesis.state_map.get_hash()
        before = db.backend.records
        genesis.save(db)  # delta-only: the known-set short-circuits the trees
        assert db.backend.records == before
        got[pkg] = (lh, records(db))
        db.close()
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("use_native", [False, True], ids=lambda n: "native" if n else "py")
def test_flush_packed_matches_store_many(tmp_path, use_native):
    if use_native and load_native() is None:
        pytest.skip("no native node-store library here")
    got = {}
    for name, (mod, m) in both_maps(
            200, data=lambda i: hashlib.sha512(h(i)).digest()).items():
        ns = PACKAGES[name]
        db_p = ns.make_database(type="segstore", path=str(tmp_path / f"p-{name}"),
                                use_native=use_native and name == "port")
        n_p = m.flush(db_p.store_fn(ns.NodeObjectType.ACCOUNT_NODE), set(),
                      store_packed=db_p.store_packed_fn(ns.NodeObjectType.ACCOUNT_NODE))
        db_m = ns.make_database("memory")
        n_m = m.flush(db_m.store_fn(ns.NodeObjectType.ACCOUNT_NODE), set(),
                      store_many=db_m.store_many_fn(ns.NodeObjectType.ACCOUNT_NODE))
        assert n_p == n_m
        assert records(db_p) == records(db_m)
        got[name] = records(db_p)
        db_p.close()
    assert got["port"] == got["jax"]


def test_node_serializations_equal():
    """Prefix (node store) and wire formats of every node kind, and their
    parses, byte-equal to the JAX package's."""
    out = {}
    for name, mod in (("jax", jax_shamap), ("port", port_shamap)):
        state = mod.SHAMap()
        for i in range(40):
            state.set_item(mod.SHAMapItem(h(i), b"data%d" % i))
        two = mod.SHAMap()
        two.set_item(mod.SHAMapItem(h(1), b"a"))
        two.set_item(mod.SHAMapItem(h(2), b"b"))
        txs = mod.SHAMap(mod.TNType.TX_NM)
        txs.set_item(mod.SHAMapItem(mod.prefix_hash(0x534E4400, b"tx"), b"tx"))
        txmd = mod.SHAMap(mod.TNType.TX_MD)
        txmd.set_item(mod.SHAMapItem(h(9), b"tx+meta"))
        blobs = []
        for m in (state, two, txs, txmd):
            m.get_hash()
            for node in [m.root] + list(m.leaves()):
                for ser, deser in ((mod.serialize_node_prefix, mod.deserialize_node_prefix),
                                   (mod.serialize_node_wire, mod.deserialize_node_wire)):
                    blob = ser(node)
                    back = deser(blob)
                    parsed = (back.child_hashes if isinstance(back, mod.InnerStub)
                              else (back.item.tag, back.item.data, int(back.type)))
                    blobs.append((blob, parsed))
        out[name] = blobs
    assert out["port"] == out["jax"]
    assert any(b[-1] == 3 for b, _p in out["port"])  # a compressed wire inner
    with pytest.raises(ValueError):
        port_shamap.deserialize_node_wire(b"\x00" * 32 + bytes([200]) + bytes([3]))


def test_lazy_loads_raise():
    """A lazy load raises where a node is missing: at open for the
    header and the roots, at fault time for every other node, and a
    failed fault never gives way to an eager load."""
    db = port_ns.make_database("memory", async_writes=False)
    led = Ledger.genesis(ROOT)
    lh = led.save(db)
    with pytest.raises(KeyError):
        Ledger.load(db, b"\x01" * 32, lazy=True)
    with pytest.raises(port_shamap.MissingNodeError):
        port_shamap.SHAMap.from_store(lh, lambda _h: None, lazy=True)
    lazy = Ledger.load(db, lh, lazy=True)
    assert lazy.hash() == lh and lazy.state_map._source is not None
    port_shamap.inner_node_cache().clear()
    lazy.state_map._source.fetch = lambda _h: None
    with pytest.raises(port_shamap.MissingNodeError):
        list(lazy.state_map.items())
    assert lazy.state_map._source is not None


def test_configure_inner_cache_sets_the_byte_budget():
    cache = port_shamap.inner_node_cache()
    before = cache.limit_bytes
    try:
        port_shamap.configure_inner_cache(3)
        assert cache.limit_bytes == 3 << 20
        port_shamap.configure_inner_cache(0)  # at least one MB
        assert cache.limit_bytes == 1 << 20
    finally:
        cache.set_limit(before)


def test_eager_tree_never_takes_a_foreign_cache_entry():
    """Only a whole resolved Inner (or a leaf) may come out of the shared
    cache into an eager tree; any other entry under a node's hash (a
    lazy tree's LazyInner among them) is passed over and the node is
    loaded from the store."""
    m = port_shamap.SHAMap()
    for i in range(64):
        m.set_item(port_shamap.SHAMapItem(h(i), b"v%d" % i))
    db = port_ns.make_database("memory", async_writes=False)
    m.flush(db.store_fn(port_ns.NodeObjectType.ACCOUNT_NODE), db.flushed)
    cache = port_shamap.inner_node_cache()
    cache.clear()
    cache.put(m.get_hash(), object(), blob_len=516)

    def fetch(hh):
        o = db.fetch(hh)
        return o.data if o else None

    m2 = port_shamap.SHAMap.from_store(m.get_hash(), fetch)
    assert [lf.item.data for lf in m2.leaves()] == [lf.item.data for lf in m.leaves()]
    assert type(cache.get(m.get_hash())) is port_shamap.Inner
    # a second load is served whole from the cache: no fetch at all
    assert port_shamap.SHAMap.from_store(m.get_hash(), lambda _h: None).root is \
        cache.get(m.get_hash())
    cache.clear()


def test_hot_cache_evicts_as_the_jax_cache():
    """The same seeded sequence of eager and lazy puts, hits, epoch
    advances and limit changes leaves the same entries, in the same order,
    with the same counters, in both packages' HotNodeCache."""
    import random

    class Node:  # a leaf-like object with a sized item
        def __init__(self, n):
            self.item = type("I", (), {"data": b"x" * n})()

    caches = {"jax": jax_hotcache.HotNodeCache(limit_bytes=200_000),
              "port": port_hotcache.HotNodeCache(limit_bytes=200_000)}
    rng = random.Random(5)
    nodes = [Node(rng.randrange(10, 500)) for _ in range(300)]
    ops = []
    for _ in range(20_000):
        u = rng.random()
        k = rng.randrange(9000)
        if u < 0.6:
            ops.append(("put", k, rng.random() < 0.8, rng.random() < 0.1))
        elif u < 0.8:
            ops.append(("get", k))
        elif u < 0.9:
            ops.append(("load", k, rng.random() < 0.1))
        elif u < 0.99:
            ops.append(("epoch", rng.randrange(1, 50)))
        else:
            ops.append(("limit", rng.randrange(50_000, 400_000)))
    for name, c in caches.items():
        for op in ops:
            if op[0] == "put":
                key = op[1].to_bytes(32, "big")
                node = object() if op[2] else nodes[op[1] % len(nodes)]
                c.put(key, node, blob_len=516, eager=op[2], cold=op[3])
            elif op[0] == "get":
                c.get(op[1].to_bytes(32, "big"))
            elif op[0] == "load":  # a lazy tree's fault: a hit, or a cold or hot put
                c.get_or_load(op[1].to_bytes(32, "big"),
                              lambda _k, n=nodes[op[1] % len(nodes)]: (n, 100), cold=op[2])
            elif op[0] == "epoch":
                c.advance_epoch(op[1])
            else:
                c.set_limit(op[1])
    jax_c, port_c = caches["jax"], caches["port"]
    assert [(k, e[1:]) for k, e in port_c._data.items()] == \
        [(k, e[1:]) for k, e in jax_c._data.items()]
    assert port_c.get_json() == jax_c.get_json()
    assert port_c.evictions > 1000


def test_hot_cache_eviction_reads_no_entry_when_none_is_old():
    """A walk larger than the cache (a resumed node's first book-index
    rebuild faults its whole state tree): once over the bound, each
    insert evicts. The JAX cache's first pass reads every entry on every
    such insert, old or not; the port's reads none while no entry is
    old, and after an epoch makes every entry old it reads its victims
    alone. Both evict the same entries (test_hot_cache_evicts_as_the_jax_cache)."""
    from collections import OrderedDict

    class Counting(OrderedDict):
        read = 0

        def items(self):
            for kv in super().items():
                Counting.read += 1
                yield kv

        def values(self):
            for v in super().values():
                Counting.read += 1
                yield v

    class Leafish:
        item = type("I", (), {"data": b"x" * 100})()

    reads = {}
    for name, mod in (("jax", jax_hotcache), ("port", port_hotcache)):
        c = mod.HotNodeCache(limit_bytes=100_000)
        c._data = Counting()
        Counting.read = 0
        for i in range(3000):
            c.put(i.to_bytes(32, "big"), Leafish())
        over = Counting.read
        c.advance_epoch(1)
        Counting.read = 0
        c.put(b"\xff" * 32, Leafish())
        reads[name] = (over, Counting.read, c.evictions, c.epoch_first_evictions)
    port, jax = reads["port"], reads["jax"]
    assert port[2:] == jax[2:] and port[2] > 2000 and port[3] == 1
    assert port[:2] == (0, 1)
    assert jax[0] > 200 * jax[2]  # every resident entry (~250), every eviction


def test_flush_marks_known_only_after_the_store_accepts(monkeypatch):
    m = port_shamap.SHAMap()
    for i in range(100):
        m.set_item(port_shamap.SHAMapItem(h(i), b"v"))
    monkeypatch.setattr(port_shamap.SHAMap, "FLUSH_CHUNK", 16)
    known: set = set()
    accepted: list = []

    def store_packed(hashes, buf, offsets):
        if len(accepted) == 2:
            raise OSError("disk full")
        accepted.append(list(hashes))

    with pytest.raises(OSError):
        m.flush(None, known, store_packed=store_packed)
    assert known == {x for chunk in accepted for x in chunk} and len(known) == 32
    # retryable: a second flush writes everything the store never took
    rest: list = []
    n = m.flush(None, known, store_packed=lambda hs, b, o: rest.extend(hs))
    assert n == len(rest) and not (set(rest) & known - set(rest))


def test_header_goes_through_the_synchronous_door():
    """Ledger.save's header is in the backend when save returns, even on a
    façade with an async write-behind queue."""
    db = port_ns.make_database("memory")  # async writes
    led = Ledger.genesis(ROOT)
    lh = led.save(db)
    obj = db.backend.fetch(lh)
    assert obj is not None and obj.type == port_ns.NodeObjectType.LEDGER
    assert obj.data[4:] == led.header_bytes()
    db.close()
