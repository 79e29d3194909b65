"""The port's out-of-core state against the JAX package's.

Every test of tests/test_ooc_state.py (lazy faulting, concurrent
faulting, the hot-node cache, history shards, the below-floor
account_tx routing, the native record scan) runs twice here, in one
test: once as it is (the JAX package) and once on its port twin (its
source with ``stellard_tpu.`` read as ``stellard_tpu_torch.``). Both
runs must pass, and what they leave must be equal, with zero tolerance:
the process-wide hot-node cache's counters (faults are the store
fetches of a lazy tree), every cache the test made, the root of every
tree it opened from a store, every shard store's counters, and every
shard file it wrote, byte for byte.

`test_mutation_byte_identity` switches the JAX package's native merge
on and off: its twin below runs the body on both packages with their
native merges off, then on (the port's through its own `_stser`
build). Then each
package opens, verifies and serves the other's shards and reads the
other's account_tx rows; a lazy tree sealed by the port's hasher
faults nothing; an eager load never takes a lazy node from the cache;
catch-up serving (GetLedger replies, fetch packs) faults a lazy tree
to the same nodes as the eager one; and two faults of the reference on
lazy trees are pinned (ROADMAP Queue C).
"""

from __future__ import annotations

import pytest

import stellard_tpu.nodestore.shards as jax_shards
import stellard_tpu.state.hotcache as jax_hotcache
import stellard_tpu.state.shamap as jax_shamap
import stellard_tpu_torch.nodestore.shards as port_shards
import stellard_tpu_torch.state.hotcache as port_hotcache
import stellard_tpu_torch.state.shamap as port_shamap
import test_ooc_state as jt
from test_torch_consensus import cases, plain_value, port_twin
from test_torch_txq import run_method

PKG = {
    "jax": (jax_shamap, jax_hotcache, jax_shards),
    "port": (port_shamap, port_hotcache, port_shards),
}
TWIN = {"jax": jt, "port": port_twin("test_ooc_state")}
COUNTERS = ("hits", "misses", "faults", "fault_shared", "evictions",
            "evicted_bytes", "epoch_first_evictions")
REPLACED = ("TestLazyFaulting.test_mutation_byte_identity",)


def counters(cache) -> dict:
    return {k: getattr(cache, k) for k in COUNTERS}


def recorded_run(pkg: str, cname: str, mname: str, kwargs: dict, tmp_path) -> dict:
    """Run one case of the test module of `pkg` and return what it left:
    the global cache's counters (zeroed first) and size, and the end state of
    every cache, opened tree and shard store the case made."""
    shamap, hotcache, shards = PKG[pkg]
    mod = TWIN[pkg]
    made = {"caches": [], "trees": [], "shards": []}
    with pytest.MonkeyPatch.context() as mp:
        for cls, key in ((hotcache.HotNodeCache, "caches"),
                         (shards.HistoryShardStore, "shards")):
            def init(obj, *a, _init=cls.__init__, _key=key, **kw):
                _init(obj, *a, **kw)
                made[_key].append(obj)

            mp.setattr(cls, "__init__", init)
        from_store = shamap.SHAMap.from_store.__func__

        def opened(cls, *a, **kw):
            tree = from_store(cls, *a, **kw)
            made["trees"].append(tree)
            return tree

        mp.setattr(shamap.SHAMap, "from_store", classmethod(opened))
        fixture = mod._fresh_cache.__wrapped__()
        next(fixture)
        try:
            cache = shamap.inner_node_cache()
            for k in COUNTERS:  # the case may reset one itself (faults)
                setattr(cache, k, 0)
            run_method(mod, getattr(mod, cname), mname, tmp_path=tmp_path, kwargs=kwargs)
            out = {
                "cache": counters(cache),
                "cache_size": (len(cache), cache.resident_bytes),
                "caches": [{k: v for k, v in c.get_json().items() if k != "name"}
                           for c in made["caches"] if c is not cache],
                "trees": [(type(t.root).__name__, (t.root._hash or b"").hex())
                          for t in made["trees"]],
                "shards": [(s.get_json(), s.shards()) for s in made["shards"]],
            }
        finally:
            next(fixture, None)
    return out


def shard_files(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file() and p.parent.name == "shards"}


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(jt, skip=REPLACED))
def test_ooc_state_case_equal_to_jax(cname, mname, kwargs, tmp_path):
    logs, files = {}, {}
    for pkg in ("jax", "port"):
        path = tmp_path / pkg
        path.mkdir()
        logs[pkg] = recorded_run(pkg, cname, mname, kwargs, path)
        files[pkg] = shard_files(path)
    assert logs["port"] == logs["jax"]
    assert files["port"] == files["jax"]
    if cname == "TestHistoryShards":
        assert files["jax"]


def test_twin_runs_cover_the_file():
    assert len(cases(jt, skip=REPLACED)) >= 22


# -- the native merge switch -----------------------------------------------


@pytest.mark.parametrize("jax_native", [False, True])
def test_mutation_byte_identity_on_the_python_merge(jax_native, monkeypatch):
    """test_mutation_byte_identity's body: on both packages with their
    native merges off, then on, every root after each step and the
    faults equal."""
    if jax_native:
        from stellard_tpu.native import load_stser

        if load_stser() is None:
            pytest.skip("the JAX package's native stser is not built here")
        assert port_shamap._resolve_native_merge() is not None
    else:
        monkeypatch.setattr(jax_shamap, "_native_merge", None)
        monkeypatch.setattr(jax_shamap, "_native_resolved", True)
        monkeypatch.setattr(port_shamap, "_resolve_native_merge", lambda: None)
    out = {}
    for pkg in ("jax", "port"):
        shamap, mod = PKG[pkg][0], TWIN[pkg]
        fixture = mod._fresh_cache.__wrapped__()
        next(fixture)
        try:
            cache = shamap.inner_node_cache()
            before = counters(cache)
            m, store = mod._build(800)
            lz = shamap.SHAMap.from_store(m.get_hash(), store.get, lazy=True)
            sets = [shamap.SHAMapItem(mod._tag(f"new{i}"), b"new-%d" % i) for i in range(50)]
            dels = [mod._tag(f"k{i}") for i in range(100, 160)]
            m.bulk_update(sets=sets, deletes=dels)
            lz.bulk_update(sets=sets, deletes=dels)
            roots = [lz.get_hash()]
            assert roots[-1] == m.get_hash()
            for tree in (m, lz):
                tree.set_item(shamap.SHAMapItem(mod._tag("solo"), b"solo"))
                tree.del_item(mod._tag("k3"))
            roots.append(lz.get_hash())
            assert roots[-1] == m.get_hash()
            after = counters(cache)
            out[pkg] = (roots, {k: after[k] - before[k] for k in COUNTERS})
        finally:
            next(fixture, None)
    assert out["port"] == out["jax"]


# -- shards across the packages ---------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_opens_verifies_and_serves_the_others_shards(writer, tmp_path):
    """Shards sealed by one package's rotation: the other opens the
    same index, verifies every shard from the file alone and serves
    the same segment bytes through its combined manifest."""
    reader = "port" if writer == "jax" else "jax"
    mod = TWIN[writer]
    run_method(mod, mod.TestHistoryShards, "test_rotate_seal_verify_and_serve",
               tmp_path=tmp_path)
    views = {}
    for pkg in (writer, reader):
        shards = PKG[pkg][2]
        ss = shards.HistoryShardStore(str(tmp_path / "shards"))
        rows = ss.shards()
        assert rows and all(ss.verify(r["id"])["ok"] for r in rows)
        seg = ss.segments()
        data = [ss.fetch_segment(r["id"]) for r in seg]
        recs = [list(ss.iter_records(r["id"])) for r in rows]
        views[pkg] = plain_value((rows, seg, data, recs, ss.range(),
                                  ss.contiguous_floor()))
        ss.close()
    assert views[reader] == views[writer]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_account_tx_rows(writer, tmp_path):
    """The account index and tx blobs of a shard sealed by one package,
    paged by the other: the same rows, markers and decoded blobs."""
    from stellard_tpu.protocol.keys import KeyPair

    reader = "port" if writer == "jax" else "jax"
    mod = TWIN[writer]
    run_method(mod, mod.TestHistoryShards, "test_account_tx_rows_roundtrip",
               tmp_path=tmp_path)
    acct = KeyPair.from_passphrase("masterpassphrase").account_id
    pages = {}
    for pkg in (writer, reader):
        ss = PKG[pkg][2].HistoryShardStore(str(tmp_path / "shards"))
        rows = ss.account_tx(acct, 1, 100, limit=100, forward=True)
        after = (rows[2]["ledger_seq"], rows[2]["txn_seq"])
        pages[pkg] = plain_value([
            rows,
            ss.account_tx(acct, 1, 100, forward=True, after=after),
            ss.account_tx(acct, 1, 100, forward=False, after=after),
            ss.account_tx(acct, 1, 100, limit=3, forward=False),
            [ss.tx_blob(r["shard"], r["txid"]) for r in rows],
        ])
        ss.close()
    assert len(pages[writer][0]) == 8
    assert pages[reader] == pages[writer]


def test_port_native_scan_matches_its_python_mirror(tmp_path):
    """The port's own segrecs_scan binding against the shards module's
    Python mirror, on a record image with a torn tail."""
    from stellard_tpu_torch.native import load_native, scan_segment_records
    from stellard_tpu_torch.utils.hashes import sha512_half

    if load_native() is None:
        pytest.skip("no C++ compiler: the port's native library is not built")
    records = []
    for i in range(64):
        blob = b"N" * (i % 7 + 1) + jt._tag(i)
        records.append((sha512_half(blob), i % 5, blob))
    img = port_shards._pack_records(records) + b"\x03torn"
    assert img[:-5] == jax_shards._pack_records(records)
    path = tmp_path / "recs.bin"
    path.write_bytes(img)
    native = scan_segment_records(str(path))
    assert native == list(port_shards._iter_records_py(img))
    assert native == list(jax_shards._iter_records_py(img))


# -- a lazy tree through the port's hasher ------------------------------------


def test_a_lazy_tree_seals_on_the_hasher_without_faults():
    """A lazy tree whose clean subtrees are stubs, made dirty and sealed
    by CudaHasher.hash_tree (its plain K2/K3 on the CPU): the root
    equals the JAX eager tree's and the seal faults no node; the
    hasher reads the stubs' hashes without resolving them."""
    from stellard_tpu_torch.crypto.backend import CudaHasher

    mod = TWIN["port"]
    fixture = mod._fresh_cache.__wrapped__()
    next(fixture)
    try:
        m, store = jt._build(3000)
        lz = port_shamap.SHAMap.from_store(m.get_hash(), store.get, lazy=True,
                                           hash_batch=CudaHasher(device="cpu"))
        sets = [(jt._tag(f"w{i}"), b"w-%d" % i) for i in range(40)]
        dels = [jt._tag(f"k{i}") for i in range(500, 530)]
        m.bulk_update(sets=[jax_shamap.SHAMapItem(k, v) for k, v in sets], deletes=dels)
        lz.bulk_update(sets=[port_shamap.SHAMapItem(k, v) for k, v in sets], deletes=dels)
        cache = port_shamap.inner_node_cache()
        faults = cache.faults
        assert lz.get_hash() == m.get_hash()
        assert cache.faults == faults
        assert lz.hash_batch.tree_calls == 1

        def clean(node) -> int:
            """The clean subtrees under the dirty path: stubs or faulted
            inners, never materialized by the seal."""
            if type(node) is port_shamap.Inner:
                return sum(clean(c) for c in node.children)
            return type(node) in (port_shamap.Stub, port_shamap.LazyInner)

        assert clean(lz.root) > 100
    finally:
        next(fixture, None)


# -- faults of the reference on lazy trees, not copied (ROADMAP Queue C) -------


def test_a_lazy_ledger_load_faults_two_roots_where_the_jax_one_faults_every_node():
    """JAX ``Ledger.__init__`` keeps ``tx_map or SHAMap(...)``: the truth
    test calls ``SHAMap.__len__``, which walks (and so faults) every
    node of both lazily loaded trees. The port tests ``is None``: its
    lazy load faults the roots and nothing else."""
    import stellard_tpu.nodestore as jax_ns
    import stellard_tpu.state.ledger as jax_ledger
    import stellard_tpu_torch.nodestore as port_ns
    import stellard_tpu_torch.state.ledger as port_ledger
    from stellard_tpu.protocol.keys import KeyPair

    root = KeyPair.from_passphrase("masterpassphrase").account_id
    faults = {}
    for pkg, ns, ledger in (("jax", jax_ns, jax_ledger), ("port", port_ns, port_ledger)):
        db = ns.make_database("memory", async_writes=False)
        led = ledger.Ledger.genesis(root)
        nxt = led.open_successor()
        for i in range(200):
            nxt.state_map.set_item(PKG[pkg][0].SHAMapItem(jt._tag(f"a{i}"), b"x%d" % i))
        nxt.close(close_time=1000, close_resolution=30)
        h = nxt.save(db)
        cache = PKG[pkg][0].inner_node_cache()
        cache.clear()
        before = cache.faults
        lazy = ledger.Ledger.load(db, h, lazy=True)
        assert lazy.hash() == h
        faults[pkg] = cache.faults - before
    assert faults["port"] == 1  # the state root: the tx tree is empty
    assert faults["jax"] > 200


def test_a_building_tree_over_a_lazy_root_merges_on_the_port():
    """The delta replay's building tree is a SHAMap over the lazy
    ledger's root, made without its source. The JAX package's native
    merge, told the tree is eager, fails on the first stub (its close
    then absorbs a fold error and seals in full); the port's native
    merge, given the stub door on every tree, faults the stubs on the
    op path and gives the eager tree's root."""
    from stellard_tpu_torch.native import load_stser

    if load_stser() is not None:
        assert port_shamap._resolve_native_merge() is not None
    out = {}
    for pkg in ("jax", "port"):
        shamap = PKG[pkg][0]
        m, store = jt._build(600)
        lz = shamap.SHAMap.from_store(m.get_hash(), store.get, lazy=True)
        building = shamap.SHAMap(shamap.TNType.ACCOUNT_STATE, lz.root)
        sets = [shamap.SHAMapItem(jt._tag(f"b{i}"), b"b-%d" % i) for i in range(30)]
        if pkg == "jax" and jax_shamap._resolve_native_merge() is not None:
            with pytest.raises(AttributeError):
                building.bulk_update(sets=sets)
        else:
            building.bulk_update(sets=sets)
            m.bulk_update(sets=sets)
            out[pkg] = (building.get_hash(), m.get_hash())
    assert out["port"][0] == out["port"][1]


def test_an_eager_load_after_lazy_faults_takes_no_lazy_inner():
    """A tree walked lazily leaves its LazyInners and leaves in the hot
    cache; an eager load of the same root then takes the cached leaves
    but never a LazyInner (its descendants are stubs): every inner node
    of the eager tree is a resolved Inner, and both packages fetch the
    same nodes from the store."""
    fetched = {}
    for pkg in ("jax", "port"):
        shamap, mod = PKG[pkg][0], TWIN[pkg]
        fixture = mod._fresh_cache.__wrapped__()
        next(fixture)
        try:
            m, store = mod._build(500)
            lz = shamap.SHAMap.from_store(m.get_hash(), store.get, lazy=True)
            assert len(list(lz.leaves())) == 500
            calls = []

            def fetch(h, calls=calls, store=store):
                calls.append(h)
                return store.get(h)

            eager = shamap.SHAMap.from_store(m.get_hash(), fetch)
            stack = [eager.root]
            while stack:
                node = stack.pop()
                if isinstance(node, shamap.Inner):
                    assert type(node) is shamap.Inner
                    stack.extend(c for c in node.children if c is not None)
                else:
                    assert type(node) is shamap.Leaf
            assert eager.get_hash() == m.get_hash()
            fetched[pkg] = sorted(calls)
        finally:
            next(fixture, None)
    assert fetched["port"] == fetched["jax"]


# -- catch-up serving from a lazy tree -----------------------------------------


def test_get_ledger_serving_and_fetch_packs_fault_a_lazy_tree():
    """node/inbound.serve_get_ledger and state/shamapsync's fetch packs
    on a lazily loaded ledger: each package serves the same nodes as
    from its eager load, the lazy tree faulting them on touch, and both
    packages' replies and packs are equal."""
    import importlib

    from stellard_tpu.protocol.keys import KeyPair

    acct = KeyPair.from_passphrase("masterpassphrase").account_id
    out = {}
    for pkg, root in (("jax", "stellard_tpu"), ("port", "stellard_tpu_torch")):
        mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
        ledger, inbound, wire = mod("state.ledger"), mod("node.inbound"), mod("overlay.wire")
        sync, ns, shamap = mod("state.shamapsync"), mod("nodestore"), PKG[pkg][0]
        db = ns.make_database("memory", async_writes=False)
        led = ledger.Ledger.genesis(acct)
        nxt = led.open_successor()
        for i in range(400):
            nxt.state_map.set_item(shamap.SHAMapItem(jt._tag(f"s{i}"), b"s-%d" % i))
        nxt.close(close_time=1000, close_resolution=30)
        h = nxt.save(db)
        shamap.inner_node_cache().clear()
        lazy = ledger.Ledger.load(db, h, lazy=True, cold=True)
        eager = ledger.Ledger.load(db, h)
        msg = wire.GetLedger(h, 0, 2, [])
        got = {}
        for name, led_ in (("lazy", lazy), ("eager", eager)):
            reply = inbound.serve_get_ledger(led_, msg)
            child = reply.nodes[1][0]
            deeper = inbound.serve_get_ledger(led_, wire.GetLedger(h, 0, 2, [child]))
            delta = sync.make_fetch_pack(led_.state_map, led.state_map)
            whole = sync.make_fetch_pack(led_.state_map)
            got[name] = (reply.nodes, deeper.nodes, list(delta), list(whole))
        assert got["lazy"] == got["eager"]
        out[pkg] = plain_value(got["lazy"])
    assert out["port"] == out["jax"]


def test_a_lazy_tree_takes_an_eager_subtree_from_the_cache_and_rewrites_it():
    """Shared with the reference (ROADMAP Queue C): NodeSource.load takes
    any cached node, an eager load's whole resolved Inner too, and flush
    skips only nodes that carry a source, so a lazy tree opened after an
    eager load of the same root rewrites clean subtrees into its own
    store. Both packages write the same nodes, more than the delta; with
    an empty cache the save writes the delta alone."""
    out = {}
    for pkg in ("jax", "port"):
        shamap, mod = PKG[pkg][0], TWIN[pkg]
        counts = []
        for warm in (False, True):
            fixture = mod._fresh_cache.__wrapped__()
            next(fixture)
            try:
                m, store = mod._build(1000)
                if warm:
                    shamap.SHAMap.from_store(m.get_hash(), store.get)  # eager
                known: set = set()  # a freshly opened store's flushed set
                lz = shamap.SHAMap.from_store(m.get_hash(), store.get, lazy=True,
                                              store_known=known)
                lz.set_item(shamap.SHAMapItem(mod._tag("k5"), b"changed"))
                counts.append(lz.flush({}.__setitem__, known=known))
            finally:
                next(fixture, None)
        out[pkg] = counts
    cold, warm = out["port"]
    assert cold <= 6 and warm > 100 * cold
    assert out["port"] == out["jax"]
