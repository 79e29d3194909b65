"""The port's native codec, SHAMap pack and merge against the JAX package's.

The port compiles native/src/stser.cc into an extension of its own
(``stellard_tpu_torch.native.load_stser``: its own file, so its field
table and callbacks never meet the JAX package's in one process) and
takes the STObject codec, the node pack (``encode_nodes``) and the
write-set merge (``SHAMap.bulk_update``) from it.

- **Twins of the JAX tests.** Every test of tests/test_native.py
  (the native SHA-512, the cpplog backend, the batched verifier, the
  codec against the Python loops, the parser's error classes and its
  depth guard) and tests/test_tree_commit.py's ``TestBulkUpdateDifferential``
  and ``TestFlatBufferEncoder`` (merge and pack against the Python
  ones and per-key updates) run on their port twin: the module's
  source with ``stellard_tpu.`` read as ``stellard_tpu_torch.``.
- **Across the packages.** The native codec's bytes and objects equal
  the JAX package's; the native merge gives the Python merge's roots
  on eager and lazy trees, and the native pack the Python pack's bytes
  on trees with stubs and packed inners.

Tolerance zero: these are bytes and roots. Needs ``g++`` and the
interpreter's headers; without them the port runs its Python loops and
the tests that need the extension skip.
"""

from __future__ import annotations

import os
import random
import sys

import pytest

import stellard_tpu.protocol.stobject as jax_stobject
import stellard_tpu.state.shamap as jax_shamap
import stellard_tpu_torch.native as port_native
import stellard_tpu_torch.protocol.stobject as port_stobject
import stellard_tpu_torch.state.shamap as port_shamap
import test_native as jn
import test_ooc_state as jt
import test_tree_commit as jtc
from test_torch_consensus import cases, port_twin
from test_torch_txq import run_method

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import stser_fuzz  # noqa: E402

NATIVE = port_twin("test_native")
TREE = port_twin("test_tree_commit")
TREE_CLASSES = ("TestBulkUpdateDifferential", "TestFlatBufferEncoder")

pytestmark = pytest.mark.skipif(port_native.load_stser() is None,
                                reason="no C++ compiler or Python headers: no _stser")


def tree_cases() -> list:
    skip = [c for c in vars(jtc) if c.startswith("Test") and c not in TREE_CLASSES]
    return cases(jtc, skip=skip)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(jn))
def test_native_case_on_the_port(cname, mname, kwargs, tmp_path):
    assert port_stobject._get_stser() is not None
    run_method(NATIVE, getattr(NATIVE, cname), mname, tmp_path, kwargs)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), tree_cases())
def test_tree_commit_case_on_the_port(cname, mname, kwargs, tmp_path):
    assert port_shamap._resolve_native_pack() is not None
    assert port_shamap._resolve_native_merge() is not None
    run_method(TREE, getattr(TREE, cname), mname, tmp_path, kwargs)


def test_twins_cover_the_files():
    assert {p.values[0] for p in cases(jn)} >= {
        "TestNativeStser", "TestNativeStparse", "TestParserDoSResistance"}
    assert len(cases(jn)) >= 15 and len(tree_cases()) >= 12


def test_the_port_loads_its_own_extension():
    """Two files, two modules: the JAX package's registration cannot
    overwrite the port's field table or callbacks."""
    jax_mod, port_mod = jax_stobject._get_stser(), port_stobject._get_stser()
    assert port_mod is not None and port_mod is not jax_mod
    assert port_mod.__file__ == str(port_native.stser_path())
    assert port_native.BUILD_DIR in port_native.stser_path().parents


def blobs(n: int, seed: int) -> list[bytes]:
    rng = random.Random(seed)
    seeds = stser_fuzz.seed_blobs()
    return seeds + [stser_fuzz.mutate(rng, rng.choice(seeds)) for _ in range(n)]


def outcome(cls, blob: bytes):
    try:
        obj = cls.from_bytes(blob)
        return True, obj.serialize(), obj.serialize(signing=True)
    except Exception as exc:  # noqa: BLE001 — rejection is an outcome
        return False, type(exc).__name__, None


def test_native_codec_equals_the_jax_packages_and_its_python_loop(monkeypatch):
    """Each mutant through the port's native codec, the JAX package's,
    and the port's Python loops: the same verdict, error class and
    bytes (signing bytes too)."""
    corpus = blobs(4000, seed=44)
    native = [outcome(port_stobject.STObject, b) for b in corpus]
    jax = [outcome(jax_stobject.STObject, b) for b in corpus]
    monkeypatch.setattr(port_stobject, "_STSER", None)
    python = [outcome(port_stobject.STObject, b) for b in corpus]
    assert native == jax
    assert native == python
    assert 0 < sum(o[0] for o in native) < len(corpus)


# -- the merge and the pack on lazy trees ----------------------------------------


@pytest.fixture
def fresh_cache():
    fixture = jt._fresh_cache.__wrapped__()
    port_fixture = port_twin("test_ooc_state")._fresh_cache.__wrapped__()
    next(fixture)
    next(port_fixture)
    yield
    next(port_fixture, None)
    next(fixture, None)


def python_merge(monkeypatch):
    monkeypatch.setattr(port_shamap, "_resolve_native_merge", lambda: None)
    monkeypatch.setattr(port_shamap, "_resolve_native_pack", lambda: None)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_native_merge_gives_the_python_merges_roots(lazy, fresh_cache, monkeypatch):
    """Random sets (new keys and overwrites) and deletes, four rounds,
    on an eager tree and on a lazy one over the same store; the JAX
    package's tree (its own merge) alongside."""
    def run(shamap):
        m, store = jt._build(1500) if shamap is jax_shamap else \
            port_twin("test_ooc_state")._build(1500)
        tree = shamap.SHAMap.from_store(m.get_hash(), store.get, lazy=True) if lazy else m
        rng = random.Random(7)
        live = [jt._tag(f"k{i}") for i in range(1500)]
        roots = []
        for rnd in range(4):
            dels = rng.sample(live, 40)
            keep = [k for k in live if k not in set(dels)]
            sets = [shamap.SHAMapItem(k, b"over-%d-%d" % (rnd, i))
                    for i, k in enumerate(rng.sample(keep, 60))]
            sets += [shamap.SHAMapItem(jt._tag(f"n{rnd}-{i}"), b"new-%d" % i)
                     for i in range(30)]
            tree.bulk_update(sets=sets, deletes=dels)
            live = keep + [s.tag for s in sets if s.tag not in set(keep)]
            roots.append(tree.get_hash())
        return roots

    native = run(port_shamap)
    jax = run(jax_shamap)
    with monkeypatch.context() as mp:
        python_merge(mp)
        python = run(port_shamap)
    assert native == python == jax


def test_native_pack_equals_the_python_pack_on_a_lazy_tree(fresh_cache):
    """encode_nodes over a lazy tree's resolved inners (stub children,
    packed LazyInners) and its leaves: the same buffer and offsets."""
    m, store = port_twin("test_ooc_state")._build(700)
    lz = port_shamap.SHAMap.from_store(m.get_hash(), store.get, lazy=True)
    nodes, stack = [], [lz.root]
    while stack and len(nodes) < 400:
        node = port_shamap.resolve_node(stack.pop())
        nodes.append(node)
        if isinstance(node, port_shamap.Inner):
            stack.extend(c for c in node.children if c is not None)
    assert any(isinstance(n, port_shamap.LazyInner) for n in nodes)
    assert any(isinstance(n, port_shamap.Leaf) for n in nodes)
    assert port_shamap.encode_nodes(nodes) == port_shamap._encode_nodes_py(nodes)
