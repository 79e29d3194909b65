"""The port's path engine (paths/: flow, pathfinder, orderbook, quality)
and ``SHAMap.succ`` against the JAX package's.

The JAX package's path tests (tests/test_paths.py, the table-driven
corpus tests/test_path_corpus.py, and tests/test_path_plane.py's
``TestLiveBookIndexIdentity`` and ``TestQualityFlattening``) run here
again under test_torch_transactors.Mirror, widened to the calls those
tests make: every ``find_paths``, ``build_path_set``, ``flow`` and
``plan_strand`` answer, every order-book index (full scan and the
incremental ``LiveBookIndex``, with its counters), every Q16.16 rate and
rate matrix, and every engine apply must be equal between the packages,
on a port ledger paired with each JAX ledger. Tolerance: zero.

On a graph of market makers that bridge two gateways (more peers a node
than the pathfinder's candidate caps), the whole candidate set before
the trial executions must be equal, and so must the answers when the
searches are pre-ranked by each package's PathPlane (the port's with
its device evaluator on the CPU, which runs K4's plain version).

``SHAMap.succ`` is held to the JAX method on random trees: keys before
the first leaf, past the last, equal to a leaf, and between branches.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib

import numpy as np
import pytest

import stellard_tpu.paths.pathfinder as jax_pathfinder
import test_path_corpus
import test_path_plane
import test_paths
from stellard_tpu.paths.flow import PathError as JaxPathError
from stellard_tpu.paths.orderbook import LiveBookIndex as JaxLiveBookIndex
from stellard_tpu.paths.orderbook import OrderBookDB as JaxOrderBookDB
from stellard_tpu.state.shamap import SHAMap as JaxSHAMap
from stellard_tpu.state.shamap import SHAMapItem as JaxItem
from stellard_tpu_torch.paths import pathfinder as port_pathfinder
from stellard_tpu_torch.paths import quality as port_quality
from stellard_tpu_torch.paths.orderbook import LiveBookIndex, OrderBookDB
from stellard_tpu_torch.state.shamap import SHAMap, SHAMapItem
import test_engine
from test_torch_transactors import Mirror, answers_key, path_key, port_amount, port_path

# the module (the package's name `flow` is the function)
port_flow_mod = importlib.import_module("stellard_tpu_torch.paths.flow")


def book_key(b):
    return (b.in_currency, b.in_issuer, b.out_currency, b.out_issuer)


def books_key(books):
    return sorted(book_key(b) for b in books)


def hops_key(hops):
    return [(type(h).__name__, dataclasses.astuple(h)) for h in hops]


def candidates_of(candidates):
    return [(port_path(path), asset) for path, asset in candidates]


class PathMirror(Mirror):
    """Mirror, also over the path tests' module-level names."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch, modules=(test_paths, test_path_corpus, test_path_plane))
        self.indexes = self.quality = self.strands = 0
        mirror = self

        class MirroredOrderBookDB(JaxOrderBookDB):
            def setup(self, ledger):
                out = super().setup(ledger)
                port = OrderBookDB().setup(mirror.port_for(ledger))
                assert books_key(port.books) == books_key(out.books)
                mirror.indexes += 1
                return out

        class MirroredLiveBookIndex:
            """The JAX index and the port's, advanced together."""

            def __init__(self, incremental: bool = True):
                self.jax = JaxLiveBookIndex(incremental=incremental)
                self.port = LiveBookIndex(incremental=incremental)

            def __getattr__(self, name):
                return getattr(self.jax, name)

            def advance(self, ledger):
                db = self.jax.advance(ledger)
                pl = mirror.port_for(ledger)
                assert pl.hash() == ledger.hash()
                pdb = self.port.advance(pl)
                assert books_key(pdb.books) == books_key(db.books)
                assert self.port.counters() == self.jax.counters()
                mirror.indexes += 1
                return db

            def books_if_current(self, ledger):
                db = self.jax.books_if_current(ledger)
                pdb = self.port.books_if_current(mirror.port_for(ledger))
                assert (pdb is None) == (db is None)
                assert self.port.counters() == self.jax.counters()
                return db

        def plan_strand(src, dst, dst_amount, c, i, path):
            try:
                want = self._plan_strand(src, dst, dst_amount, c, i, path)
            except JaxPathError as e:
                with pytest.raises(port_flow_mod.PathError) as got:
                    port_flow_mod.plan_strand(src, dst, port_amount(dst_amount), c, i,
                                              port_path(path))
                assert int(got.value.ter) == int(e.ter)
                self.strands += 1
                raise
            got = port_flow_mod.plan_strand(src, dst, port_amount(dst_amount), c, i,
                                            port_path(path))
            assert hops_key(got) == hops_key(want)
            self.strands += 1
            return want

        def build_path_set(ledger, src, dst, dst_amount, send_max=None, **kw):
            want = self._build_path_set(ledger, src, dst, dst_amount, send_max, **kw)
            got = port_pathfinder.build_path_set(
                self.port_for(ledger), src, dst, port_amount(dst_amount),
                port_amount(send_max), **kw)
            assert [path_key(p) for p in got] == [path_key(p) for p in want]
            self.searches += 1
            return want

        def book_quality_q16(ledger, book):
            want = self._book_quality(ledger, book)
            got = port_quality.book_quality_q16(
                self.port_for(ledger), port_quality.Book(*book_key(book)))
            assert got == want
            self.quality += 1
            return want

        def build_rate_matrix(ledger, candidates):
            want = self._rate_matrix(ledger, candidates)
            got = port_quality.build_rate_matrix(self.port_for(ledger),
                                                 candidates_of(candidates))
            assert got.dtype == want.dtype and np.array_equal(got, want)
            self.quality += 1
            return want

        def rate_u64_to_q16(q, num=1, den=1):
            want = self._rate_u64(q, num, den)
            assert port_quality.rate_u64_to_q16(q, num, den) == want
            self.quality += 1
            return want

        self._plan_strand = test_paths.plan_strand
        self._build_path_set = jax_pathfinder.build_path_set
        self._book_quality = test_path_plane.book_quality_q16
        self._rate_matrix = test_path_plane.build_rate_matrix
        self._rate_u64 = test_path_plane.rate_u64_to_q16
        monkeypatch.setattr(test_paths, "plan_strand", plan_strand)
        monkeypatch.setattr(jax_pathfinder, "build_path_set", build_path_set)
        for mod in (test_paths, test_path_corpus, test_path_plane):
            monkeypatch.setattr(mod, "OrderBookDB", MirroredOrderBookDB)
        monkeypatch.setattr(test_path_plane, "LiveBookIndex", MirroredLiveBookIndex)
        monkeypatch.setattr(test_path_plane, "book_quality_q16", book_quality_q16)
        monkeypatch.setattr(test_path_plane, "build_rate_matrix", build_rate_matrix)
        monkeypatch.setattr(test_path_plane, "rate_u64_to_q16", rate_u64_to_q16)


@pytest.fixture
def path_mirror(monkeypatch):
    m = PathMirror(monkeypatch)
    yield m
    assert m.applies + m.searches + m.flows + m.indexes + m.quality + m.strands > 0, (
        "the mirrored test compared nothing")


def _mirrored(cls):
    """A subclass of a JAX test class whose tests run under PathMirror."""
    return pytest.mark.usefixtures("path_mirror")(
        type(cls.__name__ + "Mirrored", (cls,), {"__module__": __name__}))


# --------------------------------------------------------------------------
# tests/test_paths.py

TestPlanStrandMirrored = _mirrored(test_paths.TestPlanStrand)
TestFlowSameCurrencyMirrored = _mirrored(test_paths.TestFlowSameCurrency)
TestFlowCrossCurrencyMirrored = _mirrored(test_paths.TestFlowCrossCurrency)
TestPathfinderMirrored = _mirrored(test_paths.TestPathfinder)
TestOrderBookDBMirrored = _mirrored(test_paths.TestOrderBookDB)
TestReviewRegressionsMirrored = _mirrored(test_paths.TestReviewRegressions)

# --------------------------------------------------------------------------
# tests/test_path_corpus.py

TestCorpusSameCurrencyMirrored = _mirrored(test_path_corpus.TestCorpusSameCurrency)
TestCorpusCrossCurrencyMirrored = _mirrored(test_path_corpus.TestCorpusCrossCurrency)
TestCorpusPathfinderMirrored = _mirrored(test_path_corpus.TestCorpusPathfinder)
TestCorpusReversePassMirrored = _mirrored(test_path_corpus.TestCorpusReversePass)
TestReferenceIssueCasesMirrored = _mirrored(test_path_corpus.TestReferenceIssueCases)
TestReferenceTransferRateMirrored = _mirrored(test_path_corpus.TestReferenceTransferRate)
TestReferencePathTableMirrored = _mirrored(test_path_corpus.TestReferencePathTable)
TestLineQualitiesMirrored = _mirrored(test_path_corpus.TestLineQualities)
TestThirdPartyIssuerDefaultPathMirrored = _mirrored(
    test_path_corpus.TestThirdPartyIssuerDefaultPath)
TestNewPathSuiteT4Mirrored = _mirrored(test_path_corpus.TestNewPathSuiteT4)
TestNewPathSuiteSnapSwapMirrored = _mirrored(test_path_corpus.TestNewPathSuiteSnapSwap)
TestNewPathSuiteCNYMirrored = _mirrored(test_path_corpus.TestNewPathSuiteCNY)

# --------------------------------------------------------------------------
# tests/test_path_plane.py: the incremental index and the flattening

TestLiveBookIndexIdentityMirrored = _mirrored(test_path_plane.TestLiveBookIndexIdentity)
TestQualityFlatteningMirrored = _mirrored(test_path_plane.TestQualityFlattening)


# --------------------------------------------------------------------------
# SHAMap.succ


def _trees(n: int, seed: int):
    rng = np.random.default_rng(seed)
    keys = [hashlib.sha256(b"succ:%d:%d" % (seed, i)).digest() for i in range(n)]
    if n >= 4:
        # keys that share long prefixes, so branches split deep
        base = bytearray(keys[0])
        for j in range(3):
            base[31 - j] ^= 0x10
            keys.append(bytes(base))
    data = [rng.bytes(int(rng.integers(8, 40))) for _ in keys]
    jm, tm = JaxSHAMap(), SHAMap()
    for k, d in zip(keys, data):
        jm.set_item(JaxItem(k, d))
        tm.set_item(SHAMapItem(k, d))
    return sorted(keys), jm, tm


def _probes(keys, seed: int):
    rng = np.random.default_rng(seed + 100)
    probes = [b"\x00" * 32, b"\xff" * 32]
    for k in keys:
        probes.append(k)
        v = int.from_bytes(k, "big")
        probes += [(v - 1).to_bytes(32, "big"), min(v + 1, 2**256 - 1).to_bytes(32, "big")]
        # a key between branches: same first nibbles, then past this one
        probes.append(k[:1] + b"\xff" * 31)
    probes += [rng.bytes(32) for _ in range(64)]
    return probes


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 1), (2, 2), (17, 3), (300, 4)])
def test_succ_equal_to_jax(n, seed):
    keys, jm, tm = _trees(n, seed)
    assert tm.get_hash() == jm.get_hash()
    for probe in _probes(keys, seed):
        want = jm.succ(probe)
        got = tm.succ(probe)
        assert (got is None) == (want is None), probe.hex()
        if got is not None:
            assert (got.tag, got.data) == (want.tag, want.data)
            assert got.tag > probe
        # the strictly-greater successor by a linear scan
        nxt = next((k for k in keys if k > probe), None)
        assert (got.tag if got else None) == nxt


def test_succ_after_deletes_equal_to_jax():
    keys, jm, tm = _trees(120, 9)
    for k in keys[::3]:
        jm.del_item(k)
        tm.del_item(k)
    left = [k for i, k in enumerate(keys) if i % 3]
    for probe in _probes(keys, 9):
        want, got = jm.succ(probe), tm.succ(probe)
        assert (got.tag if got else None) == (want.tag if want else None)
        assert (got.tag if got else None) == next((k for k in left if k > probe), None)


# --------------------------------------------------------------------------
# candidate sets past the caps, and the pre-rank


def _maker_net(n_makers: int = 14):
    """Two gateways' USD, bridged by market makers that trust both, with
    STR books on both sides; users A (USD/G1) and B (USD/G2)."""
    from stellard_tpu.protocol.formats import TxType
    from stellard_tpu.protocol.keys import KeyPair
    from stellard_tpu.protocol.sfields import sfTakerGets, sfTakerPays
    from stellard_tpu.protocol.stamount import STAmount as JaxSTAmount

    g1, g2 = KeyPair.from_passphrase("cand-g1"), KeyPair.from_passphrase("cand-g2")
    a, b = KeyPair.from_passphrase("cand-a"), KeyPair.from_passphrase("cand-b")
    makers = [KeyPair.from_passphrase(f"cand-m{i}") for i in range(n_makers)]
    net = test_engine.Net(g1, g2, a, b, *makers)
    usd = lambda v, g: JaxSTAmount.from_iou(test_engine.USD, g.account_id, v, 0)  # noqa: E731
    net.trust(a, g1, 10_000)
    net.trust(b, g2, 10_000)
    net.pay(g1, a.account_id, usd(500, g1))
    for i, m in enumerate(makers):
        net.trust(m, g1, 10_000)
        net.trust(m, g2, 10_000)
        net.pay(g2, m.account_id, usd(200 + i, g2))
        net.pay(g1, m.account_id, usd(100 + i, g1))
        if i % 3 == 0:  # some makers also quote USD/G2 for STR
            net.apply(m, TxType.ttOFFER_CREATE, fields={
                sfTakerPays: JaxSTAmount.from_drops((50 + i) * 1_000_000),
                sfTakerGets: usd(40, g2)})
    return net, a, b, g2


@pytest.mark.parametrize("prune_floor", [1, 4, 64])
def test_candidates_and_pre_rank_equal_on_a_maker_graph(monkeypatch, prune_floor):
    from stellard_tpu.crypto.backend import make_path_evaluator as jax_evaluator
    from stellard_tpu.paths.plane import PathPlane as JaxPathPlane
    from stellard_tpu.paths.pathfinder import _candidate_paths as jax_candidates
    from stellard_tpu.state.entryset import LedgerEntrySet as JaxLES
    from stellard_tpu_torch.crypto.backend import make_path_evaluator
    from stellard_tpu_torch.paths.plane import PathPlane
    from stellard_tpu_torch.state.entryset import LedgerEntrySet

    m = Mirror(monkeypatch)
    net, a, b, g2 = _maker_net()
    jl = net.ledger
    pl = m.port_for(jl)
    amount = test_engine.STAmount.from_iou(test_engine.USD, g2.account_id, 30, 0)
    jax_books, port_books = JaxOrderBookDB().setup(jl), OrderBookDB().setup(pl)
    spend_g1 = test_engine.STAmount.from_iou(test_engine.USD, a.account_id, 40, 0)
    counts = []
    for send_max in (None, spend_g1):
        want = jax_candidates(JaxLES(jl), a.account_id, b.account_id, amount, send_max,
                              jax_books)
        got = port_pathfinder._candidate_paths(
            LedgerEntrySet(pl), a.account_id, b.account_id, port_amount(amount),
            port_amount(send_max), port_books)
        assert [(path_key(p), asset) for p, asset in got] == [
            (path_key(p), asset) for p, asset in want]
        counts.append(len(want))
    assert min(counts) > 10, counts  # past the 10-a-node cap

    jax_plane = JaxPathPlane(evaluator=jax_evaluator(routing="host"),
                             prune_floor=prune_floor, prune_keep=3)
    port_plane = PathPlane(evaluator=make_path_evaluator(routing="device", device="cpu"),
                           prune_floor=prune_floor, prune_keep=3)
    want = m._find_paths(jl, a.account_id, b.account_id, amount,
                         pre_rank=jax_plane.make_pre_rank(jl))
    got = port_pathfinder.find_paths(pl, a.account_id, b.account_id, port_amount(amount),
                                     pre_rank=port_plane.make_pre_rank(pl))
    assert answers_key(got) == answers_key(want) and want
    pj, pp = jax_plane.get_json(), port_plane.get_json()
    assert (pp["prune_batches"], pp["pruned_candidates"]) == (
        pj["prune_batches"], pj["pruned_candidates"])
    # one search: pre-ranked, and cut to the best prune_keep (the empty
    # default path kept besides), only above the floor
    assert pp["prune_batches"] == int(counts[0] > prune_floor)
    assert (pp["pruned_candidates"] > 0) == (counts[0] > prune_floor)
