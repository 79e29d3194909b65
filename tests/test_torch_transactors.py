"""Every transactor of the port (engine/) against the JAX package's.

Two ways in, both with a tolerance of zero (these are bytes):

- **Mirrored flows.** The JAX package's own engine tests
  (tests/test_engine.py ``TestTrustAndIOU``, ``TestOffers``,
  ``TestAccountOps``, ``TestInflation``, ``TestTrustAutoClear``,
  ``TestAccountSetFlags``; tests/test_bridged_offers.py) run here again
  with a :class:`Mirror` installed: every ``apply_transaction`` of the
  JAX engine is applied, from the same blob, by the port's engine to a
  port ledger paired with the JAX one, and the TER, whether it applied,
  the transaction's metadata bytes, the state tree hash and the header
  fields must be equal after each transaction. A ``find_paths`` or
  ``flow`` a flow calls is mirrored too (answers compared), and so is
  the ``LedgerEntrySet.apply`` that commits a ``flow``.
- **Streams through both LedgerMasters.** ``testkit.workloads.
  order_book_crossfire`` and the shapes of bench.py's offer-mix and
  regular-key workloads (BASELINE configs #2 and #3) are submitted to the
  JAX ``LedgerMaster`` (its defaults, delta replay on) and to the port's,
  one close per step, and every TER and ledger hash must be equal.
"""

from __future__ import annotations

import random

import pytest

import stellard_tpu.engine.engine as jax_engine_mod
import stellard_tpu.paths as jax_paths
import stellard_tpu.state.entryset as jax_entryset
import test_bridged_offers
import test_engine
from stellard_tpu.engine import TxParams as JaxTxParams
from stellard_tpu.node.ledgermaster import LedgerMaster as JaxLedgerMaster
from stellard_tpu.protocol.sttx import SerializedTransaction as JaxSTTx
from stellard_tpu_torch.engine import TransactionEngine, TxParams
from stellard_tpu_torch.interop import shamap_from_items
from stellard_tpu_torch.node.ledgermaster import LedgerMaster
from stellard_tpu_torch.paths import find_paths as port_find_paths
from stellard_tpu_torch.paths import flow as port_flow
from stellard_tpu_torch.protocol.serializer import BinaryParser
from stellard_tpu_torch.protocol.stamount import STAmount
from stellard_tpu_torch.protocol.stobject import PathElement
from stellard_tpu_torch.protocol.sttx import SerializedTransaction
from stellard_tpu_torch.protocol.ter import TER
from stellard_tpu_torch.state.entryset import LedgerEntrySet
from stellard_tpu_torch.state.ledger import Ledger
from stellard_tpu_torch.state.shamap import TNType

_HEADER = ("seq", "parent_hash", "tot_coins", "fee_pool", "inflation_seq",
           "close_time", "parent_close_time", "close_resolution", "close_flags")
_SCHEDULE = ("base_fee", "reference_fee_units", "reserve_base",
             "reserve_increment", "load_factor")


# --------------------------------------------------------------------------
# carrying JAX values into the port


def port_amount(a):
    """A JAX STAmount -> the port's, through its wire bytes."""
    return None if a is None else STAmount.deserialize(BinaryParser(a.wire_bytes()))


def port_path(path):
    return [PathElement(account=e.account, currency=e.currency, issuer=e.issuer)
            for e in path]


def amount_key(a):
    return None if a is None else a.wire_bytes()


def path_key(path):
    return tuple((e.account, e.currency, e.issuer) for e in path)


def answers_key(alts):
    """find_paths answers as plain values, for either package."""
    return [
        (tuple(path_key(p) for p in alt["paths"]), amount_key(alt["source_amount"]),
         amount_key(alt["delivered"]))
        for alt in alts
    ]


def port_ledger_of(jl) -> Ledger:
    """A port ledger holding the JAX ledger's header, fee schedule, open
    sequences and both trees, leaf for leaf."""
    leaves = lambda m: [(lf.item.tag, lf.item.data, int(lf.type)) for lf in m.leaves()]  # noqa: E731
    led = Ledger(**{k: getattr(jl, k) for k in _HEADER},
                 state_map=shamap_from_items(leaves(jl.state_map), TNType.ACCOUNT_STATE),
                 tx_map=shamap_from_items(leaves(jl.tx_map), TNType.TX_MD))
    for k in _SCHEDULE:
        setattr(led, k, getattr(jl, k))
    led.closed = jl.closed
    led.open_tx_seqs = dict(jl.open_tx_seqs)
    assert led.state_map.get_hash() == jl.state_map.get_hash()
    assert led.tx_map.get_hash() == jl.tx_map.get_hash()
    return led


def header_key(led):
    return tuple(getattr(led, k) for k in _HEADER + _SCHEDULE)


# --------------------------------------------------------------------------
# the mirror


class Mirror:
    """Pairs each JAX ledger a JAX test touches with a port ledger and
    repeats every engine apply, path search and flow on it.

    A pair is made (from the JAX ledger's current trees and header) the
    first time a JAX ledger is seen, and made again when the JAX ledger
    was changed outside a mirrored call: closed in place, or a header
    field set by the test's own hand. Two inputs are carried over before each apply:
    ``parent_close_time``, which tests set directly, and the JAX engine's
    metadata index (``tx_seq``), which its engine keeps across applies."""

    def __init__(self, monkeypatch, modules=()):
        self.pairs: dict[int, tuple] = {}
        self.les_pairs: dict[int, tuple] = {}
        self.applies = self.searches = self.flows = 0
        self._apply = jax_engine_mod.TransactionEngine.apply_transaction
        self._find_paths = jax_paths.find_paths
        self._flow = jax_paths.flow
        self._les_apply = jax_entryset.LedgerEntrySet.apply
        mirror = self

        def apply_transaction(engine, tx, params=JaxTxParams.NONE):
            return mirror.apply(engine, tx, params)

        def les_apply(les):
            return mirror.les_apply(les)

        monkeypatch.setattr(jax_engine_mod.TransactionEngine, "apply_transaction",
                            apply_transaction)
        monkeypatch.setattr(jax_entryset.LedgerEntrySet, "apply", les_apply)
        for mod in (jax_paths, *modules):
            if hasattr(mod, "find_paths"):
                monkeypatch.setattr(mod, "find_paths", self.find_paths)
            if hasattr(mod, "flow"):
                monkeypatch.setattr(mod, "flow", self.flow)

    def port_for(self, jl) -> Ledger:
        hit = self.pairs.get(id(jl))
        if hit is not None and hit[0] is jl:
            pl = hit[1]
            if (pl.state_map.get_hash() == jl.state_map.get_hash()
                    and pl.tx_map.get_hash() == jl.tx_map.get_hash()
                    and header_key(pl) == header_key(jl) and pl.closed == jl.closed):
                return pl
        pl = port_ledger_of(jl)
        self.pairs[id(jl)] = (jl, pl)
        return pl

    def check_pair(self, jl, pl, what: str) -> None:
        assert pl.state_map.get_hash() == jl.state_map.get_hash(), f"{what}: state hash"
        assert pl.tx_map.get_hash() == jl.tx_map.get_hash(), f"{what}: tx hash"
        assert header_key(pl) == header_key(jl), f"{what}: header"

    def apply(self, engine, tx, params):
        jl = engine.ledger
        pl = self.port_for(jl)
        pl.parent_close_time = jl.parent_close_time
        port_engine = TransactionEngine(pl)
        port_engine.tx_seq = engine.tx_seq  # the JAX engine's metadata index so far
        blob = tx.serialize()
        want = self._apply(engine, tx, params)
        ptx = SerializedTransaction.from_bytes(blob)
        got = port_engine.apply_transaction(ptx, int(params))
        what = f"{tx.tx_type.name} -> {want[0]!r}"
        assert (int(got[0]), got[1]) == (int(want[0]), want[1]), what
        assert port_engine.tx_seq == engine.tx_seq, what
        assert pl.get_transaction(ptx.txid()) == jl.get_transaction(tx.txid()), what
        self.check_pair(jl, pl, what)
        self.applies += 1
        return want

    def find_paths(self, ledger, src, dst, dst_amount, send_max=None, **kw):
        want = self._find_paths(ledger, src, dst, dst_amount, send_max, **kw)
        pkw = {k: v for k, v in kw.items() if k not in ("books", "pre_rank")}
        assert kw.get("pre_rank") is None, "a JAX pre_rank cannot be mirrored"
        got = port_find_paths(self.port_for(ledger), src, dst, port_amount(dst_amount),
                              port_amount(send_max), **pkw)
        assert answers_key(got) == answers_key(want)
        self.searches += 1
        return want

    def flow(self, les, src, dst, dst_amount, send_max, paths, partial,
             parent_close_time, *args, **kw):
        assert not les._entries, "flow on a JAX entry set that already holds changes"
        pl = self.port_for(les.ledger)
        ples = LedgerEntrySet(pl)
        want = self._flow(les, src, dst, dst_amount, send_max, paths, partial,
                          parent_close_time, *args, **kw)
        got = port_flow(ples, src, dst, port_amount(dst_amount), port_amount(send_max),
                        [port_path(p) for p in paths], partial, parent_close_time,
                        *args, **kw)
        assert (int(got[0]), amount_key(got[1]), amount_key(got[2])) == (
            int(want[0]), amount_key(want[1]), amount_key(want[2]))
        self.les_pairs[id(les)] = (les, ples)
        self.flows += 1
        return want

    def les_apply(self, les):
        out = self._les_apply(les)
        hit = self.les_pairs.pop(id(les), None)
        if hit is not None and hit[0] is les:
            hit[1].apply()
            self.check_pair(les.ledger, hit[1].ledger, "flow commit")
        return out


@pytest.fixture
def mirror(monkeypatch):
    m = Mirror(monkeypatch)
    yield m
    assert m.applies > 0, "the mirrored flow applied no transaction"


# --------------------------------------------------------------------------
# the JAX package's engine flows, mirrored


@pytest.mark.usefixtures("mirror")
class TestTrustAndIOUMirrored(test_engine.TestTrustAndIOU):
    pass


@pytest.mark.usefixtures("mirror")
class TestOffersMirrored(test_engine.TestOffers):
    pass


@pytest.mark.usefixtures("mirror")
class TestAccountOpsMirrored(test_engine.TestAccountOps):
    pass


@pytest.mark.usefixtures("mirror")
class TestInflationMirrored(test_engine.TestInflation):
    pass


@pytest.mark.usefixtures("mirror")
class TestTrustAutoClearMirrored(test_engine.TestTrustAutoClear):
    pass


@pytest.mark.usefixtures("mirror")
class TestAccountSetFlagsMirrored(test_engine.TestAccountSetFlags):
    pass


@pytest.mark.usefixtures("mirror")
class TestAutoBridgeMirrored(test_bridged_offers.TestAutoBridge):
    pass


def test_mirror_sees_every_transactor(monkeypatch):
    """The mirrored flows reach every transaction type the JAX engine
    applies, and a mismatch would be caught: the mirror's checks are
    live (a port ledger with one byte of state changed fails them)."""
    m = Mirror(monkeypatch)
    seen_types = set()
    orig = m.apply

    def spy(engine, tx, params):
        seen_types.add(tx.tx_type.name)
        return orig(engine, tx, params)

    m.apply = spy
    for cls in (test_engine.TestTrustAndIOU, test_engine.TestOffers,
                test_engine.TestAccountOps, test_engine.TestInflation,
                test_bridged_offers.TestAutoBridge):
        for name in dir(cls):
            if name.startswith("test_"):
                getattr(cls(), name)()
    assert {"ttPAYMENT", "ttTRUST_SET", "ttOFFER_CREATE", "ttOFFER_CANCEL",
            "ttACCOUNT_SET", "ttREGULAR_KEY_SET", "ttACCOUNT_MERGE",
            "ttINFLATION"} <= seen_types
    net = test_engine.Net(test_engine.ALICE)
    net.pay(test_engine.ROOT_KEY, test_engine.BOB.account_id,
            test_engine.STAmount.from_drops(300 * 1_000_000))
    pl = m.port_for(net.ledger)
    pl.fee_pool += 1
    with pytest.raises(AssertionError, match="header"):
        m.check_pair(net.ledger, pl, "tampered")


# --------------------------------------------------------------------------
# pseudo-transactions (Amendment, Fee): no JAX test applies them


def _pseudo(kind: str, seq: int) -> bytes:
    """A JAX pseudo-transaction blob: an Amendment or a Fee change
    (account zero, no fee, no signature)."""
    from stellard_tpu.protocol.formats import TxType as JaxTxType
    from stellard_tpu.protocol.sfields import (
        sfAmendment, sfBaseFee, sfReferenceFeeUnits, sfReserveBase,
        sfReserveIncrement, sfSigningPubKey)

    fields = ({sfAmendment: bytes([seq]) * 32} if kind == "amendment" else {
        sfBaseFee: 10 + seq, sfReferenceFeeUnits: 10,
        sfReserveBase: 200_000_000 + seq, sfReserveIncrement: 50_000_000})
    tx_type = JaxTxType.ttAMENDMENT if kind == "amendment" else JaxTxType.ttFEE
    return JaxSTTx.build(tx_type, b"\x00" * 20, 0, 0,
                         {**fields, sfSigningPubKey: b""}).serialize()


@pytest.mark.parametrize("kind", ["amendment", "fee"])
@pytest.mark.parametrize("mode", ["close", "open"])
def test_pseudo_transactions_equal(kind, mode):
    from stellard_tpu.engine import TransactionEngine as JaxEngine
    from stellard_tpu.state.ledger import Ledger as JaxLedger

    root = test_engine.ROOT_KEY.account_id
    jl = JaxLedger.genesis(root)
    pl = port_ledger_of(jl)
    params = 0 if mode == "close" else int(TxParams.OPEN_LEDGER)
    for seq in (1, 2, 1):
        blob = _pseudo(kind, seq)
        want = JaxEngine(jl).apply_transaction(JaxSTTx.from_bytes(blob), params)
        got = TransactionEngine(pl).apply_transaction(
            SerializedTransaction.from_bytes(blob), params)
        assert (int(got[0]), got[1]) == (int(want[0]), want[1])
        tid = JaxSTTx.from_bytes(blob).txid()
        assert pl.get_transaction(tid) == jl.get_transaction(tid)
        assert header_key(pl) == header_key(jl)
        assert pl.state_map.get_hash() == jl.state_map.get_hash()


# --------------------------------------------------------------------------
# streams through both LedgerMasters


def _both_masters(steps, close_time=530_000_000):
    """Run each step's blobs (a list per close) through the JAX and the
    port LedgerMaster from the same genesis; -> per package the log of
    TERs, results and ledger hashes."""
    logs = []
    for lm, parse, mode in (
        (JaxLedgerMaster(), JaxSTTx.from_bytes, JaxTxParams.OPEN_LEDGER | JaxTxParams.RETRY),
        # the port's default hasher (hashlib): the seal on K2/K3 and their
        # plain versions is held to the JAX package in test_torch_close.py
        (LedgerMaster(), SerializedTransaction.from_bytes,
         TxParams.OPEN_LEDGER | TxParams.RETRY),
    ):
        lm.start_new_ledger(test_engine.ROOT_KEY.account_id, close_time=close_time)
        log = []
        try:
            for k, blobs in enumerate(steps):
                ters = [int(lm.do_transaction(parse(b), mode)[0]) for b in blobs]
                led, results = lm.close_and_advance(close_time + 30 * (k + 1), 30)
                log.append((ters, sorted((t, int(r)) for t, r in results.items()),
                            led.hash()))
        finally:
            if hasattr(lm, "stop_seal_drainer"):
                lm.stop_seal_drainer()
        logs.append(log)
    return logs


def _crossfire_steps(seed: int):
    from stellard_tpu.testkit.workloads import TxFactory, order_book_crossfire

    fac = TxFactory(seed=seed, n_accounts=4)
    rng = random.Random(seed)
    items = [(0, 0, tx) for tx in fac.fund_all()]
    items += order_book_crossfire(fac, rng, start=1, end=7, n=60, n_validators=1)
    steps: dict[int, list] = {}
    for step, _origin, tx in items:
        steps.setdefault(step, []).append(tx.serialize())
    return [steps.get(s, []) for s in range(max(steps) + 1)]


@pytest.mark.parametrize("seed", [1, 2])
def test_order_book_crossfire_equal(seed):
    jax_log, port_log = _both_masters(_crossfire_steps(seed))
    assert port_log == jax_log
    results = {r for _ters, res, _h in port_log for _t, r in res}
    assert int(TER.tesSUCCESS) in results


def _bench_steps(which: str, n: int, chunk: int):
    import bench  # inside the test: its import reads KERNEL_TUNING.json into env

    setup, work = (bench._offer_workload(n) if which == "offer"
                   else bench._regular_key_workload(n, holders=6))
    steps = [[tx.serialize() for tx in phase] for phase in setup]
    steps += [[tx.serialize() for tx in work[i : i + chunk]]
              for i in range(0, len(work), chunk)]
    return steps


@pytest.mark.parametrize("which", ["offer", "regular_key"])
def test_bench_workload_shapes_equal(which):
    """BASELINE configs #2 (OfferCreate/OfferCancel mix with crossing
    ladders) and #3 (SetRegularKey, then AccountSet signed with the
    regular key) at a small size."""
    jax_log, port_log = _both_masters(_bench_steps(which, n=90, chunk=30))
    assert port_log == jax_log
    closed = [r for _ters, res, _h in port_log[-3:] for _t, r in res]
    assert closed and set(closed) == {int(TER.tesSUCCESS)}
