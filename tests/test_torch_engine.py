"""The port's transactor engine (engine/, state/entryset.py) against the
JAX package's, one transaction at a time.

Seeded Payment streams (funding from the root, payments between existing
accounts, account creation above and below the reserve, spends below the
reserve, future sequences that answer terPRE_SEQ, past sequences, and the
same sender twice in one open window) are built by the JAX package's
testkit, and each blob is applied by both packages' TransactionEngine
to their own genesis chain. Per transaction the TER, whether it applied,
and the metadata bytes must be equal; after every stream the state and
tx tree hashes must be equal. Tolerance: zero. TrustSet, OfferCreate and
a payment through the path engine are held the same way here; every
other flow of every transactor is in test_torch_transactors.py.
"""

from __future__ import annotations

import random

import pytest

from stellard_tpu.engine import TransactionEngine as JaxEngine
from stellard_tpu.protocol.stamount import STAmount as JaxSTAmount
from stellard_tpu.protocol.sttx import SerializedTransaction as JaxSTTx
from stellard_tpu.state.ledger import Ledger as JaxLedger
from stellard_tpu.testkit.workloads import TxFactory
from stellard_tpu_torch.engine import TransactionEngine, TxParams
from stellard_tpu_torch.protocol.sttx import SerializedTransaction
from stellard_tpu_torch.protocol.ter import TER
from stellard_tpu_torch.state.ledger import Ledger

STR = 1_000_000  # drops
CLOSE, RETRY, OPEN = 0, int(TxParams.RETRY), int(TxParams.OPEN_LEDGER | TxParams.RETRY)


def _stream(kind: str, seed: int):
    """(factory, [(blob, mode), ...]) for one seeded stream."""
    fac = TxFactory(seed=seed, n_accounts=6)
    rng = random.Random(seed)
    acc = fac.accounts
    out = [(fac.payment(fac.master, a.account_id, 1000 * STR).serialize(), CLOSE)
           for a in acc[:4]]
    if kind == "existing":
        for _ in range(40):
            src, dst = rng.sample(acc[:4], 2)
            out.append((fac.payment(src, dst.account_id, rng.randrange(1, 50 * STR)).serialize(),
                        rng.choice([CLOSE, RETRY])))
    elif kind == "create":
        for a in acc[4:]:
            # below the 200 STR reserve: tecNO_DST_INSUF_STR, then at it
            out.append((fac.payment(acc[0], a.account_id, 199 * STR).serialize(), CLOSE))
            out.append((fac.payment(acc[1], a.account_id, 200 * STR).serialize(), RETRY))
            out.append((fac.payment(acc[2], a.account_id, 250 * STR).serialize(), CLOSE))
        out.append((fac.payment(acc[4], acc[0].account_id, 5 * STR).serialize(), CLOSE))
    elif kind == "reserve":
        # spend down to and past the reserve: tecUNFUNDED_PAYMENT claims
        # only the fee in close mode, nothing under RETRY
        for amount, mode in [(700 * STR, CLOSE), (150 * STR, CLOSE), (100 * STR, RETRY),
                             (100 * STR, CLOSE), (40 * STR, CLOSE), (149 * STR, CLOSE)]:
            out.append((fac.payment(acc[0], acc[1].account_id, amount).serialize(), mode))
    elif kind == "sequence":
        src = acc[0]
        seq = fac.next_seq(src)  # the next valid sequence
        for s, mode in [(seq + 2, CLOSE), (seq + 1, RETRY), (seq, CLOSE),
                        (seq, CLOSE), (seq - 1, CLOSE), (seq + 1, CLOSE),
                        (seq + 5, OPEN), (1, RETRY)]:
            out.append((fac.payment_at_seq(src, s, acc[1].account_id, STR, 10).serialize(),
                        mode))
        # below the base fee in an open ledger: telINSUF_FEE_P
        out.append((fac.payment(acc[1], acc[0].account_id, STR, fee=0).serialize(), OPEN))
    elif kind == "open_window":
        # one sender twice (and out of order) in one open window: the
        # second is predicted from the open ledger's sequences
        for src in acc[:3]:
            seq = fac.next_seq(src)
            for s in (seq, seq + 1, seq + 3, seq + 2):
                out.append((fac.payment_at_seq(src, s, acc[3].account_id, 2 * STR, 10)
                            .serialize(), OPEN))
    return fac, out


def _apply(ledger, engine_cls, parse, blob: bytes, mode: int):
    engine = engine_cls(ledger)
    tx = parse(blob)
    ter, applied = engine.apply_transaction(tx, mode)
    got = ledger.get_transaction(tx.txid())
    return int(ter), applied, got


@pytest.mark.parametrize("kind", ["existing", "create", "reserve", "sequence", "open_window"])
@pytest.mark.parametrize("seed", [1, 2])
def test_stream_equal_to_jax(kind, seed):
    fac, stream = _stream(kind, seed)
    root = fac.master.account_id
    jl = JaxLedger.genesis(root, close_time=530_000_000)
    tl = Ledger.genesis(root, close_time=530_000_000)
    jl.close(530_000_000, 30)
    tl.close(530_000_000, 30)
    jl, tl = jl.open_successor(), tl.open_successor()
    seen = set()
    for blob, mode in stream:
        # the open window is an open ledger of its own, as the node keeps it
        want = _apply(jl, JaxEngine, JaxSTTx.from_bytes, blob, mode)
        got = _apply(tl, TransactionEngine, SerializedTransaction.from_bytes, blob, mode)
        assert got == want, (kind, mode, got[:2], want[:2])
        seen.add(got[0])
    assert tl.state_map.get_hash() == jl.state_map.get_hash()
    assert tl.tx_map.get_hash() == jl.tx_map.get_hash()
    assert tl.open_tx_seqs == jl.open_tx_seqs
    tl.close(530_000_030, 30)
    jl.close(530_000_030, 30)
    assert tl.hash() == jl.hash()
    assert (tl.tot_coins, tl.fee_pool) == (jl.tot_coins, jl.fee_pool)
    expected = {
        "existing": {TER.tesSUCCESS},
        "create": {TER.tesSUCCESS, TER.tecNO_DST_INSUF_STR},
        "reserve": {TER.tesSUCCESS, TER.tecUNFUNDED_PAYMENT},
        "sequence": {TER.tesSUCCESS, TER.terPRE_SEQ, TER.tefPAST_SEQ, TER.tefALREADY,
                     TER.telINSUF_FEE_P},
        "open_window": {TER.tesSUCCESS, TER.terPRE_SEQ},
    }[kind]
    assert {int(t) for t in expected} <= seen


def test_open_window_second_payment_is_predicted():
    """In one open ledger a sender's second payment (next sequence) is
    accepted, not terPRE_SEQ, in both packages."""
    fac, stream = _stream("open_window", 3)
    jl = JaxLedger.genesis(fac.master.account_id).open_successor()
    tl = Ledger.genesis(fac.master.account_id).open_successor()
    results = []
    for blob, mode in stream:
        for led, eng, parse in ((jl, JaxEngine, JaxSTTx.from_bytes),
                                (tl, TransactionEngine, SerializedTransaction.from_bytes)):
            results.append(_apply(led, eng, parse, blob, mode)[:2])
    assert results[0::2] == results[1::2]
    # funding (close mode), then per sender: seq ok, seq+1 ok, seq+3 held, seq+2 ok
    assert [r[0] for r in results[0::2][4:8]] == [0, 0, int(TER.terPRE_SEQ), 0]


def _book_setup(fac: TxFactory):
    """Funding, trust lines and issuance that a TrustSet, an OfferCreate
    and a path payment then act on."""
    a, b, gw = fac.accounts[0], fac.accounts[1], fac.gateway
    usd = lambda v: JaxSTAmount.from_iou(_USD, gw.account_id, v, 0)  # noqa: E731
    txs = [fac.payment(fac.master, k.account_id, 1000 * STR) for k in (a, b, gw)]
    txs += [fac.trust(a, gw, 1000), fac.trust(b, gw, 1000)]
    txs += [fac.iou_payment(gw, a.account_id, 300), fac.iou_payment(gw, b.account_id, 200)]
    # b sells 50 USD for 100 STR (rests in the STR -> USD book)
    txs.append(fac.offer(b, JaxSTAmount.from_drops(100 * STR), usd(50)))
    return txs, usd


_USD = b"\x00" * 12 + b"USD" + b"\x00" * 5


def _formerly_unported(fac: TxFactory, name: str):
    """The blob of each transaction type the port once refused."""
    a, b, gw = fac.accounts[0], fac.accounts[1], fac.gateway
    usd = lambda v: JaxSTAmount.from_iou(_USD, gw.account_id, v, 0)  # noqa: E731
    if name == "TrustSet":
        return fac.trust(b, gw, 500)  # raise an existing line's limit
    if name == "OfferCreate":
        # a buys STR with USD: crosses nothing, rests in the USD -> STR book
        return fac.offer(a, usd(20), JaxSTAmount.from_drops(30 * STR))
    # a third-party issuer on the default path: the flow engine's delivery
    return fac.iou_payment(a, b.account_id, 40)


def _run_both(fac: TxFactory, stream):
    root = fac.master.account_id
    jl = JaxLedger.genesis(root).open_successor()
    tl = Ledger.genesis(root).open_successor()
    out = []
    for blob, mode in stream:
        want = _apply(jl, JaxEngine, JaxSTTx.from_bytes, blob, mode)
        got = _apply(tl, TransactionEngine, SerializedTransaction.from_bytes, blob, mode)
        assert got == want, (mode, got[:2], want[:2])
        out.append(got[0])
    assert tl.state_map.get_hash() == jl.state_map.get_hash()
    assert tl.tx_map.get_hash() == jl.tx_map.get_hash()
    return out


@pytest.mark.parametrize("name", ["TrustSet", "OfferCreate"])
@pytest.mark.parametrize("mode", [CLOSE, OPEN])
def test_formerly_unported_type_equal_to_jax(name, mode):
    """TrustSet and OfferCreate, on the blobs that once raised
    NotImplementedError: TER, metadata bytes and state hash equal to the
    JAX engine's, in closing and in open-ledger mode."""
    fac = TxFactory(seed=4, n_accounts=2)
    setup, _usd = _book_setup(fac)
    tx = _formerly_unported(fac, name)
    ters = _run_both(fac, [(t.serialize(), CLOSE) for t in setup] + [(tx.serialize(), mode)])
    assert ters == [int(TER.tesSUCCESS)] * len(ters)


def test_path_payment_equal_to_jax():
    """A payment that needs the path engine (an IOU from a third-party
    issuer on the default path), then one past the sender's holdings:
    TERs, metadata bytes and state hash equal to the JAX engine's."""
    fac = TxFactory(seed=5, n_accounts=2)
    setup, _usd = _book_setup(fac)
    pay = _formerly_unported(fac, "Payment")
    too_much = fac.iou_payment(fac.accounts[0], fac.accounts[1].account_id, 5000)
    ters = _run_both(fac, [(t.serialize(), CLOSE) for t in setup]
                     + [(pay.serialize(), CLOSE), (too_much.serialize(), CLOSE)])
    assert ters[-2] == int(TER.tesSUCCESS) and ters[-1] != int(TER.tesSUCCESS)


def test_iou_default_path_equal_on_a_carried_state():
    """IOU payments on the default path (the issuer issuing to a holder,
    a holder redeeming to the issuer, a delivery past the trust limit)
    through both engines, from one state with trust lines that the JAX
    package built and interop.ledger_from_items carried into the port."""
    from stellard_tpu.engine import TxParams as JaxTxParams
    from stellard_tpu.node.ledgermaster import LedgerMaster as JaxLedgerMaster
    from stellard_tpu.state.ledger import parse_header
    from stellard_tpu_torch.interop import ledger_from_items

    fac = TxFactory(seed=6, n_accounts=2)
    a0, a1, gw = fac.accounts[0], fac.accounts[1], fac.gateway
    lm = JaxLedgerMaster()
    lm.start_new_ledger(fac.master.account_id, close_time=530_000_000)
    mode = JaxTxParams.OPEN_LEDGER | JaxTxParams.RETRY
    try:
        for tx in fac.fund_all(1000 * STR):
            assert lm.do_transaction(tx, mode)[0] == 0
        lm.close_and_advance(530_000_030, 30)
        for kp in (a0, a1):
            assert lm.do_transaction(fac.trust(kp, gw, 1000), mode)[0] == 0
        lm.close_and_advance(530_000_060, 30)
    finally:
        lm.stop_seal_drainer()
    j = lm.closed_ledger()
    leaves = lambda m: [(lf.item.tag, lf.item.data, int(lf.type)) for lf in m.leaves()]  # noqa: E731
    t = ledger_from_items(parse_header(j.header_bytes()), leaves(j.state_map), leaves(j.tx_map))
    assert t.hash() == j.hash()
    jl, tl = j.open_successor(), t.open_successor()
    stream = [
        (fac.iou_payment(gw, a0.account_id, 100), CLOSE),   # issue
        (fac.iou_payment(a0, gw.account_id, 20), CLOSE),    # redeem
        (fac.iou_payment(gw, a1.account_id, 5000), CLOSE),  # past the limit
        (fac.iou_payment(a1, gw.account_id, 1), RETRY),     # holds nothing
        (fac.iou_payment(gw, a1.account_id, 7, exponent=-1), CLOSE),
    ]
    seen = []
    for tx, mode in stream:
        blob = tx.serialize()
        want = _apply(jl, JaxEngine, JaxSTTx.from_bytes, blob, mode)
        got = _apply(tl, TransactionEngine, SerializedTransaction.from_bytes, blob, mode)
        assert got == want
        seen.append(got[0])
    assert int(TER.tesSUCCESS) in seen and len(set(seen)) > 1
    assert tl.state_map.get_hash() == jl.state_map.get_hash()
