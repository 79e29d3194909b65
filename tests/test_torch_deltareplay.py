"""The port's default close — delta replay, incremental seal, threaded
seal — held against the JAX package's on the seams of
tests/test_deltareplay.py.

Each workload (same-account bursts, a hot shared destination, offers
crossing one book with cancels, tec fee claims and terPRE_SEQ holds
promoted mid-flood, spliced deletions, empty closes) runs through three
chains from the same genesis: the JAX package's LedgerMaster (its
defaults: delta replay and the incremental seal on) with its node's
persist_prep, the port's LedgerMaster with the same defaults on
CudaHasher(device="cpu") (the plain versions of K2/K3, sealing on two
threads, the seal drainer woken every few folded writes), and the
port's serial close (delta_replay = False). Ledger hashes and per-tx
results must be equal in all three, and the splice / fallback /
invalidated counts and the incremental seal's adoption outcome equal
between the two delta closes: the tolerance is zero, since these are
bytes and counts.
"""

from __future__ import annotations

import pytest

import chip_smoke as cs
from stellard_tpu.engine.engine import TxParams as JaxTxParams
from stellard_tpu.node.ledgermaster import CanonicalTXSet as JaxTXSet
from stellard_tpu.node.ledgermaster import LedgerMaster as JaxLedgerMaster
from stellard_tpu.node.node import build_tx_rows as jax_build_tx_rows
from stellard_tpu.protocol.sttx import SerializedTransaction as JaxSTTx
from stellard_tpu_torch.crypto.backend import CudaHasher
from stellard_tpu_torch.engine.engine import TxParams
from stellard_tpu_torch.node.ledgermaster import CanonicalTXSet, LedgerMaster
from stellard_tpu_torch.node.node import build_tx_rows
from stellard_tpu_torch.protocol.formats import TxType
from stellard_tpu_torch.protocol.keys import KeyPair
from stellard_tpu_torch.protocol.sfields import (
    sfAmount,
    sfDestination,
    sfLimitAmount,
    sfOfferSequence,
    sfTakerGets,
    sfTakerPays,
)
from stellard_tpu_torch.protocol.stamount import STAmount
from stellard_tpu_torch.protocol.sttx import SerializedTransaction
from stellard_tpu_torch.protocol.ter import TER

MASTER = KeyPair.from_passphrase("masterpassphrase")
USD = b"USD" + b"\x00" * 17
DRAIN_BATCH = 4  # folded writes a drain: small, so the drainer runs here


def build(tx_type, kp, seq, fields, fee=10) -> bytes:
    tx = SerializedTransaction.build(tx_type, kp.account_id, seq, fee, fields)
    tx.sign(kp)
    return tx.serialize()


def payment(kp, seq, dest, drops=250_000_000) -> bytes:
    return build(TxType.ttPAYMENT, kp, seq,
                 {sfAmount: STAmount.from_drops(drops), sfDestination: dest})


def port_chain(mode: str) -> LedgerMaster:
    """The port's LedgerMaster: "delta" (its defaults, the threaded seal
    with persist rows, a CudaHasher on the CPU) or "serial"."""
    if mode == "serial":
        lm = LedgerMaster()
        lm.delta_replay = False
        return lm
    lm = LedgerMaster(hash_batch=CudaHasher(device="cpu"))
    lm.persist_prep = build_tx_rows
    lm.seal_drain_batch = DRAIN_BATCH
    return lm


def run(phases: list[list[bytes]], mode: str) -> dict:
    """One close per phase of blobs, from genesis, through the JAX
    package ("jax") or the port ("delta", "serial"); terPRE_SEQ
    submissions are held as the node holds them."""
    if mode == "jax":
        lm = JaxLedgerMaster()
        lm.persist_prep = jax_build_tx_rows
        parse, params = JaxSTTx.from_bytes, JaxTxParams.OPEN_LEDGER | JaxTxParams.RETRY
    else:
        lm = port_chain(mode)
        parse, params = SerializedTransaction.from_bytes, TxParams.OPEN_LEDGER | TxParams.RETRY
    lm.start_new_ledger(MASTER.account_id, close_time=1000)
    out = {"hashes": [], "results": [], "deltas": []}
    try:
        for i, phase in enumerate(phases):
            for blob in phase:
                ter, _ok = lm.do_transaction(parse(blob), params)
                if int(ter) == int(TER.terPRE_SEQ):
                    lm.add_held_transaction(parse(blob))
            before = lm.delta_stats.snapshot()
            closed, results = lm.close_and_advance(2000 + i * 30, 30)
            out["hashes"].append(closed.hash())
            out["results"].append(sorted((t.hex(), int(r)) for t, r in results.items()))
            out["deltas"].append(cs.close_delta(lm, before))
    finally:
        lm.stop_seal_drainer()
    out["stats"] = lm.delta_stats.snapshot()
    out["tree"] = lm.tree_json()
    out["hasher"] = lm.hash_batch
    return out


def assert_identical(phases) -> dict:
    """The three chains agree; -> the port's delta run."""
    jax, delta, serial = (run(phases, mode) for mode in ("jax", "delta", "serial"))
    assert delta["hashes"] == jax["hashes"] == serial["hashes"]
    assert delta["results"] == jax["results"] == serial["results"]
    assert delta["deltas"] == jax["deltas"]
    assert delta["stats"] == jax["stats"]
    assert serial["stats"]["closes"] == 0
    for k in cs.ABSORBED:
        assert delta["tree"][k] == 0, k
    hasher = delta["hasher"]
    assert hasher.tree_transfers.readbacks == hasher.tree_calls > 0
    return delta


def test_same_account_burst_splices():
    """One account's sequence chain: the canonical order keeps it, so
    every record splices and the building tree is adopted."""
    dests = [KeyPair.from_passphrase(f"dr-d{i}").account_id for i in range(4)]
    phases = [[payment(MASTER, 1 + i, dests[i % 4]) for i in range(20)],
              [payment(MASTER, 21 + i, dests[i % 4]) for i in range(20)]]
    got = assert_identical(phases)
    assert got["stats"]["spliced"] == 40 and got["stats"]["fallback"] == 0
    assert [d["seal_adopt"] for d in got["deltas"]] == ["adopted", "adopted"]
    assert got["tree"]["drains"] >= 1


def test_hot_account_conflicts_fall_back():
    """Senders paying one hot account: the canonical shuffle reorders
    them against submission order, so records conflict on the shared
    root and fall back."""
    senders = [KeyPair.from_passphrase(f"dr-s{i}") for i in range(6)]
    hot = KeyPair.from_passphrase("dr-hot").account_id
    fund = [payment(MASTER, 1 + i, s.account_id, 2_000_000_000) for i, s in enumerate(senders)]
    work = [payment(s, 1 + rnd, hot, 210_000_000) for rnd in range(3) for s in senders]
    got = assert_identical([fund, work])
    assert got["stats"]["spliced"] + got["stats"]["fallback"] == len(fund) + len(work)
    assert got["stats"]["fallback"] > 0 and got["stats"]["invalidated"] > 0


def test_offers_crossing_one_book_with_cancels():
    """Asks and crossing bids from many accounts on one USD/STR book,
    with cancels: book-directory walks, partial fills, deletions."""
    gateway = KeyPair.from_passphrase("dr-gw")
    traders = [KeyPair.from_passphrase(f"dr-t{i}") for i in range(5)]
    fund = [payment(MASTER, 1 + i, who.account_id, 1_500_000_000)
            for i, who in enumerate([gateway] + traders)]
    trust = [build(TxType.ttTRUST_SET, t, 1,
                   {sfLimitAmount: STAmount.from_iou(USD, gateway.account_id, 10**9, 0)})
             for t in traders]
    seqs = {gateway.account_id: 1, **{t.account_id: 2 for t in traders}}
    work, live = [], []
    for i in range(40):
        if i % 7 == 6 and live:
            kp, oseq = live.pop(0)
            blob = build(TxType.ttOFFER_CANCEL, kp, seqs[kp.account_id],
                         {sfOfferSequence: oseq})
        elif i % 2 == 0:
            kp = gateway
            blob = build(TxType.ttOFFER_CREATE, kp, seqs[kp.account_id], {
                sfTakerPays: STAmount.from_drops((50 + i % 15) * 1_000_000),
                sfTakerGets: STAmount.from_iou(USD, gateway.account_id, 100, 0)})
            live.append((kp, seqs[kp.account_id]))
        else:
            kp = traders[i % len(traders)]
            blob = build(TxType.ttOFFER_CREATE, kp, seqs[kp.account_id], {
                sfTakerPays: STAmount.from_iou(USD, gateway.account_id, 100, 0),
                sfTakerGets: STAmount.from_drops((40 + i % 20) * 1_000_000)})
            live.append((kp, seqs[kp.account_id]))
        seqs[kp.account_id] += 1
        work.append(blob)
    got = assert_identical([fund, trust, work])
    assert got["stats"]["spliced"] + got["stats"]["fallback"] == len(fund) + len(trust) + len(work)


def test_tec_claim_and_held_promotion():
    """A below-reserve payment claims its fee (tec) on the final pass
    only, and a sequence gap is held and promoted after the close."""
    d = [KeyPair.from_passphrase(f"dr-h{i}").account_id for i in range(3)]
    phase1 = [payment(MASTER, 1, d[0]), payment(MASTER, 2, d[1], drops=1_000_000),
              payment(MASTER, 3, d[2]), payment(MASTER, 5, d[0]), payment(MASTER, 4, d[1])]
    got = assert_identical([phase1, []])
    assert got["stats"]["closes"] == 2
    closed = [r for close in got["results"] for _t, r in close]
    assert any(100 <= r < 200 for r in closed), "no tec fee claim"
    assert len(closed) == len(phase1)  # the held payment closed in the second ledger


def test_spliced_deletions_offer_create_then_cancel():
    """One account creates offers and cancels them in the same ledger:
    the cancels' records carry deletions (offer and directory pages)
    that splice."""
    maker = KeyPair.from_passphrase("dr-maker")
    fund = [payment(MASTER, 1, maker.account_id, 2_000_000_000)]
    work = [build(TxType.ttOFFER_CREATE, maker, 1 + i, {
        sfTakerPays: STAmount.from_iou(USD, MASTER.account_id, 10, 0),
        sfTakerGets: STAmount.from_drops(5_000_000)}) for i in range(4)]
    work += [build(TxType.ttOFFER_CANCEL, maker, 5 + i, {sfOfferSequence: 1 + i})
             for i in range(4)]
    got = assert_identical([fund, work])
    assert got["stats"]["fallback"] == 0
    assert got["stats"]["spliced"] == len(fund) + len(work)


def test_empty_and_repeat_closes():
    """Only a close whose open ledger accepted something carries a
    speculation (made on the first accept)."""
    dest = KeyPair.from_passphrase("dr-e").account_id
    got = assert_identical([[], [payment(MASTER, 1, dest)], []])
    assert got["stats"]["closes"] == 1 and got["stats"]["spliced"] == 1
    assert [d["seal_adopt"] for d in got["deltas"]] == ["none", "adopted", "none"]


def test_close_against_a_different_parent_falls_back_whole():
    """Records speculated against parent P never splice into a close
    whose parent is another ledger: the parent gate sends all of them
    to the serial apply, whose result equals a close without records —
    in both packages alike."""
    dests = [KeyPair.from_passphrase(f"dr-p{i}").account_id for i in range(3)]
    blobs = [payment(MASTER, 1 + i, dests[i % 3]) for i in range(9)]
    got = {}
    for name, lm_cls, txset_cls, parse, params in (
        ("jax", JaxLedgerMaster, JaxTXSet, JaxSTTx.from_bytes,
         JaxTxParams.OPEN_LEDGER | JaxTxParams.RETRY),
        ("port", LedgerMaster, CanonicalTXSet, SerializedTransaction.from_bytes,
         TxParams.OPEN_LEDGER | TxParams.RETRY),
    ):
        lm = lm_cls()
        lm.start_new_ledger(MASTER.account_id, close_time=1000)
        for blob in blobs:
            _ter, ok = lm.do_transaction(parse(blob), params)
            assert ok
        spec = lm.current._spec_state
        assert spec is not None and len(spec.records) == 9
        lm2 = lm_cls()
        lm2.start_new_ledger(MASTER.account_id, close_time=1000)
        lm2.close_and_advance(2000, 30)
        parent = lm2.closed_ledger()
        assert parent.hash() != lm.closed_ledger().hash()

        def apply_onto(spec_arg, parent=parent, lm2=lm2, txset_cls=txset_cls, parse=parse):
            target = parent.open_successor()
            txset = txset_cls(parent.hash())
            for blob in blobs:
                txset.insert(parse(blob))
            results = lm2._apply_transactions(target, txset, spec=spec_arg)
            return (target.state_map.get_hash(), target.tx_map.get_hash(),
                    sorted((t.hex(), int(r)) for t, r in results.items()))

        replayed, serial = apply_onto(spec), apply_onto(None)
        assert replayed == serial
        assert lm2.delta_stats["spliced"] == 0 and lm2.delta_stats["fallback"] == 9
        assert lm2.last_close["parent_ok"] is False
        for m in (lm, lm2):
            m.stop_seal_drainer()
        got[name] = replayed
    assert got["port"] == got["jax"]


def test_disabled_knob_records_nothing():
    lm = LedgerMaster()
    lm.delta_replay = False
    lm.start_new_ledger(MASTER.account_id, close_time=1000)
    dest = KeyPair.from_passphrase("dr-off").account_id
    _ter, ok = lm.do_transaction(SerializedTransaction.from_bytes(payment(MASTER, 1, dest)),
                                 TxParams.OPEN_LEDGER | TxParams.RETRY)
    assert ok
    assert getattr(lm.current, "_spec_state", None) is None
    lm.close_and_advance(2000, 30)
    assert lm.delta_stats["closes"] == 0
    assert lm.delta_replay_json()["enabled"] is False


@pytest.mark.parametrize("incremental", [True, False])
def test_incremental_seal_knob_keeps_the_bytes(incremental):
    """With the building tree off (no fold, no drain, no adoption) the
    delta close still splices and gives the same ledgers."""
    dests = [KeyPair.from_passphrase(f"dr-k{i}").account_id for i in range(3)]
    phases = [[payment(MASTER, 1 + i, dests[i % 3]) for i in range(12)]]
    want = run(phases, "jax")
    lm = port_chain("delta")
    lm.incremental_seal = incremental
    lm.start_new_ledger(MASTER.account_id, close_time=1000)
    for blob in phases[0]:
        lm.do_transaction(SerializedTransaction.from_bytes(blob),
                          TxParams.OPEN_LEDGER | TxParams.RETRY)
    # as the node's ledger_accept does: let the drainer take what was
    # folded before the close (on a loaded host its thread may not have
    # run yet); with the building tree off nothing was folded and this
    # returns at once
    lm.kick_seal_drain(wait_s=60)
    closed, _results = lm.close_and_advance(2000, 30)
    lm.stop_seal_drainer()
    assert closed.hash() == want["hashes"][0]
    assert lm.last_close["spliced"] == 12
    assert lm.last_close["seal_adopt"] == ("adopted" if incremental else "off")
    assert (lm.tree_json()["drains"] >= 1) == incremental
