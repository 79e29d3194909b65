"""Hostile workload generators: deterministic transaction streams that
stress the planes PERF.md's friendly payment flood never touches —
hot-account write contention (delta-replay splice rate collapses to
fallbacks), crossing-heavy order books (succ-walk phantom checks), and
queue-gaming fee patterns (admission-plane fairness under adversarial
fee bidding).

A workload is a list of ``(step, origin_nid, tx)`` items; ``TxFactory``
owns the deterministic key material and per-sender sequence chains so a
seed maps to exactly one byte-identical stream.
"""

from __future__ import annotations

import random

from ..protocol.formats import TxType
from ..protocol.keys import KeyPair
from ..protocol.sfields import (
    sfAmount,
    sfDestination,
    sfLimitAmount,
    sfTakerGets,
    sfTakerPays,
)
from ..protocol.stamount import STAmount, currency_from_iso
from ..protocol.sttx import SerializedTransaction

__all__ = [
    "TxFactory",
    "payment_flood",
    "hot_account_flood",
    "order_book_crossfire",
    "fee_gaming",
    "WORKLOADS",
    "build_spec_workload",
]

XRP = 1_000_000
USD = currency_from_iso("USD")


class TxFactory:
    """Deterministic tx material: passphrase-derived keys (stable across
    processes) and per-sender sequence counters."""

    def __init__(self, seed: int = 0, n_accounts: int = 8):
        self.seed = seed
        self.master = KeyPair.from_passphrase("masterpassphrase")
        self.accounts = [
            KeyPair.from_passphrase(f"scn-{seed}-acct-{i}")
            for i in range(n_accounts)
        ]
        self.gateway = KeyPair.from_passphrase(f"scn-{seed}-gateway")
        self._seqs: dict[bytes, int] = {}

    def next_seq(self, kp: KeyPair) -> int:
        s = self._seqs.get(kp.account_id, 1)
        self._seqs[kp.account_id] = s + 1
        return s

    def _build(self, kp: KeyPair, tx_type, fields: dict,
               fee: int = 10) -> SerializedTransaction:
        tx = SerializedTransaction.build(
            tx_type, kp.account_id, self.next_seq(kp), fee, fields
        )
        tx.sign(kp)
        return tx

    def payment(self, src: KeyPair, dst: bytes, drops: int,
                fee: int = 10) -> SerializedTransaction:
        return self._build(
            src, TxType.ttPAYMENT,
            {sfAmount: STAmount.from_drops(drops), sfDestination: dst},
            fee=fee,
        )

    def payment_at_seq(self, src: KeyPair, seq: int, dst: bytes,
                       drops: int, fee: int) -> SerializedTransaction:
        """Explicit-sequence payment (replace-by-fee gaming needs to
        re-issue one sequence at a higher fee)."""
        tx = SerializedTransaction.build(
            TxType.ttPAYMENT, src.account_id, seq, fee,
            {sfAmount: STAmount.from_drops(drops), sfDestination: dst},
        )
        tx.sign(src)
        return tx

    def trust(self, src: KeyPair, issuer: KeyPair,
              limit: int) -> SerializedTransaction:
        return self._build(
            src, TxType.ttTRUST_SET,
            {sfLimitAmount: STAmount.from_iou(
                USD, issuer.account_id, limit, 0
            )},
        )

    def iou_payment(self, src: KeyPair, dst: bytes, value: int,
                    exponent: int = 0) -> SerializedTransaction:
        return self._build(
            src, TxType.ttPAYMENT,
            {
                sfAmount: STAmount.from_iou(
                    USD, self.gateway.account_id, value, exponent
                ),
                sfDestination: dst,
            },
        )

    def offer(self, src: KeyPair, taker_pays: STAmount,
              taker_gets: STAmount) -> SerializedTransaction:
        return self._build(
            src, TxType.ttOFFER_CREATE,
            {sfTakerPays: taker_pays, sfTakerGets: taker_gets},
        )

    def fund_all(self, drops: int = 10_000 * XRP) -> list:
        """Master funds every scenario account (+ the gateway)."""
        out = [
            self.payment(self.master, kp.account_id, drops)
            for kp in self.accounts
        ]
        out.append(self.payment(self.master, self.gateway.account_id, drops))
        return out


def _spread(rng: random.Random, txs, start: int, end: int,
            n_validators: int, origin=None) -> list:
    """Assign steps (uniform in [start, end)) and origins to a tx list,
    keeping per-sender order (sequence chains must submit in order) and
    a STABLE per-sender origin (a chain scattered across validators
    scrambles into terPRE_SEQ holds before the relay catches up — a
    real client talks to one node)."""
    items = []
    step_of_sender: dict[bytes, int] = {}
    for tx in txs:
        lo = max(start, step_of_sender.get(tx.account, start))
        at = rng.randrange(lo, max(lo + 1, end))
        step_of_sender[tx.account] = at  # same step ok: FIFO within step
        nid = origin if origin is not None else (
            int.from_bytes(tx.account[:4], "big") % n_validators
        )
        items.append((at, nid, tx))
    items.sort(key=lambda it: it[0])
    return items


def payment_flood(fac: TxFactory, rng: random.Random, *, start: int,
                  end: int, n: int, n_validators: int) -> list:
    """Friendly-ish baseline flood: independent senders, spread dests."""
    txs = []
    for i in range(n):
        src = fac.accounts[i % len(fac.accounts)]
        dst = fac.accounts[(i + 1) % len(fac.accounts)].account_id
        txs.append(fac.payment(src, dst, (1 + i % 7) * XRP))
    return _spread(rng, txs, start, end, n_validators)


def hot_account_flood(fac: TxFactory, rng: random.Random, *, start: int,
                      end: int, n: int, n_validators: int) -> list:
    """Hot-account contention: every tx touches ONE destination account
    root (and half share one sender), so speculative records chain on a
    single entry — the adversarial shape for delta-replay splicing."""
    hot_dst = fac.accounts[0].account_id
    txs = []
    for i in range(n):
        src = fac.accounts[0] if i % 2 else fac.accounts[1 + i % (
            len(fac.accounts) - 1
        )]
        if src.account_id == hot_dst:
            dst = fac.accounts[1].account_id
        else:
            dst = hot_dst
        txs.append(fac.payment(src, dst, (1 + i % 3) * XRP))
    return _spread(rng, txs, start, end, n_validators)


def order_book_crossfire(fac: TxFactory, rng: random.Random, *,
                         start: int, end: int, n: int,
                         n_validators: int) -> list:
    """Crossing-heavy one-book mix: trust lines + issuance up front,
    then alternating buy/sell offers priced to cross — every apply walks
    the book directories (the succ-cursor phantom-protection seam)."""
    a, b = fac.accounts[0], fac.accounts[1]
    setup = [
        fac.trust(a, fac.gateway, 1_000_000),
        fac.trust(b, fac.gateway, 1_000_000),
    ]
    issue = [
        fac.iou_payment(fac.gateway, a.account_id, 100_000),
        fac.iou_payment(fac.gateway, b.account_id, 100_000),
    ]
    offers = []
    for i in range(n):
        # a sells USD for XRP; b crosses it buying USD with XRP — price
        # wobbles so some offers rest, some cross fully, some partially
        usd = STAmount.from_iou(USD, fac.gateway.account_id, 10 + i % 5, 0)
        xrp = STAmount.from_drops((5 + i % 7) * XRP)
        if i % 2 == 0:
            offers.append(fac.offer(a, xrp, usd))
        else:
            offers.append(fac.offer(b, usd, xrp))
    mid = start + max(2, (end - start) // 6)
    items = _spread(rng, setup, start, start + 1, n_validators, origin=0)
    items += _spread(rng, issue, start + 1, mid, n_validators, origin=0)
    items += _spread(rng, offers, mid, end, n_validators)
    items.sort(key=lambda it: it[0])
    return items


def build_spec_workload(spec: dict):
    """Workloads as DATA (scenario serialization / the fuzz generator):
    ``{"kind": <WORKLOADS name>, "n": N[, "start": S, "end_margin": M,
    ...extra kwargs]}`` becomes the standard funded-flood builder —
    master funds every scenario account at step 0, then the named
    stream runs over ``[start, scn.steps - end_margin)``. The returned
    builder is a pure function of (seed, scenario), so a serialized
    scenario replays byte-identically."""
    spec = dict(spec)
    fn = WORKLOADS[spec.pop("kind")]
    n = int(spec.pop("n"))
    start = int(spec.pop("start", 6))
    end_margin = int(spec.pop("end_margin", 6))

    def build(fac: TxFactory, rng: random.Random, scn) -> list:
        items = [(0, 0, tx) for tx in fac.fund_all()]
        items += fn(
            fac, rng, start=start,
            end=max(start + 1, scn.steps - end_margin), n=n,
            n_validators=scn.n_validators, **spec,
        )
        items.sort(key=lambda it: it[0])
        return items

    return build


def fee_gaming(fac: TxFactory, rng: random.Random, *, start: int,
               end: int, n: int, n_validators: int,
               origin: int = 0) -> list:
    """Queue-gaming fee patterns against the admission plane on ONE
    node: a base-fee flood past the soft cap, high-fee bursts that must
    jump the line, and replace-by-fee re-bids of queued sequences. The
    runner checks fee-ordered drain and no-starvation."""
    txs = []
    senders = fac.accounts[: max(4, len(fac.accounts) // 2)]
    for i in range(n):
        src = senders[i % len(senders)]
        dst = fac.accounts[(i + 3) % len(fac.accounts)].account_id
        burst = (i // len(senders)) % 4 == 3
        fee = 10 if not burst else 10 * (20 + i % 10)
        seq = fac.next_seq(src)
        txs.append(fac.payment_at_seq(src, seq, dst, XRP, fee))
        if burst and i % 5 == 0:
            # replace-by-fee: re-issue the SAME sequence at +50%
            txs.append(fac.payment_at_seq(src, seq, dst, XRP,
                                          int(fee * 3 // 2)))
    return _spread(rng, txs, start, end, n_validators, origin=origin)


# named-workload registry: the serializable half of every scenario's
# workload axis (build_spec_workload interprets {"kind": <name>, ...})
WORKLOADS = {
    "payment_flood": payment_flood,
    "hot_account_flood": hot_account_flood,
    "order_book_crossfire": order_book_crossfire,
    "fee_gaming": fee_gaming,
}
