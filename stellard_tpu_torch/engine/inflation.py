"""Inflation transactor (Stellar-specific).

Reference: src/ripple_app/transactors/InflationTransactor.cpp — weekly
dole: tally sfInflationDest votes weighted by voter balance (only voters
with > 1e9 drops, per the reference's SQL filter), pick up to 50 winners
above 1.5% of the vote (or top 50 if nobody crosses), and distribute
totCoins * 190721/1e9 (≈1% APR weekly) + the accumulated fee pool,
proportionally to votes. Constants at InflationTransactor.cpp:32-38.

The reference tallies via a SQL query over its Accounts mirror table; here
the tally walks the state SHAMap directly (one pass, no SQL dependency).
"""

from __future__ import annotations

from collections import defaultdict

from ..protocol.formats import TxType
from ..protocol.sfields import sfBalance, sfInflateSeq, sfInflationDest
from ..protocol.stobject import STObject
from ..protocol.ter import TER
from ..state import indexes
from .transactor import Transactor, register_transactor

INFLATION_FREQUENCY = 60 * 60 * 24 * 7  # seconds
INFLATION_RATE_TRILLIONTHS = 190_721_000
TRILLION = 1_000_000_000_000
INFLATION_WIN_MIN_TRILLIONTHS = 15_000_000_000  # 1.5%
INFLATION_NUM_WINNERS = 50
INFLATION_START_TIME = 1403900503 - 946684800  # seconds since 1/1/2000
MIN_VOTER_BALANCE = 1_000_000_000  # reference SQL: balance > 1000000000


@register_transactor(TxType.ttINFLATION)
class InflationTransactor(Transactor):
    def check_sig(self) -> TER:
        # anyone may submit inflation; no account authority needed
        # (reference: InflationTransactor::checkSig -> tesSUCCESS)
        return TER.tesSUCCESS

    def pay_fee(self) -> TER:
        # inflation transactions must carry no fee (reference: :63-72)
        if self.tx.fee.is_zero():
            return TER.tesSUCCESS
        return TER.temBAD_FEE

    def precheck_against_ledger(self) -> TER:
        """reference: :74-96 — right sequence, and it must be time."""
        seq = self.tx.obj[sfInflateSeq]
        if seq != self.engine.ledger.inflation_seq:
            return TER.telNOT_TIME
        close_time = self.engine.ledger.parent_close_time
        next_time = INFLATION_START_TIME + seq * INFLATION_FREQUENCY
        if close_time < next_time:
            return TER.telNOT_TIME
        return TER.tesSUCCESS

    def do_apply(self) -> TER:
        ledger = self.engine.ledger

        # 1. tally votes (balance-weighted, big accounts only)
        votes: dict[bytes, int] = defaultdict(int)
        for item in ledger.state_map.items():
            sle = STObject.from_bytes(item.data)
            dest = sle.get(sfInflationDest)
            if dest is None:
                continue
            bal = sle.get(sfBalance)
            if bal is None or not bal.is_native or bal.mantissa <= MIN_VOTER_BALANCE:
                continue
            votes[dest] += bal.mantissa

        if not votes:
            self.header_changes = {"inflation_seq_delta": 1, "fee_pool": 0}
            return TER.tesSUCCESS

        ranked = sorted(votes.items(), key=lambda kv: kv[1], reverse=True)
        min_win = ledger.tot_coins * INFLATION_WIN_MIN_TRILLIONTHS // TRILLION
        if ranked[0][1] <= min_win:
            min_win = 0  # nobody crossed: take the top 50 (reference :148-151)
        winners = [
            (dest, v)
            for dest, v in ranked[:INFLATION_NUM_WINNERS]
            if v > min_win or min_win == 0
        ][:INFLATION_NUM_WINNERS]
        total_voted = sum(v for _, v in winners)

        # 2. coinsToDole = totCoins * rate + feePool (reference :173-181)
        to_dole = (
            ledger.tot_coins * INFLATION_RATE_TRILLIONTHS // TRILLION
            + ledger.fee_pool
        )

        # 3. distribute proportionally (reference :185-215)
        minted = 0
        from ..protocol.stamount import STAmount

        for dest, v in winners:
            doled = to_dole * v // total_voted
            idx = indexes.account_root_index(dest)
            acct = self.les.peek(idx)
            if acct is None:
                continue  # vanished dest: skip (reference logs an error)
            acct[sfBalance] = acct[sfBalance] + STAmount.from_drops(doled)
            self.les.modify(idx)
            minted += doled

        # header mutations are deferred to the engine until after the
        # invariant gate passes (header_changes convention) so a
        # tefINTERNAL abort can't leave tot_coins/inflation_seq advanced
        # with no matching balance credits
        self.header_changes = {
            "tot_coins_delta": minted,
            "inflation_seq_delta": 1,
            "fee_pool": 0,
        }
        self.minted_coins = minted  # engine invariant hook
        return TER.tesSUCCESS
