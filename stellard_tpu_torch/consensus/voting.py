"""On-ledger voting: AmendmentTable + FeeVote.

Role parity with the reference's flag-ledger voting machinery
(src/ripple_app/misc/AmendmentTableImpl.cpp:421-470
doValidation/doVoting, misc/FeeVoteImpl.cpp, wired into consensus at
LedgerConsensus.cpp:1033-1038 and takeInitialPosition):

- every validation we sign carries our amendment votes (the supported,
  not-yet-enabled, not-vetoed set) and our fee targets when they differ
  from the closed ledger's schedule;
- when the last closed ledger is a FLAG ledger (seq % flag_interval == 0),
  the next round's initial position gets pseudo-transactions injected:
  ttAMENDMENT for each amendment that has held >= majority_fraction of
  trusted validations for longer than majority_time, and ttFEE when the
  plurality of fee votes disagrees with the current schedule.

The voting inputs are the validations for the flag ledger's PARENT (the
reference reads getValidations(lastClosedLedger->getParentHash())) —
those are the validations every honest node has already seen, so
positions built from them agree byzantine-free.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Iterable, Optional

from ..protocol.formats import TxType
from ..protocol.sfields import (
    sfSigningPubKey,
    sfAmendment,
    sfBaseFee,
    sfReferenceFeeUnits,
    sfReserveBase,
    sfReserveIncrement,
)
from ..protocol.stamount import ACCOUNT_ZERO
from ..protocol.sttx import SerializedTransaction
from .validation import STValidation

__all__ = ["AmendmentTable", "FeeVote", "VotingBox", "FLAG_INTERVAL"]

FLAG_INTERVAL = 256
MAJORITY_FRACTION = 204  # of 256 trusted validators (~80%, reference value)
DEFAULT_MAJORITY_TIME = 14 * 24 * 3600  # two weeks (reference weeks(2))


def make_amendment_tx(amendment: bytes) -> SerializedTransaction:
    """ttAMENDMENT pseudo-tx (account zero, empty signing key, no
    fee/seq/signature — reference Change.cpp pseudo-tx shape)."""
    return SerializedTransaction.build(
        TxType.ttAMENDMENT,
        ACCOUNT_ZERO,
        0,
        0,
        {sfAmendment: amendment, sfSigningPubKey: b""},
    )


def make_fee_tx(
    base_fee: int, reference_fee_units: int, reserve_base: int, reserve_increment: int
) -> SerializedTransaction:
    return SerializedTransaction.build(
        TxType.ttFEE,
        ACCOUNT_ZERO,
        0,
        0,
        {
            sfBaseFee: base_fee,
            sfReferenceFeeUnits: reference_fee_units,
            sfReserveBase: reserve_base,
            sfReserveIncrement: reserve_increment,
            sfSigningPubKey: b"",
        },
    )


class AmendmentTable:
    """Supported/enabled/vetoed amendment registry + majority tracking."""

    def __init__(
        self,
        majority_time: int = DEFAULT_MAJORITY_TIME,
        majority_fraction: int = MAJORITY_FRACTION,
    ):
        self.majority_time = majority_time
        self.majority_fraction = majority_fraction
        self._lock = threading.Lock()
        self.names: dict[bytes, str] = {}
        self.supported: set[bytes] = set()
        self.vetoed: set[bytes] = set()
        self.enabled: set[bytes] = set()
        # amendment -> (first_majority_close_time, last_majority_close_time)
        self.majorities: dict[bytes, tuple[int, int]] = {}

    def add_known(self, amendment: bytes, name: str = "", supported: bool = True,
                  vetoed: bool = False) -> None:
        with self._lock:
            self.names[amendment] = name or amendment.hex()[:16]
            if supported:
                self.supported.add(amendment)
            if vetoed:
                self.vetoed.add(amendment)

    def veto(self, amendment: bytes) -> None:
        with self._lock:
            self.vetoed.add(amendment)

    def set_enabled(self, amendments: Iterable[bytes]) -> None:
        """Sync from the closed ledger's ltAMENDMENTS entry."""
        with self._lock:
            self.enabled = set(amendments)

    def desired(self) -> list[bytes]:
        """What we vote for: supported, not enabled, not vetoed (sorted —
        the reference sorts the STVector256 so validations are canonical)."""
        with self._lock:
            return sorted(self.supported - self.enabled - self.vetoed)

    # -- consensus hooks --------------------------------------------------

    def do_validation(self) -> Optional[list[bytes]]:
        """Amendment votes for a validation we are about to sign."""
        des = self.desired()
        return des or None

    def do_voting(
        self, flag_close_time: int, parent_validations: list[STValidation]
    ) -> list[SerializedTransaction]:
        """Called when the LCL is a flag ledger; returns ttAMENDMENT
        pseudo-txs for the next initial position."""
        trusted = [v for v in parent_validations if v.trusted]
        n_voters = len(trusted)
        votes: Counter[bytes] = Counter()
        for val in trusted:
            for amendment in val.amendments or []:
                votes[amendment] += 1
        threshold = max(1, (n_voters * self.majority_fraction + 255) // 256)
        out: list[SerializedTransaction] = []
        with self._lock:
            for amendment in set(votes) | set(self.majorities):
                has_majority = n_voters > 0 and votes.get(amendment, 0) >= threshold
                if not has_majority:
                    self.majorities.pop(amendment, None)
                    continue
                first, _last = self.majorities.get(
                    amendment, (flag_close_time, flag_close_time)
                )
                self.majorities[amendment] = (first, flag_close_time)
                if (
                    flag_close_time - first >= self.majority_time
                    and amendment not in self.enabled
                    and amendment not in self.vetoed
                ):
                    out.append(make_amendment_tx(amendment))
        out.sort(key=lambda tx: tx.txid())
        return out

    def get_json(self) -> dict:
        with self._lock:
            out = {}
            for amendment, name in self.names.items():
                out[amendment.hex().upper()] = {
                    "name": name,
                    "supported": amendment in self.supported,
                    "enabled": amendment in self.enabled,
                    "vetoed": amendment in self.vetoed,
                    "majority": self.majorities.get(amendment),
                }
            return out


class FeeVote:
    """Fee/reserve voting (reference FeeVoteImpl): vote our targets in
    validations; on flag ledgers move the schedule to the plurality."""

    def __init__(
        self,
        target_base_fee: int = 10,
        target_reference_fee_units: int = 10,
        target_reserve_base: int = 200_000_000,
        target_reserve_increment: int = 50_000_000,
    ):
        self.base_fee = target_base_fee
        self.reference_fee_units = target_reference_fee_units
        self.reserve_base = target_reserve_base
        self.reserve_increment = target_reserve_increment

    def do_validation(self, ledger) -> dict:
        """Fee fields to embed in our validation, when our targets differ
        from the schedule of the ledger we validated."""
        fields = {}
        if ledger.base_fee != self.base_fee:
            fields["base_fee"] = self.base_fee
        if ledger.reserve_base != self.reserve_base:
            fields["reserve_base"] = self.reserve_base
        if ledger.reserve_increment != self.reserve_increment:
            fields["reserve_increment"] = self.reserve_increment
        return fields

    def do_voting(
        self, flag_ledger, parent_validations: list[STValidation]
    ) -> list[SerializedTransaction]:
        """Plurality vote per knob (reference VotableInteger: the value
        with the most votes wins; the current value is everyone's default
        vote)."""
        trusted = [v for v in parent_validations if v.trusted]

        def plurality(current: int, votes: list[int]) -> int:
            counts: Counter[int] = Counter()
            for vote in votes:
                counts[vote] += 1
            # unvoiced validators implicitly support the current value
            counts[current] += len(trusted) - len(votes)
            if not counts:
                return current
            # highest count wins; ties prefer the incumbent, then the
            # smallest value — fully deterministic so every node injects
            # the identical ttFEE pseudo-tx regardless of arrival order
            best = max(
                counts.items(), key=lambda kv: (kv[1], kv[0] == current, -kv[0])
            )
            return best[0]

        base_fee = plurality(
            flag_ledger.base_fee,
            [v.base_fee for v in trusted if v.base_fee is not None],
        )
        reserve_base = plurality(
            flag_ledger.reserve_base,
            [v.reserve_base for v in trusted if v.reserve_base is not None],
        )
        reserve_increment = plurality(
            flag_ledger.reserve_increment,
            [v.reserve_increment for v in trusted if v.reserve_increment is not None],
        )
        if (
            base_fee == flag_ledger.base_fee
            and reserve_base == flag_ledger.reserve_base
            and reserve_increment == flag_ledger.reserve_increment
        ):
            return []
        return [
            make_fee_tx(
                base_fee,
                flag_ledger.reference_fee_units,
                reserve_base,
                reserve_increment,
            )
        ]


class VotingBox:
    """The consensus-facing bundle: validation decoration + flag-ledger
    pseudo-tx injection (what LedgerConsensus.cpp:1033-1038 and
    takeInitialPosition call into)."""

    def __init__(
        self,
        amendments: Optional[AmendmentTable] = None,
        fees: Optional[FeeVote] = None,
        flag_interval: int = FLAG_INTERVAL,
    ):
        self.amendments = amendments
        self.fees = fees
        self.flag_interval = flag_interval

    def is_flag_ledger(self, seq: int) -> bool:
        return seq > 0 and seq % self.flag_interval == 0

    def validation_fields(self, ledger) -> dict:
        """Extra STValidation.build kwargs for the ledger we just built."""
        fields: dict = {}
        if self.fees is not None:
            fields.update(self.fees.do_validation(ledger))
        if self.amendments is not None:
            votes = self.amendments.do_validation()
            if votes:
                fields["amendments"] = votes
        return fields

    def position_injections(
        self, prev_ledger, parent_validations: list[STValidation]
    ) -> list[SerializedTransaction]:
        """Pseudo-txs for the initial position when prev is a flag ledger."""
        if not self.is_flag_ledger(prev_ledger.seq):
            return []
        out: list[SerializedTransaction] = []
        if self.amendments is not None:
            out.extend(
                self.amendments.do_voting(
                    prev_ledger.close_time, parent_validations
                )
            )
        if self.fees is not None:
            out.extend(self.fees.do_voting(prev_ledger, parent_validations))
        return out

    def on_ledger_closed(self, ledger) -> None:
        """Sync enabled amendments from the new LCL's state."""
        if self.amendments is None:
            return
        from ..state import indexes
        from ..protocol.sfields import sfAmendments

        sle = ledger.read_entry(indexes.amendment_index())
        self.amendments.set_enabled(
            list(sle.get(sfAmendments, [])) if sle is not None else []
        )
