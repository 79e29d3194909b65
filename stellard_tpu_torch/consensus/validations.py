"""ValidationsStore: received validations, indexed by ledger hash and by
signer, with staleness rules and the quorum/election queries consensus
and LedgerMaster need.

Reference: src/ripple_app/misc/Validations.cpp — addValidation (:72),
getTrustedValidationCount (:221), getCurrentValidations (:338).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .timing import LEDGER_EARLY_INTERVAL, LEDGER_VAL_INTERVAL
from .validation import STValidation

__all__ = ["ValidationsStore"]


class ValidationsStore:
    def __init__(
        self,
        is_trusted: Callable[[bytes], bool],
        now: Callable[[], int],
        max_ledgers: int = 256,
    ):
        self._lock = threading.Lock()
        self.is_trusted = is_trusted  # node pubkey -> on our UNL?
        self.now = now  # network time (seconds since network epoch)
        self.max_ledgers = max_ledgers
        # defense sink (ValidatorNode.note_byzantine, set post-init):
        # equivocating / stale / duplicated validations are counted —
        # they were already harmless to quorum math, now they are visible
        self.note_byzantine = None
        # ledger hash -> {signer -> validation}
        self.by_ledger: dict[bytes, dict[bytes, STValidation]] = {}
        # signer -> its latest current validation
        self.current: dict[bytes, STValidation] = {}
        # highest ledger seq WE have signed a validation for
        # (reference: Validations::canValidateSeq — a validator's issued
        # seqs are strictly increasing, so fork repair can never make an
        # honest key sign two different ledgers at one seq; without this
        # two overlapping "quorums" could validate different ledgers at
        # one seq, a fork the scenario fuzzer actually reached)
        self.local_high_seq = 0

    def _is_current(self, val: STValidation, now: int) -> bool:
        """reference: isCurrent — reject far-future and stale signing
        times (LEDGER_EARLY_INTERVAL / LEDGER_VAL_INTERVAL)."""
        t = val.signing_time
        return (now - LEDGER_VAL_INTERVAL) < t < (now + LEDGER_EARLY_INTERVAL)

    def add(self, val: STValidation, local: bool = False) -> bool:
        """Store a (signature-checked) validation. Returns True when it is
        current and should be relayed (reference: addValidation :72-120).
        ``local`` marks our own just-built validation (never charged to
        the defense counters)."""
        val.trusted = self.is_trusted(val.signer)
        now = self.now()
        current = self._is_current(val, now)
        note = self.note_byzantine if not local else None
        if local and val.ledger_seq is not None:
            self.local_high_seq = max(self.local_high_seq, val.ledger_seq)
        with self._lock:
            per_signer = self.by_ledger.setdefault(val.ledger_hash, {})
            dup = (
                val.signer in per_signer
                and per_signer[val.signer].signing_time == val.signing_time
            )
            per_signer[val.signer] = val
            self._trim()
            if current:
                prev = self.current.get(val.signer)
                conflicting = (
                    prev is not None
                    and prev.ledger_hash != val.ledger_hash
                    and prev.ledger_seq is not None
                    and prev.ledger_seq == val.ledger_seq
                )
                if prev is None or prev.signing_time < val.signing_time:
                    self.current[val.signer] = val
                    # one key signing TWO ledgers at one seq: the newer
                    # statement REPLACES the older in the election (a
                    # signer never holds two current votes) and the
                    # equivocation is counted
                    if conflicting and note is not None:
                        note("conflicting_validation", peer=val.signer,
                             seq=val.ledger_seq)
                    return True
                if note is not None:
                    if conflicting:
                        note("conflicting_validation", peer=val.signer,
                             seq=val.ledger_seq)
                    elif dup:
                        note("duplicate_validation", peer=val.signer)
                return False
        if note is not None:
            # signing time outside the currency window: replayed history
            # or a far-future stamp — stored for the per-hash record,
            # zero electoral weight
            note("stale_validation", peer=val.signer)
        return False

    def can_sign(self, seq: Optional[int]) -> bool:
        """May WE issue a validation for this seq? Strictly increasing
        issued seqs (reference: canValidateSeq) — after fork repair a
        validator abstains at seqs it already voted rather than signing
        a second, conflicting statement."""
        return seq is None or seq > self.local_high_seq

    def _trim(self) -> None:
        while len(self.by_ledger) > self.max_ledgers:
            self.by_ledger.pop(next(iter(self.by_ledger)))

    # -- quorum queries ---------------------------------------------------

    def trusted_count_for(self, ledger_hash: bytes) -> int:
        """How many trusted validators validated this ledger
        (reference: getTrustedValidationCount :221 — feeds
        LedgerMaster::checkAccept)."""
        with self._lock:
            vals = self.by_ledger.get(ledger_hash, {})
            return sum(1 for v in vals.values() if v.trusted)

    def validations_for(self, ledger_hash: bytes) -> list[STValidation]:
        with self._lock:
            return list(self.by_ledger.get(ledger_hash, {}).values())

    def current_trusted(self) -> list[STValidation]:
        """Current validations from trusted signers, dropping expired ones
        (reference: getCurrentValidations :338 — LCL election input)."""
        now = self.now()
        with self._lock:
            out, dead = [], []
            for signer, v in self.current.items():
                if not self._is_current(v, now):
                    dead.append(signer)
                elif v.trusted:
                    out.append(v)
            for signer in dead:
                del self.current[signer]
            return out

    def current_ledger_weights(self) -> dict[bytes, int]:
        """ledger hash -> count of current trusted validations — the
        weighted LCL election (reference: checkLastClosedLedger,
        NetworkOPs.cpp:776)."""
        weights: dict[bytes, int] = {}
        for v in self.current_trusted():
            weights[v.ledger_hash] = weights.get(v.ledger_hash, 0) + 1
        return weights

    def size(self) -> int:
        with self._lock:
            return sum(len(m) for m in self.by_ledger.values())
