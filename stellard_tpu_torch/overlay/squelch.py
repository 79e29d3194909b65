"""Validator-message squelching: deterministic rotating relay subsets.

Role parity with the reference overlay's squelching ("reduce-relay"):
at production fan-in, relaying every validator's proposals and
validations to EVERY peer costs O(peers) sends per node per message —
the dominant overlay traffic at 1000 peers. Squelching bounds each
node's relay fan-out for a given validator to a small subset of its
peers, rotated on an epoch schedule so no fixed set of relayers is a
permanent censorship point.

The reference negotiates squelches dynamically (receivers tell senders
to stop); this reproduction derives the subset DETERMINISTICALLY so the
deterministic simnet replays bit-identically and any two processes
agree on the subset without negotiation traffic:

    rank(candidate) = sha512_half(signer || epoch || relayer || candidate)

and the relay set is the ``size`` lowest-ranked candidates. Properties:

- pure function of (signer, epoch, relayer id, candidate ids): the same
  UNL + seq yields the same subset in every process (pinned by test);
- rotation: the epoch advances every ``rotate`` ledgers, re-randomizing
  every subset; peer churn re-ranks immediately (the subset is always
  computed over the CURRENT candidate set);
- per-relayer diversity: the relayer's own id salts the rank, so the
  union of all nodes' subsets forms a k-out gossip digraph (connected
  with overwhelming probability for size >= 2) rather than one global
  k-subset that would strand messages;
- trusted-validator peers are ALWAYS included (consensus-critical
  traffic is never squelched away from the quorum), so the fan-out
  bound is ``size + |UNL peers|`` — independent of peer count;
- untrusted-source demotion: messages signed by keys outside the UNL
  relay to ``max(1, size // demote_factor)`` peers with NO forced
  validator inclusion — correctly-signed-but-untrusted chatter cannot
  buy full fan-out.

``size=0`` is the kill-switch: full flood, byte-for-byte the
pre-squelch behavior (pinned by test).
"""

from __future__ import annotations

import struct
from typing import Callable, Iterable, Optional

from ..utils.hashes import sha512_half

__all__ = ["SQUELCH_SIZE", "SQUELCH_ROTATE", "relay_rank", "SquelchPolicy"]

# default relay-subset size per (validator, epoch); the reference keeps
# a similar single-digit squelch set per validator
SQUELCH_SIZE = 8
# ledgers per squelch epoch: long enough that a subset amortizes, short
# enough that a bad relayer set rotates away within a minute
SQUELCH_ROTATE = 16


def relay_rank(
    signer: bytes, epoch: int, relayer: bytes, candidate: bytes
) -> bytes:
    """The deterministic ranking key (lowest ranks win a relay slot)."""
    return sha512_half(
        signer + struct.pack(">Q", epoch & 0xFFFFFFFFFFFFFFFF)
        + relayer + candidate
    )


class SquelchPolicy:
    """Subset computation + a one-epoch memo.

    The memo matters at scale: ranking is O(candidates) hashes, and at
    1000 peers a validator's proposal triggers a relay decision on every
    node it reaches — caching per (signer, epoch) makes the steady-state
    cost O(size) sends. The cache is invalidated by epoch advance or by
    ``bump()`` (peer churn).
    """

    def __init__(
        self,
        size: int = SQUELCH_SIZE,
        rotate: int = SQUELCH_ROTATE,
        demote_factor: int = 4,
        relayer_id: bytes = b"",
    ):
        self.size = int(size)
        self.rotate = max(1, int(rotate))
        self.demote_factor = max(1, int(demote_factor))
        self.relayer_id = relayer_id
        self._cache: dict[tuple, list] = {}
        self._version = 0  # bumped on peer churn

    @property
    def enabled(self) -> bool:
        return self.size > 0

    @property
    def demoted_size(self) -> int:
        return max(1, self.size // self.demote_factor)

    def epoch(self, seq: int) -> int:
        return int(seq) // self.rotate

    def bump(self) -> None:
        """Candidate set changed (peer churn): drop every memoized
        subset so the next relay re-ranks over the current peers."""
        self._version += 1
        self._cache.clear()

    def subset(
        self,
        signer: bytes,
        seq: int,
        candidates: Iterable,
        key_fn: Callable[[object], bytes],
        trusted: Optional[Callable[[object], bool]] = None,
        demoted: bool = False,
    ) -> list:
        """Relay targets for one validator's message at ledger ``seq``.

        ``candidates`` is the relayer's current peer set (any objects),
        ``key_fn`` maps a candidate to its stable wire identity bytes,
        ``trusted`` marks always-include candidates (UNL peers),
        ``demoted=True`` applies the untrusted-source demotion.
        """
        cands = list(candidates)
        if not self.enabled:
            return cands
        k = self.demoted_size if demoted else self.size
        if len(cands) <= k:
            return cands
        ep = self.epoch(seq)
        memo_key = (signer, ep, demoted, self._version, len(cands))
        hit = self._cache.get(memo_key)
        if hit is not None:
            return hit
        ranked = sorted(
            cands,
            key=lambda c: relay_rank(signer, ep, self.relayer_id, key_fn(c)),
        )
        picked = ranked[:k]
        if not demoted and trusted is not None:
            chosen = {id(c) for c in picked}
            picked = picked + [
                c for c in cands
                if trusted(c) and id(c) not in chosen
            ]
        if len(self._cache) > 256:  # one-epoch working set is tiny
            self._cache.clear()
        self._cache[memo_key] = picked
        return picked

    def get_json(self) -> dict:
        return {
            "size": self.size,
            "rotate": self.rotate,
            "demoted_size": self.demoted_size if self.enabled else 0,
            "enabled": self.enabled,
        }
