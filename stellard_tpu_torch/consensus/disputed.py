"""DisputedTx: a transaction that is in some proposers' candidate sets
but not others'; tracks votes and runs the avalanche vote-switching rule.

Reference: src/ripple_app/consensus/DisputedTx.{h,cpp}.
"""

from __future__ import annotations

from .timing import avalanche_threshold

__all__ = ["DisputedTx"]


class DisputedTx:
    def __init__(self, txid: bytes, blob: bytes, our_vote: bool):
        self.txid = txid
        self.blob = blob
        self.our_vote = our_vote
        self.votes: dict[bytes, bool] = {}  # peer node key -> yes/no

    def set_vote(self, peer: bytes, yes: bool) -> None:
        self.votes[peer] = yes

    def unvote(self, peer: bytes) -> None:
        self.votes.pop(peer, None)

    @property
    def yays(self) -> int:
        return sum(1 for v in self.votes.values() if v)

    @property
    def nays(self) -> int:
        return sum(1 for v in self.votes.values() if not v)

    def update_vote(self, time_pct: int, proposing: bool) -> bool:
        """Re-evaluate our vote given round progress; returns True when our
        vote flips (→ we must advance our position)
        (reference: DisputedTx::updateVote — our current vote is weighted
        in with the peers', then compared to the escalating threshold)."""
        if self.our_vote and self.nays == 0:
            new_vote = True  # unanimous agreement with us: keep
        elif not self.our_vote and self.yays == 0:
            new_vote = False  # nobody disagrees with our NO: keep
        elif proposing:
            weight = (self.yays * 100 + (100 if self.our_vote else 0)) // (
                self.yays + self.nays + 1
            )
            new_vote = weight > avalanche_threshold(time_pct)
        else:
            # not proposing: just adopt the majority
            new_vote = self.yays > self.nays
        changed = new_vote != self.our_vote
        self.our_vote = new_vote
        return changed

    def __repr__(self):
        return (
            f"DisputedTx({self.txid.hex()[:8]} our={self.our_vote} "
            f"+{self.yays}/-{self.nays})"
        )
