"""Cascading follower trees: deterministic topology planning + child
subset selection.

Role: with a flat follower tier every follower dials the LEADER, so
the leader's egress per close is O(followers) — validation relays,
GetLedger replies, and segment serving all scale with the read tier.
A cascading tree bounds the leader's egress to its DIRECT children:
each follower names a follower (not the leader) as upstream via
``[node] upstream=`` and re-publishes the validated ledger stream +
segment ranges downstream (the existing relay/serve paths in
``overlay.tcp`` already run on followers; this module only decides
WHO dials WHOM).

Two deterministic pieces, shared by simnet scenarios, the depth-2
tree smoke, and the 100k-subscriber bench so every harness agrees on
the topology without negotiation:

- ``plan_tree(n_followers, branching)``: a breadth-first ``branching``-ary
  heap layout rooted at the leader. Follower ``j`` occupies heap slot
  ``j + 1`` (the leader is slot 0), so its parent is follower
  ``j // branching - 1`` — ``-1`` meaning the leader itself. The first
  ``branching`` followers are the leader's only dialers; everyone else
  hangs off a follower.

- ``select_children(...)``: when a tier over-subscribes (more dialers
  than a parent's child budget), the subset is chosen by the SAME
  rank function as overlay squelching (``squelch.relay_rank``) so any
  two processes agree on the child set for a given epoch without
  traffic, and the set rotates on the squelch epoch schedule so no
  fixed parent is a permanent point of failure.
"""

from __future__ import annotations

from typing import Callable, Iterable

from .squelch import SQUELCH_ROTATE, relay_rank

__all__ = [
    "plan_tree",
    "tier_of",
    "select_children",
    "tree_stats",
]

# domain separator: child-selection ranks must not collide with relay
# squelch ranks for the same (signer, epoch, peer) tuple
_TREE_SALT = b"followertree/v1"


def plan_tree(n_followers: int, branching: int) -> list[int]:
    """Parent index for each follower: ``-1`` = dial the leader,
    ``k >= 0`` = dial follower ``k``. Breadth-first heap layout, so
    the leader has at most ``branching`` direct children and depth is
    O(log_branching(n))."""
    b = max(1, int(branching))
    return [j // b - 1 for j in range(max(0, int(n_followers)))]


def tier_of(follower: int, branching: int) -> int:
    """1-based tree depth of a follower (1 = direct child of the
    leader) under the ``plan_tree`` layout."""
    b = max(1, int(branching))
    tier, j = 1, int(follower)
    while j // b - 1 >= 0:
        j = j // b - 1
        tier += 1
    return tier


def select_children(
    parent_id: bytes,
    seq: int,
    candidates: Iterable,
    key_fn: Callable[[object], bytes],
    size: int,
    rotate: int = SQUELCH_ROTATE,
) -> list:
    """Deterministic child subset for an over-subscribed parent: the
    ``size`` lowest-ranked candidates under the squelch rank function,
    salted so tree selection and relay squelching never share ranks.
    Pure function of (parent, epoch, candidate ids) — every process
    computes the same set; rotates every ``rotate`` ledgers."""
    cands = list(candidates)
    k = int(size)
    if k <= 0 or len(cands) <= k:
        return cands
    epoch = int(seq) // max(1, int(rotate))
    ranked = sorted(
        cands,
        key=lambda c: relay_rank(parent_id, epoch, _TREE_SALT, key_fn(c)),
    )
    return ranked[:k]


def tree_stats(parents: list[int], branching: int) -> dict:
    """Shape evidence for scorecards/provenance: leader child count,
    max depth, and max observed fan-out at any node."""
    children: dict[int, int] = {}
    for p in parents:
        children[p] = children.get(p, 0) + 1
    depth = max((tier_of(j, branching) for j in range(len(parents))),
                default=0)
    return {
        "n_followers": len(parents),
        "branching": max(1, int(branching)),
        "leader_children": children.get(-1, 0),
        "max_children": max(children.values(), default=0),
        "depth": depth,
    }
