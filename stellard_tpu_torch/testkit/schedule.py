"""Fault-schedule DSL: a declarative, step-indexed list of network
faults, built once (optionally with a seeded RNG for randomized
placement) and then REPLAYED — the schedule is data, so a seed maps to
exactly one fault pattern and the scorecard can carry a digest of it.

Event kinds map 1:1 onto the simnet's fault plane:

    partition(at, a, b[, heal_at])     cut every a<->b link (+ heal)
    kill(at, nid[, revive_at])         silence a validator (+ revive)
    link_fault(at, a, b, ..., until=)  drop/dup/delay/jitter on a link
    rotate_kills(nids, ...)            chaos-soak style rotating victims

The TCP runner consumes the same schedule but only supports the kinds a
process net can express (kill/revive); a scenario tagged for both
transports must restrict itself to that subset.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass

__all__ = ["FaultEvent", "FaultSchedule"]


@dataclass(frozen=True)
class FaultEvent:
    at: int       # step index (simnet) / ~seconds (tcp)
    order: int    # tiebreak: schedule-build order, stable across runs
    kind: str
    args: tuple = ()
    kwargs: tuple = ()  # sorted (key, value) pairs


class FaultSchedule:
    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(0xFA17 ^ seed)
        self.events: list[FaultEvent] = []
        self._order = 0

    def add(self, at: int, kind: str, *args, **kwargs) -> "FaultSchedule":
        self.events.append(FaultEvent(
            int(at), self._order, kind, tuple(args),
            tuple(sorted(kwargs.items())),
        ))
        self._order += 1
        return self

    # -- composite builders ------------------------------------------------

    def partition(self, at: int, group_a, group_b,
                  heal_at: int | None = None) -> "FaultSchedule":
        self.add(at, "partition", tuple(sorted(group_a)),
                 tuple(sorted(group_b)))
        if heal_at is not None:
            self.add(heal_at, "heal", tuple(sorted(group_a)),
                     tuple(sorted(group_b)))
        return self

    def kill(self, at: int, nid: int,
             revive_at: int | None = None) -> "FaultSchedule":
        self.add(at, "kill", nid)
        if revive_at is not None:
            self.add(revive_at, "revive", nid)
        return self

    def link_fault(self, at: int, a: int, b: int,
                   until: int | None = None, **fault) -> "FaultSchedule":
        self.add(at, "link_fault", a, b, **fault)
        if until is not None:
            self.add(until, "clear_link_fault", a, b)
        return self

    def rotate_kills(self, nids, start: int, every: int, downtime: int,
                     count: int) -> "FaultSchedule":
        """Chaos-soak shape: every `every` steps from `start`, kill a
        seeded-random victim for `downtime` steps, `count` times.
        Victims never overlap (a revive always lands before the next
        kill when downtime < every)."""
        nids = list(nids)
        at = start
        for _ in range(count):
            victim = self.rng.choice(nids)
            self.kill(at, victim, revive_at=at + downtime)
            at += every
        return self

    def extend(self, events) -> "FaultSchedule":
        """Merge pre-built events (data-form schedules, corpus entries)
        AS-IS — original `order` values preserved so replay tiebreaks
        match the source — and renumber the build counter past them so
        later add() calls stay unique. The one owner of that invariant
        (run_simnet, run_tcp and from_json all merge through here)."""
        self.events.extend(events)
        self._order = 1 + max(
            (e.order for e in self.events), default=-1
        )
        return self

    # -- replay ------------------------------------------------------------

    def events_at(self, step: int) -> list[FaultEvent]:
        return sorted(
            (e for e in self.events if e.at == step),
            key=lambda e: e.order,
        )

    def max_step(self) -> int:
        return max((e.at for e in self.events), default=0)

    def describe(self) -> list[tuple]:
        """Canonical, deterministic event list (scorecard material)."""
        return [
            (e.at, e.order, e.kind, e.args, e.kwargs)
            for e in sorted(self.events, key=lambda e: (e.at, e.order))
        ]

    def digest(self) -> str:
        """Stable digest of the whole schedule: two runs of one seed must
        agree on this, and the smoke pins it."""
        h = hashlib.sha256(repr(self.describe()).encode())
        return h.hexdigest()[:16]

    # -- serialization (the shrinker/corpus need schedules as DATA) --------

    def to_json(self) -> dict:
        """Lossless JSON form: ``from_json(to_json())`` reproduces the
        identical event list AND ``digest()`` (pinned by test). The
        schedule's build-time RNG state is NOT captured — a deserialized
        schedule is replayed/edited as data, never re-randomized."""
        return {
            "seed": self.seed,
            "events": [
                [e.at, e.order, e.kind, _jsonify(e.args),
                 _jsonify(e.kwargs)]
                for e in self.events
            ],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "FaultSchedule":
        sched = cls(int(obj.get("seed", 0)))
        sched.extend(
            FaultEvent(
                int(at), int(order), str(kind),
                _tupleize(args), _tupleize(kwargs),
            )
            for at, order, kind, args, kwargs in obj["events"]
        )
        return sched


def _jsonify(v):
    """Tuples → lists, recursively (JSON has no tuple type)."""
    if isinstance(v, tuple):
        return [_jsonify(x) for x in v]
    return v


def _tupleize(v):
    """Inverse of _jsonify: lists → tuples, recursively. Event args only
    ever hold ints/floats/strs and (nested) tuples of them, so the
    round trip is lossless and digest-stable."""
    if isinstance(v, list):
        return tuple(_tupleize(x) for x in v)
    return v
