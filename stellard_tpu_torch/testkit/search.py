"""Coverage-guided scenario search: the fault-schedule DSL as a bug
factory.

FoundationDB's lesson (Zhou et al., SIGMOD 2021) is that deterministic
simulation pays off through SEARCH — thousands of seeded schedules, any
failure replaying exactly from its data — and Yuan et al. (OSDI 2014)
that the catastrophic bugs live in rarely-driven error-handling paths
simple fault injection reaches. This module supplies the three pieces
around the unchanged ``run_simnet``:

- **generation**: a seeded ``ScenarioGenerator`` builds/mutates
  data-form ``Scenario``s — fault-schedule step groups (partitions,
  kills, link faults, rotating kills), scenario axes (validator count,
  quorum within safety bounds, workload kind/size, admission caps,
  relay tier + squelch + flooders, followers, cold-node joins) — all
  inside validity constraints, all randomness from ONE ``random.Random``
  stream so a fuzz seed maps to exactly one scenario sequence;
- **coverage**: each run's scorecard collapses to a fixed-shape
  dynamics state (``coverage_state``), bucketed and hashed into a
  signature; the sweep keeps a
  pool of scenarios that reached NOVEL signatures and spends most of
  its budget mutating high-energy pool entries (energy = rewarded on
  novelty, decayed on stale) instead of sampling uniformly — the
  scorecard-as-coverage analog of AFL's branch-edge map;
- **invariants + shrinking**: a first-class registry classifies every
  run (convergence, one hash per seq, committed-workload floor,
  anti-vacuity of configured faults, TxQ fairness, follower/cold sync,
  byte-identical re-run of the same seed, and the test-only planted
  ``synthetic_bug``); on violation a greedy shrinker drops schedule
  step groups and weakens axes while the SAME invariant keeps firing,
  emitting a minimal data-form scenario as a corpus entry
  (``testkit/corpus/``) that ``build_scenario`` loads as a permanent
  regression.

Everything here is a pure function of (fuzz_seed, code): the generated
scenario digests, the coverage map trajectory, and the shrink
trajectory are byte-identical across processes and PYTHONHASHSEED
values (pinned by tests/test_search.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
from dataclasses import dataclass
from typing import Callable, Optional

from .byzantine import BEHAVIORS
from .scenario import SYNTH_BUG, Scenario, run_simnet
from .schedule import FaultSchedule

__all__ = [
    "coverage_signature",
    "coverage_state",
    "counter_vector",
    "check_invariants",
    "Violation",
    "ScenarioGenerator",
    "schedule_groups",
    "shrink_scenario",
    "sweep",
    "coverage_comparison",
    "corpus_entry",
    "write_corpus_entry",
    "SYNTH_THRESHOLD",
]

# the planted bug (scenario.SYNTH_BUG) trips at this total magnitude;
# the known-minimal repro is therefore two plant events summing to
# exactly 3 (one event is capped at magnitude 2 by the generator)
SYNTH_THRESHOLD = 3


# -- coverage signal ------------------------------------------------------

def _bucket(v: int) -> int:
    """AFL-style hit-count bucketing, one class per ~2 octaves: 0, 1-3,
    4-15, 16-63, 64-255, 256+. Coarse on purpose — the signature must
    answer "which defense/fault/admission machinery fired, and at what
    order of magnitude", not echo every scenario's exact traffic count
    (log2-fine buckets made nearly every run a \"novel\" state, which
    starves the novelty bias of signal)."""
    v = int(v)
    if v <= 0:
        return 0
    return min(5, 1 + max(0, (v.bit_length() - 1) // 2))


def counter_vector(card: dict) -> dict[str, int]:
    """Flatten a scorecard into one deterministic counter dict — the
    TRIAGE view. The
    coverage map itself hashes the much coarser ``coverage_state``;
    this keeps every counter, for humans reading a repro. Wall-clock-
    dependent blocks (``spec``) are excluded by design."""
    out: dict[str, int] = {}

    def put(key: str, v) -> None:
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, (int, float)) and v is not None:
            out[key] = int(v)

    for k in ("converged", "single_hash", "rounds", "tail_steps",
              "degraded_transitions", "submitted", "committed",
              "final_seq"):
        put(k, card.get(k, 0))
    put("lost", card.get("submitted", 0) - card.get("committed", 0))
    put("fork_seqs", len(card.get("fork_seqs", ())))
    for blk in ("net", "splice", "byzantine", "resource", "relay",
                "synth"):
        for k, v in (card.get(blk) or {}).items():
            put(f"{blk}.{k}", v)
    txq = card.get("txq") or {}
    for k, v in (txq.get("stats") or {}).items():
        put(f"txq.{k}", v)
    for k in ("admitted", "queued", "rejected", "queued_committed",
              "fee_order_drain", "no_starvation"):
        if k in txq:
            put(f"txq.{k}", txq[k])
    cu = card.get("catchup") or {}
    put("catchup.synced", cu.get("synced"))
    for k, v in (cu.get("segfetch") or {}).items():
        put(f"segfetch.{k}", v)
    for k, v in (cu.get("shards") or {}).items():
        put(f"shards.{k}", v)  # history-shard tier coverage axis
    fol = card.get("followers") or {}
    put("followers.synced", fol.get("synced"))
    # sharded hash plane (triage view only — width is CONFIG echo, so
    # it stays OUT of coverage_state's config-blind dynamics vector)
    mesh = card.get("mesh") or {}
    put("mesh.width", mesh.get("width"))
    put("mesh.device_active", mesh.get("device_active"))
    for nid, fl in (card.get("flooders") or {}).items():
        put(f"flooder.{nid}.refused_by", fl.get("refused_by", 0))
    return out


# the defense-counter kinds (ValidatorNode.defense bundle order)
_DEFENSE_KINDS = (
    "bad_proposal_sig", "bad_validation_sig", "conflicting_proposal",
    "duplicate_proposal", "conflicting_validation",
    "duplicate_validation", "stale_validation", "untrusted_validation",
    "oversized_txset", "txset_mismatch", "malformed_frame",
    "garbage_segment",
)


def coverage_state(card: dict) -> tuple:
    """One scorecard -> its DYNAMICS state: a fixed-shape vector of
    verdicts, which-machinery-fired bits, and coarse magnitudes. This
    deliberately ignores configuration echo (traffic volume, exact
    counts): two payment floods of different sizes that exercised the
    same machinery are the SAME state, so the map saturates under
    uniform sampling and novelty is a real signal (counter_vector keeps
    the full flattened view for triage/diagnostics)."""
    net = card.get("net") or {}
    sp = card.get("splice") or {}
    byz = card.get("byzantine") or {}
    cu = card.get("catchup") or {}
    sf = cu.get("segfetch") or {}
    txq = card.get("txq") or {}
    res = card.get("resource") or {}
    return (
        bool(card.get("converged")),
        bool(card.get("single_hash")),
        bool(card.get("fork_seqs")),
        _bucket(card.get("submitted", 0) - card.get("committed", 0)),
        _bucket(sp.get("fallback", 0)),
        _bucket(sp.get("invalidated", 0)),
        card.get("degraded_transitions", 0) > 0,
        net.get("dropped_down", 0) > 0,
        net.get("dropped_link", 0) > 0,
        net.get("dropped_fault", 0) > 0,
        net.get("duplicated", 0) > 0,
        net.get("delayed", 0) > 0,
        tuple(byz.get(k, 0) > 0 for k in _DEFENSE_KINDS),
        _bucket(res.get("dropped", 0)),
        _bucket(res.get("throttled", 0)),
        res.get("refused", 0) > 0,
        cu.get("synced"),
        sf.get("garbage_peers", 0) > 0,
        _bucket(sf.get("timeouts", 0)),
        _bucket(sf.get("retries", 0)),
        _bucket(txq.get("queued", 0)),
        txq.get("no_starvation"),
        txq.get("fee_order_drain"),
        (card.get("followers") or {}).get("synced"),
        _bucket((card.get("synth") or {}).get("planted", 0)),
        # archive tier — appended at the END so every
        # pre-existing coverage signature stays stable
        (card.get("archive") or {}).get("imported", 0) > 0,
        (card.get("archive") or {}).get("byte_match_failures", 0) > 0,
        (card.get("archive") or {}).get("garbage_peers", 0) > 0,
    )


def coverage_signature(card: dict) -> str:
    """One scorecard -> one coverage-state hash (fixed-shape dynamics
    vector: PYTHONHASHSEED-proof and cross-process stable)."""
    return hashlib.sha256(
        repr(coverage_state(card)).encode()
    ).hexdigest()[:16]


# -- invariant registry ---------------------------------------------------

@dataclass(frozen=True)
class Violation:
    invariant: str
    detail: str


def _strip_nondeterministic(card: dict) -> dict:
    out = dict(card)
    out.pop("spec", None)  # wall-clock worker counters, by design
    return out


def check_invariants(
    scn: Scenario, card: dict, recard: Optional[dict] = None
) -> list[Violation]:
    """Classify one run. Ordered most-specific-first: the FIRST entry
    names the failure for shrinking/corpus purposes. `recard`, when
    given, is a second run of the identical scenario — byte-identical
    scorecards are part of the contract (the FoundationDB property)."""
    v: list[Violation] = []
    ev_kinds = [e.kind for e in _events_of(scn)]

    # (0) the planted test-only bug: scorecard evidence past threshold
    planted = (card.get("synth") or {}).get("planted", 0)
    if planted >= SYNTH_THRESHOLD:
        v.append(Violation(
            "synthetic_bug", f"planted magnitude {planted} >= "
            f"{SYNTH_THRESHOLD}"
        ))

    # (1) determinism: same seed, byte-identical scorecard
    if recard is not None:
        a = json.dumps(_strip_nondeterministic(card), sort_keys=True)
        b = json.dumps(_strip_nondeterministic(recard), sort_keys=True)
        if a != b:
            diff = [
                k for k in sorted(set(card) | set(recard))
                if card.get(k) != recard.get(k) and k != "spec"
            ]
            v.append(Violation(
                "determinism", f"re-run diverged in fields {diff}"
            ))

    # (2) liveness: every honest validator quorum-validated the target
    if not card.get("converged"):
        v.append(Violation(
            "convergence",
            f"validated_seqs={card.get('validated_seqs')} after "
            f"{card.get('tail_steps')} tail steps",
        ))

    # (3) safety: one hash at the common seq, and one per seq below it
    if card.get("converged") and not card.get("single_hash"):
        v.append(Violation(
            "single_hash", f"fork at seq {card.get('final_seq')}"
        ))
    if card.get("fork_seqs"):
        v.append(Violation(
            "single_hash_history",
            f"honest histories disagree at seqs {card['fork_seqs']}",
        ))

    # (4) committed-workload floor: client submissions must land on the
    # final chain (with an admission plane attached, the queue's own
    # fairness verdicts replace the exact floor)
    if card.get("converged"):
        if scn.txq_cap:
            txq = card.get("txq") or {}
            if not txq.get("no_starvation", True):
                v.append(Violation(
                    "txq_no_starvation",
                    f"queued={txq.get('queued')} "
                    f"queued_committed={txq.get('queued_committed')}",
                ))
            if not txq.get("fee_order_drain", True):
                v.append(Violation(
                    "txq_fee_order",
                    "queued high-fee txs committed later than low-fee",
                ))
        elif card.get("committed", 0) != card.get("submitted", 0):
            v.append(Violation(
                "committed_floor",
                f"{card.get('committed')}/{card.get('submitted')} "
                f"workload txs on the final chain",
            ))

    # (5) attached tiers must end synced
    if card.get("converged"):
        if scn.cold_nodes and not (card.get("catchup") or {}).get(
            "synced", True
        ):
            v.append(Violation(
                "cold_sync",
                f"cold node at seq "
                f"{card.get('catchup', {}).get('cold_validated_seq')}",
            ))
        if getattr(scn, "shards", False):
            # anti-vacuity for the shard-tier leg: the rotation must
            # have sealed shards AND the cold sync must have actually
            # read from one — a "passing" leg where the cold node never
            # touched cold storage proves nothing about the tier
            sh = (card.get("catchup") or {}).get("shards") or {}
            if not sh.get("sealed") or not sh.get("segment_reads"):
                v.append(Violation(
                    "shard_tier_vacuous",
                    f"sealed={sh.get('sealed')} "
                    f"segment_reads={sh.get('segment_reads')}",
                ))
        if getattr(scn, "archive", False):
            # archive tier: every historical answer the
            # archive serves must byte-match the sealed shard's
            # verified contents — and the leg must have actually
            # imported and queried something (a backfill that moved
            # zero shards or compared zero bytes proves nothing)
            ar = card.get("archive") or {}
            if ar.get("byte_match_failures", 0) > 0:
                v.append(Violation(
                    "archive_byte_match",
                    f"{ar.get('byte_match_failures')}/"
                    f"{ar.get('queries')} archive answers diverged "
                    f"from sealed shard contents",
                ))
            if not ar.get("imported") or not ar.get("queries"):
                v.append(Violation(
                    "archive_tier_vacuous",
                    f"imported={ar.get('imported')} "
                    f"queries={ar.get('queries')}",
                ))
        if scn.n_followers and not (card.get("followers") or {}).get(
            "synced", True
        ):
            v.append(Violation(
                "follower_sync",
                f"followers at {card.get('followers', {}).get('validated_seqs')}",
            ))
        if getattr(scn, "path_subs", 0):
            # liquidity plane: the incremental index must
            # equal the full scan at every close, the budgeted
            # re-ranker must have run (anti-vacuity), and stalest-first
            # under a ceil(n/2) budget bounds worst-case staleness —
            # a subscription starving past 4 closes is a scheduler bug
            p = card.get("paths") or {}
            if not p.get("identity_ok", True):
                v.append(Violation(
                    "path_index_identity",
                    f"incremental book index diverged from the full "
                    f"scan ({p.get('closes')} closes)",
                ))
            if p.get("closes", 0) > 0 and not p.get("reranked"):
                v.append(Violation(
                    "anti_vacuity",
                    "path subscriptions configured but zero re-ranks",
                ))
            if p.get("staleness_max", 0) > 4:
                v.append(Violation(
                    "path_staleness",
                    f"subscription staleness hit "
                    f"{p.get('staleness_max')} closes under a "
                    f"ceil(n/2) budget",
                ))

    # (6) no-silent-fault anti-vacuity: every configured hostile input
    # must leave counter evidence — a scenario that silently stopped
    # injecting faults greenwashes, and must fail instead
    net = card.get("net") or {}
    has_traffic = card.get("submitted", 0) > 0 or net.get("sent", 0) > 0
    if has_traffic:
        if ("kill" in ev_kinds and net.get("dropped_down", 0) == 0):
            v.append(Violation(
                "anti_vacuity", "kill events but zero dropped_down"
            ))
        if ("partition" in ev_kinds and net.get("dropped_link", 0) == 0):
            v.append(Violation(
                "anti_vacuity", "partition events but zero dropped_link"
            ))
        # link faults: require EXPOSURE (messages crossed the faulted
        # link while it was armed), not probabilistic outcomes — a drop
        # fault that got a lucky streak is not a silent fault, but one
        # whose window never saw traffic is
        if any(e.kind == "link_fault" for e in _events_of(scn)) and \
                net.get("fault_exposed", 0) == 0:
            v.append(Violation(
                "anti_vacuity",
                "link fault armed but zero messages crossed it",
            ))
    if scn.byzantine:
        emitted = card.get("byzantine_emitted") or {}
        for nid, em in emitted.items():
            for behavior, n in em.items():
                if n <= 0:
                    v.append(Violation(
                        "anti_vacuity",
                        f"byzantine slot {nid} behavior {behavior} "
                        f"emitted nothing",
                    ))
        if sum((card.get("byzantine") or {}).values()) == 0:
            v.append(Violation(
                "anti_vacuity", "byzantine slot but zero defense counters"
            ))
    for nid, fl in (card.get("flooders") or {}).items():
        if sum(fl.get("emitted", {}).values()) == 0:
            v.append(Violation(
                "anti_vacuity", f"flooder {nid} emitted nothing"
            ))

    # (7) SLO watchdog wiring: a close-cadence stall the run
    # OBSERVED (max gap past the warn line) must trip the health
    # dimension — a watchdog that sleeps through an injected stall is
    # vacuous; and with no faults injected a run must stay ok — a
    # watchdog that cries on a clean run is noise, not observability
    h = card.get("health") or {}
    if h:
        gap = h.get("max_close_gap_steps", 0)
        warn_at = h.get("stall_warn_steps", 0)
        if warn_at and gap > warn_at and h.get("worst") == "ok":
            v.append(Violation(
                "health_missed_stall",
                f"close gap {gap} steps > warn line {warn_at} but "
                f"health stayed ok",
            ))
        faultless = (
            not ev_kinds and scn.build_schedule is None
            and not scn.byzantine and not scn.flooders
            and not scn.cold_nodes and scn.kill_server_at is None
        )
        if faultless and h.get("worst", "ok") != "ok":
            v.append(Violation(
                "health_false_positive",
                f"health hit {h.get('worst')} with no injected faults",
            ))

    # dedup (anti-vacuity can repeat), order-preserving
    seen = set()
    out = []
    for viol in v:
        key = (viol.invariant, viol.detail)
        if key not in seen:
            seen.add(key)
            out.append(viol)
    return out


def _events_of(scn: Scenario) -> list:
    return list(scn.schedule.events) if scn.schedule is not None else []


# -- schedule step groups (drop/retime units for mutation + shrinking) ----

def schedule_groups(sched: Optional[FaultSchedule]) -> list[list]:
    """Pair opener/closer events (partition+heal, kill+revive,
    link_fault+clear) into atomic groups so dropping a fault never
    leaves a dangling heal — the unit of mutation and shrinking."""
    if sched is None:
        return []
    events = sorted(sched.events, key=lambda e: (e.order,))
    claimed: set[int] = set()
    closer_for = {
        "partition": "heal", "kill": "revive",
        "link_fault": "clear_link_fault",
    }
    match_args = {
        "heal": lambda o, c: c.args == o.args,
        "revive": lambda o, c: c.args == o.args,
        "clear_link_fault": lambda o, c: c.args[:2] == o.args[:2],
    }
    groups: list[list] = []
    for i, e in enumerate(events):
        if i in claimed:
            continue
        if e.kind in ("heal", "revive", "clear_link_fault"):
            groups.append([e])  # orphan closer: standalone group
            continue
        group = [e]
        want = closer_for.get(e.kind)
        if want is not None:
            for j in range(i + 1, len(events)):
                c = events[j]
                if (j not in claimed and c.kind == want
                        and match_args[want](e, c)):
                    claimed.add(j)
                    group.append(c)
                    break
        groups.append(group)
    return groups


def _sched_from_groups(seed: int, groups: list[list]) -> Optional[FaultSchedule]:
    flat = [e for g in groups for e in g]
    if not flat:
        return None
    sched = FaultSchedule(seed)
    for e in sorted(flat, key=lambda e: e.order):
        sched.add(e.at, e.kind, *e.args, **dict(e.kwargs))
    return sched


# -- generation -----------------------------------------------------------

_WORKLOAD_KINDS = (
    "payment_flood", "payment_flood", "payment_flood",
    "hot_account_flood", "order_book_crossfire", "fee_gaming",
)


class ScenarioGenerator:
    """Seeded scenario generation + mutation. ONE rng stream drives
    every choice, so a fuzz seed maps to exactly one sequence of
    scenarios regardless of process or PYTHONHASHSEED. ``allow_synth``
    arms the planted-bug fault kind (the smoke's ground truth)."""

    def __init__(self, seed: int = 0, allow_synth: bool = False):
        self.seed = seed
        self.rng = random.Random(0x5CA12C4 ^ seed)
        self.allow_synth = allow_synth
        self.counter = 0

    # -- validity-constrained axis choices --------------------------------

    def _quorum(self, n: int, byz: bool) -> int:
        lo = n // 2 + 1
        if byz:
            # safety under one equivocator: quorum > (n + f) / 2
            lo = max(lo, (n + 1) // 2 + 1)
        hi = max(lo, n - 1)
        return self.rng.randint(lo, hi)

    def _schedule_group(self, rng, n: int, steps: int,
                        protected: tuple = ()) -> list[tuple]:
        """One validity-constrained fault group as (at, kind, args,
        kwargs) tuples. `protected` nids (cold nodes) are never killed —
        the join choreography owns their downtime."""
        kind = rng.choice(
            ("partition", "partition", "kill", "kill", "kill",
             "link_fault", "link_fault", "rotate_kills")
        )
        if kind == "partition":
            nids = list(range(n))
            rng.shuffle(nids)
            cut = rng.randint(1, n - 1)
            a, b = tuple(sorted(nids[:cut])), tuple(sorted(nids[cut:]))
            at = rng.randint(8, max(9, steps - 18))
            heal = at + rng.randint(6, 12)
            return [(at, "partition", (a, b), ()),
                    (heal, "heal", (a, b), ())]
        if kind == "kill":
            victims = [i for i in range(n) if i not in protected]
            nid = rng.choice(victims)
            at = rng.randint(8, max(9, steps - 14))
            rev = at + rng.randint(3, 8)
            return [(at, "kill", (nid,), ()),
                    (rev, "revive", (nid,), ())]
        if kind == "link_fault":
            a = rng.randrange(n)
            b = rng.choice([i for i in range(n) if i != a])
            at = rng.randint(6, max(7, steps - 18))
            until = at + rng.randint(8, 16)
            fault = {}
            # at least one nonzero fault component, all strong enough to
            # leave counter evidence over the window (anti-vacuity)
            roll = rng.random()
            if roll < 0.55:
                fault["drop"] = rng.choice((0.2, 0.35))
            if 0.35 < roll < 0.8:
                fault["dup"] = 0.25
            if roll >= 0.8 or not fault:
                fault["delay_steps"] = rng.randint(1, 2)
                fault["jitter_steps"] = rng.randint(1, 2)
            return [(at, "link_fault", (a, b),
                     tuple(sorted(fault.items()))),
                    (until, "clear_link_fault", (a, b), ())]
        # rotate_kills: staggered non-overlapping kill/revive pairs
        start = rng.randint(10, max(11, steps // 2))
        every = rng.randint(10, 16)
        downtime = rng.randint(3, min(8, every - 2))
        count = rng.randint(2, 3)
        victims = [i for i in range(n) if i not in protected]
        out = []
        at = start
        for _ in range(count):
            nid = rng.choice(victims)
            out.append((at, "kill", (nid,), ()))
            out.append((at + downtime, "revive", (nid,), ()))
            at += every
        return out

    def _attach_overlay_tier(self, rng, scn: Scenario) -> None:
        """Randomize the relay/squelch/resource/flooder tier onto a
        scenario (shared by fresh() and the compose_axis mutation so
        the two sampling sites can never drift apart)."""
        scn.n_peers = rng.randint(12, 40)
        scn.squelch_size = rng.choice((4, 6, 8))
        scn.squelch_rotate = rng.choice((3, 8, 16))
        scn.resources = True
        if rng.random() < 0.5:
            scn.flooders = {0: {
                "burst": rng.randint(4, 8),
                "fan": rng.randint(8, 16),
            }}

    def _materialize(self, seed: int, raw: list[tuple]) -> FaultSchedule:
        sched = FaultSchedule(seed)
        for at, kind, args, kwargs in raw:
            sched.add(at, kind, *args, **dict(kwargs))
        return sched

    def fresh(self) -> Scenario:
        """One new validity-constrained random scenario."""
        rng = self.rng
        self.counter += 1
        cold = rng.random() < 0.10
        n = rng.choice((5, 6)) if cold else rng.choice((4, 5, 6))
        byz = (not cold) and rng.random() < 0.22
        steps = rng.randint(44, 68)
        # quorum over the FULL validator count — a cold node is down,
        # not absent, and a sub-majority quorum lets two disjoint
        # quorums validate different ledgers at one seq (the fuzzer
        # demonstrated exactly that with 3-of-6)
        quorum = self._quorum(n, byz)

        kind = rng.choice(_WORKLOAD_KINDS)
        wl_n = rng.randint(24, 52)
        workload = {"kind": kind, "n": wl_n}
        txq_cap = None
        if kind == "fee_gaming":
            workload["end_margin"] = 30
            txq_cap = rng.randint(4, 8)
        elif rng.random() < 0.12:
            txq_cap = rng.randint(5, 9)

        scn = Scenario(
            name=f"fuzz-{self.seed}-{self.counter}",
            seed=rng.randrange(1 << 16),
            n_validators=n, quorum=quorum, steps=steps,
            workload=workload, txq_cap=txq_cap,
            max_tail_steps=280,
        )
        if byz:
            k = rng.randint(1, len(BEHAVIORS))
            scn.byzantine = {
                n - 1: tuple(sorted(rng.sample(BEHAVIORS, k)))
            }
        if cold:
            scn.cold_nodes = (n - 1,)
            scn.join_at = rng.randint(steps // 3, steps // 2)
            scn.segments = True
            scn.max_tail_steps = 320
            if rng.random() < 0.40:
                # history-shard axis: serving validators trim-then-tier
                # the early chain into shards BEFORE the cold node
                # joins, so the sync crosses the cold-storage boundary
                # under whatever faults this schedule carries
                scn.shards = True
                scn.shard_trim_seq = rng.randint(3, 6)
                # archive-tier axis: derived from the
                # already-drawn scenario seed rather than a fresh rng
                # draw, so the generator's stream — and every
                # previously generated scenario — stays bit-identical.
                # ~1 in 4 shard runs also backfill a synthetic archive
                # from the sealed tier and byte-match its answers.
                if scn.seed & 0x3 == 0x1:
                    scn.archive = True
        if not cold and not byz and rng.random() < 0.18:
            self._attach_overlay_tier(rng, scn)
        if rng.random() < 0.15:
            scn.n_followers = 1
        # sharded hash-plane axis: derived from the already-
        # drawn scenario seed rather than a fresh rng draw, so adding
        # the axis leaves the generator's existing stream — and every
        # previously generated scenario — bit-identical. ~1 in 16 runs
        # route honest tree hashing through the meshed device hasher.
        if scn.seed & 0xF == 0:
            scn.mesh_width = (2, 4, 8)[(scn.seed >> 4) % 3]
        # liquidity-plane axis: seed-derived like the mesh
        # axis (the generator's rng stream stays bit-identical). ~1 in
        # 8 runs ride 2-5 synthetic path subscriptions on the watch
        # validator — per-close index identity + budgeted re-ranking
        # under whatever faults this schedule carries.
        if scn.seed & 0x7 == 0x3:
            scn.path_subs = 2 + ((scn.seed >> 3) & 0x3)
        # cascading-follower-tree axis: seed-derived like
        # the mesh/path axes, so the generator's rng stream — and every
        # previously generated scenario — stays bit-identical. ~1 in 8
        # runs grow a 3-6 follower tier arranged as a branching-2/3
        # tree (squelched so validations cascade through it): upstream
        # acquisition, re-home on mid-tree death, and byte-identical
        # reconvergence under whatever faults this schedule carries.
        if scn.seed & 0x7 == 0x5:
            scn.n_followers = max(scn.n_followers,
                                  3 + ((scn.seed >> 3) & 0x3))
            scn.follower_branching = 2 + ((scn.seed >> 5) & 0x1)
            if not scn.squelch_size:
                scn.squelch_size = 4

        raw: list[tuple] = []
        hostile = n - 1 if (byz or cold) else None
        protected = (hostile,) if cold else ()
        for _ in range(rng.randint(1, 3)):
            raw.extend(self._schedule_group(rng, n, steps, protected))
        if self.allow_synth and rng.random() < 0.4:
            for _ in range(rng.randint(1, 2)):
                raw.append((
                    rng.randint(4, steps - 4), "synth_plant",
                    (rng.randint(1, 2),), (),
                ))
        scn.schedule = self._materialize(scn.seed, raw)
        return scn

    def mutate(self, parent: Scenario) -> Scenario:
        """1-2 structure-preserving edits on a pool scenario."""
        rng = self.rng
        self.counter += 1
        scn = Scenario.from_json(parent.to_json())
        scn.name = f"fuzz-{self.seed}-{self.counter}"
        for _ in range(rng.randint(1, 2)):
            op = rng.choice((
                "reseed", "resize_workload", "retime", "add_group",
                "add_group", "drop_group", "resteps", "compose_axis",
            ))
            groups = schedule_groups(scn.schedule)
            if op == "reseed":
                scn.seed = rng.randrange(1 << 16)
            elif op == "resize_workload" and scn.workload:
                wl = dict(scn.workload)
                wl["n"] = max(8, int(wl["n"] * rng.choice((0.7, 1.4))))
                scn.workload = wl
            elif op == "retime" and groups:
                gi = rng.randrange(len(groups))
                shift = rng.choice((-6, -3, 3, 6))
                # clamp the SHIFT, not the events: independent clamping
                # could collapse a group (kill and revive on one step)
                # or push an opener past the horizon where the main
                # loop never applies it — an armed-but-dead fault the
                # anti-vacuity invariant would then (rightly) flag
                lo = min(e.at for e in groups[gi])
                opener_ats = [
                    e.at for e in groups[gi]
                    if e.kind not in ("heal", "revive",
                                      "clear_link_fault")
                ] or [lo]
                opener_hi = max(opener_ats)
                shift = max(shift, 2 - lo)
                shift = min(shift, (scn.steps - 4) - opener_hi)
                shifted = []
                for g_idx, g in enumerate(groups):
                    for e in g:
                        at = e.at + shift if g_idx == gi else e.at
                        shifted.append((at, e.kind, e.args, e.kwargs))
                sched = FaultSchedule(scn.seed)
                for at, kind, args, kwargs in shifted:
                    sched.add(at, kind, *args, **dict(kwargs))
                scn.schedule = sched
            elif op == "add_group":
                protected = scn.cold_nodes
                raw = self._schedule_group(
                    rng, scn.n_validators, scn.steps, protected
                )
                if self.allow_synth and rng.random() < 0.35:
                    raw.append((
                        rng.randint(4, scn.steps - 4), "synth_plant",
                        (rng.randint(1, 2),), (),
                    ))
                sched = scn.schedule or FaultSchedule(scn.seed)
                for at, kind, args, kwargs in raw:
                    sched.add(at, kind, *args, **dict(kwargs))
                scn.schedule = sched
            elif op == "drop_group" and len(groups) > 1:
                gi = rng.randrange(len(groups))
                scn.schedule = _sched_from_groups(
                    scn.seed, groups[:gi] + groups[gi + 1:]
                )
            elif op == "resteps":
                floor = max(
                    (e.at for e in _events_of(scn)), default=20
                ) + 10
                scn.steps = max(floor, scn.steps + rng.choice((-8, 8)))
            elif op == "compose_axis":
                # the exploration edge over uniform generation: COMPOSE
                # a hostile axis onto a scenario that already reached a
                # novel state — uniform sampling rarely stacks tiers,
                # mutation of a proven parent does it deliberately
                axis = rng.choice(
                    ("byzantine", "follower", "overlay", "txq")
                )
                if axis == "byzantine" and not scn.cold_nodes:
                    if scn.byzantine:
                        scn.byzantine = {}
                    else:
                        k = rng.randint(1, len(BEHAVIORS))
                        scn.byzantine = {
                            scn.n_validators - 1:
                            tuple(sorted(rng.sample(BEHAVIORS, k)))
                        }
                        scn.quorum = max(
                            scn.quorum,
                            (scn.n_validators + 1) // 2 + 1,
                        )
                elif axis == "follower":
                    scn.n_followers = 0 if scn.n_followers else 1
                elif axis == "overlay" and not scn.byzantine \
                        and not scn.cold_nodes:
                    if scn.n_peers or scn.resources:
                        scn.n_peers = 0
                        scn.squelch_size = 0
                        scn.resources = False
                        scn.flooders = {}
                    else:
                        self._attach_overlay_tier(rng, scn)
                elif axis == "txq" and scn.workload is not None:
                    scn.txq_cap = (
                        None if scn.txq_cap else rng.randint(4, 9)
                    )
        return scn


# -- shrinking ------------------------------------------------------------

def _weaken_ops(scn: Scenario) -> list[tuple[str, Scenario]]:
    """Candidate single-axis weakenings of a failing scenario, each a
    (label, new scenario) pair. Only applicable ones are returned."""
    out: list[tuple[str, Scenario]] = []

    def clone() -> Scenario:
        return Scenario.from_json(scn.to_json())

    ev_max = max((e.at for e in _events_of(scn)), default=0)
    floor = ev_max + 12
    if scn.steps > floor:
        c = clone()
        c.steps = floor
        out.append(("shrink_steps", c))
    if scn.workload is not None:
        c = clone()
        c.workload = None
        c.txq_cap = None
        out.append(("drop_workload", c))
        if scn.workload.get("n", 0) > 8:
            c = clone()
            wl = dict(c.workload)
            wl["n"] = max(8, int(wl["n"] * 0.5))
            c.workload = wl
            out.append(("halve_workload", c))
    if scn.txq_cap is not None and scn.workload is not None:
        c = clone()
        c.txq_cap = None
        out.append(("drop_txq", c))
    if scn.n_peers or scn.squelch_size or scn.resources or scn.flooders:
        c = clone()
        c.n_peers = 0
        c.squelch_size = 0
        c.resources = False
        c.flooders = {}
        out.append(("drop_overlay_tier", c))
    if scn.n_followers:
        c = clone()
        c.n_followers = 0
        out.append(("drop_followers", c))
    if getattr(scn, "follower_branching", 0):
        # flatten the cascade but keep the tier: isolates tree
        # plumbing (upstream acquisition / re-home) from plain
        # follower ingest as the failing axis
        c = clone()
        c.follower_branching = 0
        out.append(("drop_follower_tree", c))
    if getattr(scn, "mesh_width", 0):
        c = clone()
        c.mesh_width = 0
        out.append(("drop_mesh", c))
    if getattr(scn, "path_subs", 0):
        c = clone()
        c.path_subs = 0
        out.append(("drop_path_subs", c))
    if scn.byzantine:
        c = clone()
        c.byzantine = {}
        out.append(("drop_byzantine", c))
        for nid, behaviors in sorted(scn.byzantine.items()):
            if len(behaviors) > 1:
                for b in behaviors:
                    c = clone()
                    bs = tuple(x for x in behaviors if x != b)
                    c.byzantine = {**scn.byzantine, nid: bs}
                    out.append((f"drop_behavior:{b}", c))
    if getattr(scn, "archive", False):
        # keep the shard tier but drop the archive backfill: isolates
        # the distribution-network leg from the cold-sync leg
        c = clone()
        c.archive = False
        out.append(("drop_archive", c))
    if getattr(scn, "shards", False):
        c = clone()
        c.shards = False
        c.shard_trim_seq = 0
        c.archive = False
        out.append(("drop_shard_tier", c))
    if scn.cold_nodes:
        c = clone()
        c.cold_nodes = ()
        c.segments = False
        c.garbage_server = None
        c.kill_server_at = None
        c.shards = False
        c.shard_trim_seq = 0
        c.archive = False
        out.append(("drop_cold_node", c))
    # per-event weakenings: plant magnitude down, fault probs halved
    for i, e in enumerate(_events_of(scn)):
        if e.kind == "synth_plant" and e.args[0] > 1:
            c = clone()
            evs = list(c.schedule.events)
            evs[i] = type(e)(e.at, e.order, e.kind,
                             (e.args[0] - 1,), e.kwargs)
            c.schedule.events = evs
            out.append((f"weaken_plant:{i}", c))
        elif e.kind == "link_fault":
            kw = dict(e.kwargs)
            changed = False
            for key in ("drop", "dup"):
                if kw.get(key, 0) > 0.1:
                    kw[key] = round(kw[key] / 2, 3)
                    changed = True
            if changed:
                c = clone()
                evs = list(c.schedule.events)
                evs[i] = type(e)(e.at, e.order, e.kind, e.args,
                                 tuple(sorted(kw.items())))
                c.schedule.events = evs
                out.append((f"weaken_link_fault:{i}", c))
    return out


def _runner(run_fn: Optional[Callable[[Scenario], dict]], device,
            devices) -> Callable[[Scenario], dict]:
    """`run_fn`, or ``run_simnet`` on `device`/`devices` when None."""
    if run_fn is not None:
        return run_fn
    return lambda scn: run_simnet(scn, device=device, devices=devices)


def shrink_scenario(
    scn: Scenario,
    violation: Violation,
    run_fn: Optional[Callable[[Scenario], dict]] = None,
    max_runs: int = 80,
    device="cuda",
    devices=None,
) -> tuple[Scenario, list[dict]]:
    """Greedy schedule shrinking: repeatedly (a) drop whole fault
    groups, (b) weaken one axis, keeping any edit under which the SAME
    invariant still fires, until a fixpoint or the run budget. Returns
    (minimal scenario, trajectory); the trajectory is deterministic for
    a deterministic run_fn (pinned by test). Without `run_fn` each
    candidate runs through ``run_simnet`` on `device`/`devices`."""
    run_fn = _runner(run_fn, device, devices)
    runs = 0
    trajectory: list[dict] = []

    def reproduces(cand: Scenario) -> bool:
        nonlocal runs
        runs += 1
        card = run_fn(cand)
        recard = run_fn(cand) if violation.invariant == "determinism" \
            else None
        viols = check_invariants(cand, card, recard)
        return any(v.invariant == violation.invariant for v in viols)

    cur = scn
    outer = True
    while outer and runs < max_runs:
        outer = False
        # pass A: drop whole fault groups, first-fit, restart on success
        progress = True
        while progress and runs < max_runs:
            progress = False
            groups = schedule_groups(cur.schedule)
            if len(groups) <= 1 and cur.workload is None:
                break
            for gi in range(len(groups)):
                cand = Scenario.from_json(cur.to_json())
                cand.schedule = _sched_from_groups(
                    cand.seed, groups[:gi] + groups[gi + 1:]
                )
                ok = reproduces(cand)
                trajectory.append({
                    "op": f"drop_group:{gi}", "kept": ok,
                    "digest": cand.digest(),
                })
                if ok:
                    cur = cand
                    progress = True
                    outer = True
                    break
        # pass B: single-axis weakenings, first-fit
        progress = True
        while progress and runs < max_runs:
            progress = False
            for label, cand in _weaken_ops(cur):
                ok = reproduces(cand)
                trajectory.append({
                    "op": label, "kept": ok, "digest": cand.digest(),
                })
                if ok:
                    cur = cand
                    progress = True
                    outer = True
                    break
    return cur, trajectory


# -- corpus ---------------------------------------------------------------

def corpus_entry(scn: Scenario, violation: Violation,
                 found: dict, expect: str = "pass",
                 flight_dump: Optional[str] = None) -> dict:
    """A corpus entry: the shrunk data-form scenario plus provenance.
    `expect` records the entry's contract under replay — "pass" for a
    fixed bug pinned as a regression, "violation" for a live repro
    (only the planted synthetic bug ships that way, and only inside
    the armed smoke). `flight_dump` references the violating run's
    flight-recorder black box on disk (node/health.py)."""
    name = f"fuzz_{violation.invariant}_{scn.digest()[:8]}"
    entry = {
        "corpus_format": 1,
        "name": name,
        "invariant": violation.invariant,
        "detail": violation.detail,
        "found": found,
        "expect": expect,
        "scenario": scn.to_json(),
    }
    if flight_dump:
        entry["flight_dump"] = flight_dump
    return entry


def _dump_violation_flight(scn: Scenario, violation: Violation) -> Optional[str]:
    """Ship the violating run's black box (the most recent run_simnet's
    FlightRecorder) to a stable temp location; -> path or None."""
    from .scenario import LAST_FLIGHT

    rec = LAST_FLIGHT[0] if LAST_FLIGHT else None
    if rec is None:
        return None
    import tempfile

    d = os.path.join(tempfile.gettempdir(), "stellard-flight")
    return rec.dump(
        f"fuzz-{violation.invariant}-{scn.digest()[:8]}", directory=d
    )


def write_corpus_entry(entry: dict, corpus_dir: str) -> str:
    os.makedirs(corpus_dir, exist_ok=True)
    path = os.path.join(corpus_dir, f"{entry['name']}.json")
    with open(path, "w") as f:
        json.dump(entry, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


# -- the sweep ------------------------------------------------------------

_ENERGY_NOVEL = 8
_ENERGY_REWARD = 4


def _pick_weighted(pool: list[dict], rng: random.Random) -> dict:
    total = sum(p["energy"] for p in pool)
    x = rng.random() * total
    acc = 0.0
    for p in pool:
        acc += p["energy"]
        if x <= acc:
            return p
    return pool[-1]


def sweep(
    fuzz_seed: int,
    n_runs: int,
    guided: bool = True,
    allow_synth: bool = False,
    shrink: bool = True,
    determinism_check: bool = True,
    run_fn: Optional[Callable[[Scenario], dict]] = None,
    on_progress: Optional[Callable[[dict], None]] = None,
    max_shrink_runs: int = 80,
    device="cuda",
    devices=None,
) -> dict:
    """One coverage-guided fuzz sweep: `n_runs` generated scenarios
    through `run_fn`, the coverage map biasing generation toward
    schedules reaching novel scorecard states (AFL-style energy over a
    pool of novelty-reaching parents; `guided=False` = uniform random
    generation, the baseline the smoke compares against). Novel-state
    scenarios are re-run for the byte-identical-scorecard invariant
    when `determinism_check`. Every invariant violation is (optionally)
    shrunk to a minimal scenario. Deterministic: the returned
    `scenario_digests`, `coverage_trajectory`, and every shrink
    trajectory are pure functions of (fuzz_seed, flags). Without
    `run_fn` every scenario runs through ``run_simnet`` on
    `device`/`devices`."""
    run_fn = _runner(run_fn, device, devices)
    was_armed = SYNTH_BUG["armed"]
    if allow_synth:
        SYNTH_BUG["armed"] = True
    try:
        gen = ScenarioGenerator(fuzz_seed, allow_synth=allow_synth)
        pool: list[dict] = []
        seen: dict[str, int] = {}
        scenario_digests: list[str] = []
        coverage_trajectory: list[str] = []
        violations: list[dict] = []
        for i in range(n_runs):
            parent = None
            if guided and pool and gen.rng.random() >= 0.3:
                parent = _pick_weighted(pool, gen.rng)
                scn = gen.mutate(Scenario.from_json(parent["scenario"]))
            else:
                scn = gen.fresh()
            card = run_fn(scn)
            sig = coverage_signature(card)
            scenario_digests.append(scn.digest())
            coverage_trajectory.append(sig)
            novel = sig not in seen
            recard = None
            if novel:
                seen[sig] = i
                if determinism_check:
                    recard = run_fn(scn)
                if guided:
                    pool.append({
                        "scenario": scn.to_json(),
                        "energy": _ENERGY_NOVEL,
                    })
                    if parent is not None:
                        parent["energy"] += _ENERGY_REWARD
            elif parent is not None:
                parent["energy"] = max(1, parent["energy"] - 1)
            viols = check_invariants(scn, card, recard)
            flight_path = (
                _dump_violation_flight(scn, viols[0]) if viols else None
            )
            # one record per invariant CLASS per run: recording only
            # the first would let an armed synth_plant violation (always
            # ordered first) mask a co-occurring REAL violation from
            # the smoke's any-real-violation-is-red gate
            seen_kinds: set = set()
            for v in viols:
                if v.invariant in seen_kinds:
                    continue
                seen_kinds.add(v.invariant)
                rec = {
                    "iteration": i,
                    "invariant": v.invariant,
                    "detail": v.detail,
                    "scenario": scn.to_json(),
                }
                if flight_path:
                    rec["flight_dump"] = flight_path
                # shrink budget: one full shrink per invariant NAME per
                # sweep — later repros of the same class are recorded
                # raw (the first minimal entry is the regression pin)
                first_of_kind = v.invariant not in {
                    x["invariant"] for x in violations
                }
                if shrink and first_of_kind:
                    minimal, traj = shrink_scenario(
                        scn, v, run_fn=run_fn,
                        max_runs=max_shrink_runs,
                    )
                    rec["shrunk"] = minimal.to_json()
                    rec["shrink_trajectory"] = traj
                    rec["entry"] = corpus_entry(
                        minimal, v,
                        found={"fuzz_seed": fuzz_seed, "iteration": i},
                        expect="pass",
                        flight_dump=flight_path,
                    )
                violations.append(rec)
            if on_progress is not None:
                on_progress({
                    "iteration": i, "novel": novel, "signature": sig,
                    "violations": len(violations),
                    "scenario": scn.name,
                })
        return {
            "fuzz_seed": fuzz_seed,
            "runs": n_runs,
            "guided": guided,
            "distinct_signatures": len(seen),
            "scenario_digests": scenario_digests,
            "coverage_trajectory": coverage_trajectory,
            "violations": violations,
        }
    finally:
        SYNTH_BUG["armed"] = was_armed


def coverage_comparison(
    fuzz_seed: int, n_runs: int,
    run_fn: Optional[Callable[[Scenario], dict]] = None,
    on_progress: Optional[Callable[[dict], None]] = None,
    device="cuda",
    devices=None,
) -> dict:
    """Coverage-guided vs uniform random generation over the same
    budget (the novelty-bias criterion): distinct scorecard
    coverage states per N runs, same fuzz seed, no shrinking and no
    determinism re-runs so the comparison is purely about generation."""
    run_fn = _runner(run_fn, device, devices)
    guided = sweep(
        fuzz_seed, n_runs, guided=True, shrink=False,
        determinism_check=False, run_fn=run_fn,
        on_progress=on_progress,
    )
    uniform = sweep(
        fuzz_seed, n_runs, guided=False, shrink=False,
        determinism_check=False, run_fn=run_fn,
        on_progress=on_progress,
    )
    return {
        "runs": n_runs,
        "guided_distinct": guided["distinct_signatures"],
        "uniform_distinct": uniform["distinct_signatures"],
        "guided_violations": len(guided["violations"]),
        "uniform_violations": len(uniform["violations"]),
    }
