"""The scenario matrix (doc/scenarios.md): the adversarial shapes the
project's roadmap names, as parameterized builders, plus the permanent
minimal-repro corpus the fuzz plane (testkit/search.py) maintains.
``build_scenario`` is the single entry the smokes, the tests, the fuzz
harness and the bench leg share — matrix names first, then corpus
entries (each a shrunk, replayable scenario checked in under
``testkit/corpus/``).

(a) partition_kills   partitions healing on schedule + rotating
                      validator kills, under payment flood
(b) byzantine         a trusted-but-hostile validator emitting
                      equivocations, forged/stale validations,
                      oversized txsets and malformed frames
(c) cold_catchup      a node joining mid-flood syncs via the segment
                      bulk path; the first server serves garbage, the
                      second is killed mid-sync
(d) hostile workloads hot_account / order_books / fee_gaming
(e) fan-in/read axes  flood_survival, squelch-rotation-vs-flood,
                      chaos under spec workers, follower-under-
                      partition, cascading follower tree with a
                      mid-tree kill (follower_tree)

Every matrix scenario is DATA-form (``schedule=``/``workload=`` rather
than closures), so each round-trips losslessly through
``Scenario.to_json`` — the property the shrinker and the corpus build
on.
"""

from __future__ import annotations

import json
import os

from .schedule import FaultSchedule
from .scenario import Scenario

__all__ = [
    "MATRIX", "build_scenario", "CORPUS_DIR", "load_corpus",
    "corpus_scenarios",
]


def scenario_partition_kills(seed: int = 0) -> Scenario:
    # an even split that must stall (safety), healing on schedule,
    # then rotating single-validator kills under continuing flood
    sched = FaultSchedule(seed)
    sched.partition(14, {0, 1}, {2, 3, 4}, heal_at=26)
    sched.rotate_kills(range(5), start=34, every=12, downtime=5, count=3)
    return Scenario(
        name="partition_kills", seed=seed, n_validators=5, quorum=3,
        steps=80,
        schedule=sched,
        workload={"kind": "payment_flood", "n": 60},
    )


def scenario_chaos(seed: int = 0, steps: int = 120,
                   kill_every: int = 40, downtime: int = 5) -> Scenario:
    """Rotating validator kills under continuous flood — the pre-graft
    chaos-soak shape, now ONE definition driven through BOTH transports
    (testkit.tcpnet.run_tcp runs it on the real TCP net; the smoke
    and the matrix run it deterministically on the simnet)."""
    kills = max(1, (steps - 20) // kill_every)
    sched = FaultSchedule(seed)
    sched.rotate_kills(
        range(4), start=14, every=kill_every, downtime=downtime,
        count=kills,
    )
    return Scenario(
        name="chaos", seed=seed, n_validators=4, quorum=3,
        steps=steps,
        schedule=sched,
        workload={"kind": "payment_flood", "n": max(24, steps // 2)},
        transports=("simnet", "tcp"),
    )


def scenario_chaos_spec2(seed: int = 0) -> Scenario:
    """Chaos with [spec] workers=2 thread pools on every honest
    validator (the workers>1-under-fire axis as a permanent matrix
    leg; chip_smoke.py's scenarios phase gates hash identity against
    the serial run of the same seed)."""
    scn = scenario_chaos(seed)
    scn.name = "chaos_spec2"
    scn.spec_workers = 2
    scn.transports = ("simnet",)
    return scn


def scenario_byzantine(seed: int = 0) -> Scenario:
    return Scenario(
        name="byzantine", seed=seed, n_validators=4, quorum=3,
        steps=70,
        byzantine={3: (
            "equivocate", "duplicate", "forge", "stale", "garbage",
            "oversized",
        )},
        workload={"kind": "payment_flood", "n": 40},
    )


def scenario_cold_catchup(seed: int = 0) -> Scenario:
    return Scenario(
        name="cold_catchup", seed=seed, n_validators=5, quorum=3,
        steps=90,
        cold_nodes=(4,), join_at=40,
        segments=True, segment_bytes=65536,
        garbage_server=0,       # first pick serves garbage → per-peer
        kill_server_at=44,      # fallback, then the next server dies
                                # right as the transfer lands on it
        workload={"kind": "payment_flood", "n": 70},
        max_tail_steps=300,
    )


def scenario_shard_cold_catchup(seed: int = 0) -> Scenario:
    """The trim-then-tier leg (doc/storage.md): serving validators
    rotate every pre-floor ledger out of their live segstores into
    sealed history shards BEFORE the cold node joins, so the joiner
    must sync that range entirely from cold storage over the combined
    GetSegments manifest."""
    return Scenario(
        name="shard_cold_catchup", seed=seed, n_validators=5, quorum=3,
        steps=90,
        cold_nodes=(4,), join_at=50,
        segments=True, segment_bytes=65536,
        shards=True, shard_trim_seq=6,
        workload={"kind": "payment_flood", "n": 70},
        max_tail_steps=300,
    )


def scenario_archive_backfill(seed: int = 0) -> Scenario:
    """The archive-tier leg: on top of the trim-then-tier
    shape, a synthetic archive node backfills every sealed shard from
    the serving validators over the shard distribution network and
    byte-matches its served history against the sealed contents.
    garbage_server=0 makes the first-pick peer serve corrupted bytes,
    so the leg ALSO exercises verify-gated rejection + condemnation +
    refetch-elsewhere before the byte-match sweep runs."""
    return Scenario(
        name="archive_backfill", seed=seed, n_validators=5, quorum=3,
        steps=90,
        cold_nodes=(4,), join_at=50,
        segments=True, segment_bytes=65536,
        shards=True, shard_trim_seq=6,
        archive=True,
        garbage_server=0,
        workload={"kind": "payment_flood", "n": 70},
        max_tail_steps=300,
    )


def scenario_hot_account(seed: int = 0) -> Scenario:
    return Scenario(
        name="hot_account", seed=seed, n_validators=4, quorum=3,
        steps=60,
        workload={"kind": "hot_account_flood", "n": 80},
    )


def scenario_order_books(seed: int = 0) -> Scenario:
    return Scenario(
        name="order_books", seed=seed, n_validators=4, quorum=3,
        steps=70,
        workload={"kind": "order_book_crossfire", "n": 60},
    )


def scenario_follower_partition(seed: int = 0) -> Scenario:
    """Follower-attached-under-partition (the read-plane
    axis): one follower node (nid 4) tails a 4-validator net under
    flood; mid-run the follower is partitioned away from every
    validator, then a validator dies and revives while the follower is
    still dark, then the partition heals — the follower must re-sync
    and end on the honest chain (scorecard `followers.synced`)."""
    sched = FaultSchedule(seed)
    sched.partition(18, {4}, {0, 1, 2, 3}, heal_at=38)
    sched.kill(24, 1, revive_at=30)
    return Scenario(
        name="follower_partition", seed=seed, n_validators=4, quorum=3,
        steps=64, n_followers=1,
        schedule=sched,
        workload={"kind": "payment_flood", "n": 48},
    )


def scenario_follower_tree(seed: int = 0) -> Scenario:
    """Cascading follower tree under mid-tree death: six
    followers arranged as a branching-2 tree over a 4-validator core
    (followers 0-1 dial the leader tier, 2-3 hang off follower 0, 4-5
    off follower 1), squelched relay so validations cascade through
    the tier, payment flood running — then the mid-tree follower 0
    (nid 4) DIES under load and revives late. Its downstream subtree
    must re-home up the tree (`followers.tree.rehomed` > 0) and every
    follower must reconverge byte-identical to the honest chain
    (`followers.synced`), with leader fan-out still bounded by the
    squelch subset, never the follower count."""
    sched = FaultSchedule(seed)
    sched.kill(24, 4, revive_at=40)
    return Scenario(
        name="follower_tree", seed=seed, n_validators=4, quorum=3,
        steps=64, n_followers=6, follower_branching=2,
        squelch_size=4,
        schedule=sched,
        workload={"kind": "payment_flood", "n": 48},
    )


def scenario_flood_survival(
    seed: int = 0,
    n_peers: int = 495,
    squelch: int = 8,
    flooder: bool = True,
    steps: int = 48,
) -> Scenario:
    """Overlay at production fan-in: a 5-validator core plus
    an n_peers relay tier (500 nodes at the default), squelched
    validator-message relay, enforced resource pricing on every honest
    node, and one hostile relay peer flooding garbage + duplicates +
    junk txs. The gate: honest validators
    converge on ONE hash, the flooder's endpoint reaches DROP at the
    nodes it floods and is refused readmission (`resource.*`
    counters), relay fan-out stays <= squelch + |UNL| (never the peer
    count), and close cadence holds within budget of the
    ``flooder=False`` run of the same seed."""
    return Scenario(
        name="flood_survival" if flooder else "flood_baseline",
        seed=seed, n_validators=5, quorum=4, steps=steps,
        n_peers=n_peers, squelch_size=squelch, resources=True,
        flooders=(
            {0: {"burst": 8, "fan": 24}} if flooder else {}
        ),
        workload={"kind": "payment_flood", "n": 30},
        max_tail_steps=160,
    )


def scenario_squelch_rotation_flood(seed: int = 0) -> Scenario:
    """Squelching-vs-byzantine-flood (the fan-in plane's rotation
    axis): the flood_survival shape with the squelch epoch rotating
    MID-FLOOD (rotate=3 → several epochs inside one run) — the
    rotating relay subsets must keep the fan-out bound while the
    relay-tier flooder hammers its neighbor set, and enforcement (DROP +
    refusal) must survive the subset churn."""
    return Scenario(
        name="squelch_rotation_flood", seed=seed,
        n_validators=5, quorum=4, steps=60,
        n_peers=59, squelch_size=6, squelch_rotate=3, resources=True,
        flooders={0: {"burst": 8, "fan": 20}},
        workload={"kind": "payment_flood", "n": 30},
        max_tail_steps=160,
    )


def scenario_mesh_hash(seed: int = 0) -> Scenario:
    """Sharded crypto plane under faults: partitions +
    a kill while every honest validator's tree hashing routes through
    the mesh-enabled device hasher (forced-device, width clamped to
    visible devices — width 1 on a 1-device box is the same routed
    plane). The invariants are the usual convergence/single-hash set:
    a sharded hasher that produced different bytes would fork the net
    on the spot, so chaos coverage IS the identity gate."""
    sched = FaultSchedule(seed)
    sched.partition(10, {0, 1}, {2, 3}, heal_at=20)
    sched.kill(28, 3, revive_at=34)
    scn = Scenario(
        name="mesh_hash", seed=seed, n_validators=4, quorum=3,
        steps=56,
        schedule=sched,
        workload={"kind": "payment_flood", "n": 28},
    )
    scn.mesh_width = 8
    return scn


def scenario_fee_gaming(seed: int = 0) -> Scenario:
    return Scenario(
        name="fee_gaming", seed=seed, n_validators=4, quorum=3,
        steps=96,
        txq_cap=6,
        # flood ends ~36 steps before the horizon: the queue must DRAIN
        # in fee order (the fairness checks judge the drained outcome)
        workload={"kind": "fee_gaming", "n": 70, "end_margin": 36},
    )


MATRIX = {
    "partition_kills": scenario_partition_kills,
    "chaos": scenario_chaos,
    "chaos_spec2": scenario_chaos_spec2,
    "byzantine": scenario_byzantine,
    "cold_catchup": scenario_cold_catchup,
    "shard_cold_catchup": scenario_shard_cold_catchup,
    "archive_backfill": scenario_archive_backfill,
    "hot_account": scenario_hot_account,
    "order_books": scenario_order_books,
    "follower_partition": scenario_follower_partition,
    "follower_tree": scenario_follower_tree,
    "mesh_hash": scenario_mesh_hash,
    "fee_gaming": scenario_fee_gaming,
    "flood_survival": scenario_flood_survival,
    "squelch_rotation_flood": scenario_squelch_rotation_flood,
}

# -- the minimal-repro corpus (testkit/corpus/*.json) ---------------------
#
# Every entry is a shrunk scenario the fuzz plane (or a human triaging
# one of its finds) checked in: {"name", "invariant", "detail",
# "found" provenance, "expect" ("pass" once the bug is fixed), and the
# full data-form "scenario"}. They load through build_scenario like any
# matrix name and replay as permanent regressions in the fuzz smoke.

CORPUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "corpus")


def load_corpus(corpus_dir: str | None = None) -> dict[str, dict]:
    """name -> corpus entry dict, sorted by filename (deterministic
    replay order). Missing directory = empty corpus."""
    d = corpus_dir or CORPUS_DIR
    out: dict[str, dict] = {}
    if not os.path.isdir(d):
        return out
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(d, fn)) as f:
            entry = json.load(f)
        if entry["name"] in out:
            # two files carrying one name would silently shadow a
            # checked-in regression out of the replay gate
            raise ValueError(
                f"duplicate corpus entry name {entry['name']!r} "
                f"(file {fn})"
            )
        out[entry["name"]] = entry
    return out


def corpus_scenarios(corpus_dir: str | None = None) -> dict[str, "Scenario"]:
    return {
        name: Scenario.from_json(entry["scenario"])
        for name, entry in load_corpus(corpus_dir).items()
    }


def build_scenario(name: str, seed: int = 0) -> Scenario:
    if name in MATRIX:
        return MATRIX[name](seed)
    entry = load_corpus().get(name)
    if entry is not None:
        # corpus scenarios carry their own pinned seed — the repro IS
        # the data; the seed argument does not apply
        return Scenario.from_json(entry["scenario"])
    raise KeyError(name)
