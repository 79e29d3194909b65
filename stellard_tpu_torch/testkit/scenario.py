"""Scenario runner + per-scenario scorecard.

A ``Scenario`` is pure data (validators, fault schedule builder,
workload builder, byzantine slots, catch-up/admission knobs). The
simnet runner replays it deterministically: one seed → one fault
schedule → one scorecard, byte-identical across runs (pinned by test
and by chip_smoke.py's scenarios phase). The TCP runner
(testkit.tcpnet.run_tcp) drives
the kill/revive + flood subset of the same definitions against real
processes.

Scorecard fields (doc/scenarios.md):

    converged / tail_steps / final_seq / final_hash / single_hash
    validated_seqs   per-validator validated seq at the end
    submitted / committed / commit_rate
    splice           delta-replay spliced/fallback/invalidated (summed
                     over honest validators)
    byzantine        defense counters summed over honest validators
    byzantine_emitted  what the hostile slots actually sent (anti-vacuity)
    degraded_transitions  honest proposing→tracking→proposing flips
    catchup          cold-node segment-path counters + synced flag
    txq              admission stats + fairness verdicts (fee-order
                     drain, no-starvation, replace-by-fee)
    net              transport-level sent/dropped/duplicated/delayed
    fault_digest     digest of the replayed fault schedule
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field as dc_field, fields as dc_fields
from typing import Callable, Optional

from ..engine.engine import TxParams
from ..overlay.simnet import SimNet
from ..overlay.wire import frame
from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from .schedule import FaultSchedule
from .workloads import TxFactory, build_spec_workload

__all__ = [
    "Scenario", "run_simnet", "apply_event", "SYNTH_BUG",
    "ARCHIVE_CORRUPT", "LAST_FLIGHT",
]

# the most recent run's flight recorder (node/health.py FlightRecorder,
# fed by the scorecard health watchdog): the search plane dumps it next
# to a corpus entry when a run violates invariants, so every repro
# ships its black box. Single-slot list — never enters the scorecard.
LAST_FLIGHT: list = []

# Test-only planted bug (the fuzz gate's ground truth): while armed,
# every replayed `synth_plant` fault event accumulates its magnitude on
# the net, the scorecard reports it under "synth", and the search
# plane's `synthetic_bug` invariant fires at total >= 3. The sweep must
# FIND a violating schedule and SHRINK it to the known minimum (two
# plant events, magnitudes summing to exactly 3); disarming is "the
# fix" — the same corpus entry must then replay clean. Never armed in
# production scenarios; the tests arm it around their sweeps.
SYNTH_BUG = {"armed": False}

# Test-only planted corruption for the archive leg (the shard-byte-match
# invariant's ground truth, mirroring SYNTH_BUG): while armed, the
# archive leg flips one key byte inside its FIRST imported shard file
# after import — so every clean stage (wire transfer, verify-gated
# import) passed, but the archive's served answers no longer match the
# sealed source contents. search.check_invariants' `archive_byte_match`
# must fire on the armed run and stay silent on clean ones (anti-vacuity
# both ways). Never armed in production scenarios.
ARCHIVE_CORRUPT = {"armed": False}


@dataclass
class Scenario:
    name: str
    seed: int = 0
    n_validators: int = 4
    quorum: int = 3
    steps: int = 60
    latency_steps: int = 1
    idle_interval: int = 4
    # builders: called with (schedule, scenario) / (factory, rng, scenario)
    build_schedule: Optional[Callable] = None
    build_workload: Optional[Callable] = None
    # DATA forms of the two builders (lossless to_json/from_json needs
    # schedules and workloads as data, not closures): a pre-built
    # FaultSchedule replayed as-is, and a named-workload spec
    # ({"kind": <workloads.WORKLOADS name>, "n": N, ...}) interpreted by
    # build_spec_workload. Builders and data forms compose (events
    # merge; build_workload wins over workload when both are set).
    schedule: Optional[FaultSchedule] = None
    workload: Optional[dict] = None
    # nid -> behavior tuple (testkit.byzantine.BEHAVIORS subset)
    byzantine: dict = dc_field(default_factory=dict)
    # production fan-in plane: a lightweight relay-peer tier
    # of n_peers non-validator nodes, validator-message squelching
    # (squelch_size=0 = full flood, byte-for-byte the legacy transport)
    # and enforced per-source resource pricing on every honest node
    n_peers: int = 0
    squelch_size: int = 0
    squelch_rotate: int = 16
    resources: bool = False
    # relay-tier flooders: peer-tier index -> kwargs for FlooderPeer
    # (behaviors/burst/fan); nid = n_validators + index
    flooders: dict = dc_field(default_factory=dict)
    # cold-node catch-up: nids silenced from step 0, revived at join_at,
    # syncing via the segment bulk path; `segments` gives every honest
    # validator a real segstore the scenario persists closed ledgers to
    cold_nodes: tuple = ()
    join_at: int = 0
    segments: bool = False
    segment_bytes: int = 65536  # segstore floors at 64 KiB
    # history-shard tiering (requires segments): when a serving
    # validator's accepted chain reaches `shard_trim_seq`, every ledger
    # BELOW it rotates out of the live segstore into a sealed history
    # shard (nodestore/shards.py rotate_into_shards) — so a cold node
    # joining later must sync that range entirely from shards over the
    # combined GetSegments manifest, the production trim-then-tier
    # shape (doc/storage.md)
    shards: bool = False
    shard_trim_seq: int = 0
    garbage_server: Optional[int] = None   # serving nid that corrupts
    kill_server_at: Optional[int] = None   # kill the 2nd server mid-sync
    # admission plane: attach a per-validator TxQ (pinned soft cap) and
    # route injected txs through admit() on every validator
    txq_cap: Optional[int] = None
    # parallel speculation plane ([spec] workers=N):
    # attach a thread-mode SpecExecutor to every honest validator so
    # open-window speculation runs on a real worker pool UNDER the
    # scenario's faults. Worker timing is wall-clock, so the per-run
    # splice/retry counters are not replay-deterministic — the gate is
    # HASH IDENTITY: the final chain must match the workers=1 run of
    # the same seed byte-for-byte (chip_smoke.py's scenarios phase).
    spec_workers: int = 1
    # follower read-plane tier: n_followers non-consensus full
    # nodes (nids after the relay tier) ingesting the validated chain;
    # the scorecard's `followers` block carries their sync evidence
    n_followers: int = 0
    # cascading follower tree: follower_branching>0 arranges
    # the follower tier as a branching-ary tree rooted at the validator
    # core (overlay.followertree.plan_tree) — tier-1 followers anycast
    # to validators, deeper tiers acquire from their parent follower
    # and re-home UP the tree when it dies. The `followers.tree` block
    # carries shape + re-home evidence; 0 = flat tier (legacy shape)
    follower_branching: int = 0
    # sharded crypto plane: mesh_width>0 routes every honest
    # validator's tree hashing through the mesh-enabled device hasher
    # (forced-device routing for anti-vacuity), width clamped to the
    # visible devices — width 1 on a 1-device box is the SAME routed
    # plane, so the convergence/single-hash invariants always run
    # against the sharded code path. The gate is HASH IDENTITY with
    # the host-hashed run of the same seed (hashes are hashes), plus
    # the scorecard's `mesh` block as machinery-fired evidence.
    mesh_width: int = 0
    # liquidity plane: path_subs>0 rides an incremental book
    # index (paths/plane.py) + N synthetic path subscriptions on the
    # watch validator: every accepted close advances the index, checks
    # identity against a full state scan, and re-ranks stalest-first
    # under a deliberately tight ceil(n/2) budget so shedding leaves
    # scorecard evidence. The `paths` block is deterministic per seed.
    path_subs: int = 0
    # archive tier (requires shards): after convergence a
    # synthetic archive node cold-backfills every sealed shard from the
    # serving validators' segment sources through the REAL wire codec
    # (ShardBackfill + whole-file SHARD_FILE door, verify-gated
    # import), then every historical answer it serves — account-index
    # rows, tx blobs, raw records — is byte-compared against the sealed
    # source's verified contents. The `archive` scorecard block carries
    # imported/reject/condemnation counts and the byte-match verdict;
    # a garbage_server scenario exercises condemnation on this leg too.
    archive: bool = False
    # convergence tail
    converge_extra: int = 2
    max_tail_steps: int = 240
    transports: tuple = ("simnet",)

    # -- serialization (corpus entries / the shrinker need scenarios as
    #    data; digest-pinned round trip) ---------------------------------

    def to_json(self) -> dict:
        """Lossless JSON form. Raises if the scenario still carries
        closure builders (``build_schedule``/``build_workload``) — only
        the data forms (``schedule``/``workload``) serialize."""
        if self.build_schedule is not None or self.build_workload is not None:
            raise ValueError(
                "scenario carries closure builders; only data-form "
                "scenarios (schedule=/workload=) serialize"
            )
        out = {}
        for f in dc_fields(self):
            if f.name in ("build_schedule", "build_workload"):
                continue
            v = getattr(self, f.name)
            if f.name == "schedule":
                v = v.to_json() if v is not None else None
            elif f.name == "byzantine":
                v = {str(k): list(bs) for k, bs in sorted(v.items())}
            elif f.name == "flooders":
                v = {str(k): dict(sp) for k, sp in sorted(v.items())}
            elif isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "Scenario":
        kw = dict(obj)
        if kw.get("schedule") is not None:
            kw["schedule"] = FaultSchedule.from_json(kw["schedule"])
        kw["byzantine"] = {
            int(k): tuple(bs)
            for k, bs in (kw.get("byzantine") or {}).items()
        }
        kw["flooders"] = {
            int(k): dict(sp)
            for k, sp in (kw.get("flooders") or {}).items()
        }
        for name in ("cold_nodes", "transports"):
            if name in kw:
                kw[name] = tuple(kw[name])
        known = {f.name for f in dc_fields(cls)}
        return cls(**{k: v for k, v in kw.items() if k in known})

    def digest(self) -> str:
        """Stable digest of the whole scenario-as-data (round-trip and
        cross-process determinism pins compare this)."""
        import hashlib
        import json

        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def apply_event(net: SimNet, ev) -> None:
    kw = dict(ev.kwargs)
    if ev.kind == "partition":
        net.partition(set(ev.args[0]), set(ev.args[1]))
    elif ev.kind == "heal":
        for a in ev.args[0]:
            for b in ev.args[1]:
                net.heal_link(a, b)
    elif ev.kind == "kill":
        net.kill(ev.args[0])
    elif ev.kind == "revive":
        net.revive(ev.args[0])
    elif ev.kind == "link_fault":
        net.set_link_fault(ev.args[0], ev.args[1], **kw)
    elif ev.kind == "clear_link_fault":
        net.clear_link_fault(ev.args[0], ev.args[1])
    elif ev.kind == "synth_plant":
        # test-only planted bug (see SYNTH_BUG): a no-op on the network,
        # but while armed it accumulates scorecard evidence the search
        # plane's synthetic_bug invariant trips on
        if SYNTH_BUG["armed"]:
            net.synth_planted = (
                getattr(net, "synth_planted", 0) + int(ev.args[0])
            )
    else:
        raise ValueError(f"unknown fault kind {ev.kind!r}")


class _GarbageSegmentSource:
    """Wraps a segment source so every served segment carries one
    flipped blob byte — content-verification at the fetcher must catch
    it and fall back to another peer."""

    def __init__(self, inner):
        self.inner = inner

    def segments(self):
        return self.inner.segments()

    def fetch_segment(self, seg_id, offset=0, length=None):
        got = self.inner.fetch_segment(seg_id, offset=offset,
                                       length=length)
        if got is None:
            return None
        meta, data = got
        if offset == 0 and len(data) > 41:
            b = bytearray(data)
            b[40] ^= 0xFF  # inside the first record's blob
            data = bytes(b)
        return meta, data


def _setup_segments(net: SimNet, scn: Scenario, tmp_factory):
    """Give every honest serving validator a real segstore the accepted
    ledgers persist into, and the cold node a local store + the
    SegmentCatchup bulk fetcher."""
    from ..node.inbound import SegmentCatchup
    from ..nodestore.core import NodeObjectType, make_database

    dbs = {}
    shardstores = {}
    serving = [
        i for i in range(scn.n_validators)
        if i not in scn.cold_nodes and i not in scn.byzantine
    ]
    for i in serving:
        db = make_database(
            type="segstore", path=tmp_factory(f"seg-{i}"),
            durability="async", segment_bytes=scn.segment_bytes,
            async_writes=False,
        )
        dbs[i] = db
        v = net.validators[i]
        if scn.shards:
            # history-shard tiering: at shard_trim_seq the pre-floor
            # range rotates out of the live segstore into a sealed
            # shard — a cold node joining later syncs it from cold
            # storage over the combined manifest (the production
            # trim-then-tier shape, deterministic: seq-driven)
            from ..nodestore.shards import (
                CombinedSegmentSource, HistoryShardStore,
                rotate_into_shards,
            )

            ss = HistoryShardStore(tmp_factory(f"shards-{i}"))
            shardstores[i] = ss
            headers: list[dict] = []
            rotated = [False]

            def _save(led, db=db, ss=ss, headers=headers,
                      rotated=rotated):
                led.save(db)
                headers.append({
                    "hash": led.hash(), "seq": led.seq,
                    "parent_hash": led.parent_hash,
                    "account_hash": led.account_hash,
                    "tx_hash": led.tx_hash,
                })
                if not rotated[0] and scn.shard_trim_seq > 0 \
                        and led.seq >= scn.shard_trim_seq:
                    rotated[0] = True
                    retired = [
                        h for h in headers
                        if h["seq"] < scn.shard_trim_seq
                    ]
                    retained = [
                        h for h in headers
                        if h["seq"] >= scn.shard_trim_seq
                    ]
                    rotate_into_shards(db, ss, retired, retained)

            v.node.on_ledger.append(_save)
        else:
            v.node.on_ledger.append(lambda led, db=db: led.save(db))
        src = db.backend
        if i in shardstores:
            src = CombinedSegmentSource(src, shardstores[i])
        if scn.garbage_server == i:
            src = _GarbageSegmentSource(src)
        v.node.segment_source = src

    catchups = {}
    for nid in scn.cold_nodes:
        cold = net.validators[nid]
        colddb = make_database(type="memory", async_writes=False)
        dbs[nid] = colddb

        def _local_fetch(h, colddb=colddb):
            obj = colddb.fetch(h)
            return obj.data if obj is not None else None

        cold.node.inbound.local_fetch = _local_fetch
        sc = SegmentCatchup(
            send=lambda peer, msg, nid=nid: net.send(
                nid, peer, frame(msg)
            ),
            peers=lambda serving=serving: list(serving),
            store=lambda tb, key, blob, colddb=colddb: colddb.store(
                NodeObjectType(tb), key, blob
            ),
            clock=net.clock,
            request_timeout=4.0,
            backoff_base=1.0,
            backoff_max=8.0,
            seed=scn.seed,
            note_byzantine=cold.node.note_byzantine,
        )
        cold.node.segment_catchup = sc
        catchups[nid] = sc
    return dbs, catchups, shardstores


def _run_archive_leg(scn: Scenario, net: SimNet, shardstores: dict,
                     tmp_factory) -> dict:
    """Archive-tier leg: a synthetic archive node backfills
    every sealed shard from the serving validators' segment sources —
    a synchronous, deterministic pump (seeded peer discipline, fake
    clock, no net stepping) that round-trips EVERY message through the
    real wire codec so the range-row encoding is exercised, not
    shortcut. After backfill, every historical answer the archive can
    serve (account-index rows, tx blobs, raw records) is byte-compared
    against the sealed source's verified contents; the scorecard block
    is ints/bools only so scorecards stay byte-identical per seed."""
    import os as _os

    from ..node.archive import ShardBackfill
    from ..nodestore.shards import HistoryShardStore
    from ..overlay import wire as W

    serving = sorted(shardstores)
    sources = {i: net.validators[i].node.segment_source for i in serving}
    adir = tmp_factory("archive")
    ass = HistoryShardStore(adir)
    mt_gs = int(W._ENCODERS[W.GetSegments][0])
    mt_sd = int(W._ENCODERS[W.SegmentData][0])
    clock = [0.0]
    pending: list = []
    noted: list = []

    def send(peer, msg):
        pending.append(
            (peer, W.decode_message(mt_gs, W.encode_message(msg)))
        )

    sb = ShardBackfill(
        send=send, peers=lambda: list(serving), shardstore=ass,
        clock=lambda: clock[0], request_timeout=4.0, rescan_s=1e9,
        seed=scn.seed,
        note_byzantine=lambda kind, **kw: noted.append(kind),
    )
    sb.start()
    guard = 0
    while sb.active and guard < 50_000:
        guard += 1
        if not pending:
            clock[0] += 5.0  # starved request: drive the timeout path
            sb.tick(clock[0])
            continue
        peer, msg = pending.pop(0)
        src = sources.get(peer)
        if src is None:
            continue
        if msg.seg_id < 0:
            rows = [
                (d["id"], d["size"], d["live_bytes"], bool(d["active"]),
                 int(d.get("lo", 0)), int(d.get("hi", 0)),
                 int(d.get("file_bytes", 0)))
                for d in src.segments()
            ]
            reply = W.SegmentData(-1, 0, 0, b"", segments=rows,
                                  snap_epoch=1)
        else:
            got = src.fetch_segment(msg.seg_id, offset=msg.offset,
                                    length=1 << 15)
            if got is None:
                continue  # unanswerable: the timeout path handles it
            meta, data = got
            reply = W.SegmentData(msg.seg_id, meta["size"], msg.offset,
                                  data, snap_epoch=1)
        reply = W.decode_message(mt_sd, W.encode_message(reply))
        if reply.seg_id < 0:
            sb.on_manifest(peer, reply.segments, epoch=reply.snap_epoch)
        else:
            sb.on_data(peer, reply)

    if ARCHIVE_CORRUPT["armed"] and ass.shards():
        # planted post-import corruption (see ARCHIVE_CORRUPT): flip
        # one key byte of the first imported shard's first record —
        # structure-preserving, so serving still works but the served
        # bytes no longer match the sealed source
        from ..nodestore.shards import _HDR_SIZE

        sid0 = ass.shards()[0]["id"]
        path = _os.path.join(adir, f"shard-{sid0:06d}.shard")
        with open(path, "r+b") as f:
            f.seek(_HDR_SIZE + 5)  # first record's key, first byte
            b = f.read(1)
            f.seek(_HDR_SIZE + 5)
            f.write(bytes([b[0] ^ 0xFF]))

    # byte-match sweep: the invariant surface. Every acct-index row's
    # tx blob AND every raw record the archive would serve must equal
    # the sealed source's verified contents.
    queries = 0
    mismatches = 0
    src_stores = list(shardstores.values())
    for sh in ass.shards():
        sid = sh["id"]
        src_ss = next(
            (s for s in src_stores if s.covers(sh["lo"]) is not None),
            None,
        )
        if src_ss is None:
            continue
        src_sid = src_ss.covers(sh["lo"])
        src_recs = {
            k: (tb, blob) for k, tb, blob in src_ss.iter_records(src_sid)
        }
        for k, tb, blob in ass.iter_records(sid):
            queries += 1
            if src_recs.get(k) != (tb, blob):
                mismatches += 1
        for _acct, lseq, _tseq, txid in ass.acct_rows(sid):
            queries += 1
            if ass.tx_blob(sid, txid) != src_ss.tx_blob(
                src_ss.covers(lseq), txid
            ):
                mismatches += 1
    out = {
        "imported": sb.counters["imported"],
        "duplicates": sb.counters["duplicates"],
        "import_rejects": sb.counters["import_rejects"],
        "garbage_peers": sb.counters["garbage_peers"],
        "fallbacks": sb.counters["fallbacks"],
        "completed": sb.counters["completed"],
        "byzantine_noted": len(noted),
        "verified_floor": ass.contiguous_floor(),
        "queries": queries,
        "byte_match_failures": mismatches,
        "corrupt_armed": bool(ARCHIVE_CORRUPT["armed"]),
    }
    ass.close()
    return out


def _attach_txqs(net: SimNet, scn: Scenario) -> dict:
    from ..node.txq import FeeMetrics, TxQ

    txqs = {}
    for i in range(scn.n_validators):
        if i in scn.byzantine or i in scn.cold_nodes:
            continue
        txq = TxQ(
            metrics=FeeMetrics(
                min_cap=scn.txq_cap, max_cap=scn.txq_cap
            ),
            ledgers_in_queue=20,
        )
        net.validators[i].node.lm.txq = txq
        txqs[i] = txq
    return txqs


_CLIENT_RETRY_STEPS = 4

# admission outcomes a synchronous client retries: local shed (fee
# escalation), account not yet on-ledger (its funding is still in the
# queue), balance-bound chain refusal. terQUEUED/tes are successes;
# tem/tef are permanent.
_CLIENT_RETRY_TERS = frozenset((
    int(TER.telINSUF_FEE_P), int(TER.terNO_ACCOUNT),
    int(TER.terINSUF_FEE_B),
))


def _client_should_retry(got: Optional[tuple]) -> bool:
    return got is None or int(got[0]) in _CLIENT_RETRY_TERS


def _outcome_rank(ter: int, applied: bool) -> int:
    """Admission-outcome precedence for the fairness record: a tx's
    final story is the BEST outcome its reporting gate ever gave it
    (applied > queued > final reject > retryable shed) — a shed that
    later re-admits as terQUEUED must count as queued, or retry-heavy
    scenarios under-count the queue and skew the starvation ratio."""
    if applied:
        return 3
    if ter == int(TER.terQUEUED):
        return 2
    if ter in _CLIENT_RETRY_TERS:
        return 0
    return 1


def _record_admission(admissions: dict, gate_of: dict, gate: int,
                      tx: SerializedTransaction, ter: int,
                      applied: bool) -> None:
    """Record/upgrade the admission story of one tx as seen at its
    REPORTING gate (the first live validator that answered; retries at
    that gate upgrade the record by outcome precedence)."""
    txid = tx.txid()
    if gate_of.setdefault(txid, gate) != gate:
        return
    new = (int(ter), bool(applied), tx.fee.mantissa, tx.account,
           tx.sequence)
    old = admissions.get(txid)
    if old is None or _outcome_rank(new[0], new[1]) >= \
            _outcome_rank(old[0], old[1]):
        admissions[txid] = new


def _admit_at(net: SimNet, txqs: dict, i: int,
              blob: bytes) -> Optional[tuple]:
    """Admit one client tx copy at validator i's gate; None while the
    validator is down. Returns (ter, applied, parsed copy)."""
    if net.is_down(i):
        return None
    copy = SerializedTransaction.from_bytes(blob)
    copy.set_sig_verdict(True)  # pre-verified client submission
    v = net.validators[i]
    with v.node.lock:
        ter, applied = txqs[i].admit(
            copy, v.node.lm, TxParams.OPEN_LEDGER | TxParams.RETRY
        )
    return ter, applied, copy


def _inject(net: SimNet, scn: Scenario, nid: int,
            tx: SerializedTransaction, txqs: dict,
            admissions: dict, step: int = 0,
            retry_q: Optional[list] = None,
            gate_of: Optional[dict] = None) -> None:
    """One workload item enters the net. Without an admission plane it
    rides the normal client path (apply locally + flood). With TxQs
    attached, EVERY honest validator runs admit() on its own copy — the
    production shape where a flood reaches each node's admission gate.
    A client SEES a local shed (telINSUF_FEE_P) or a dead node
    synchronously and retries; fire-and-forget here manufactured
    permanent per-account sequence gaps behind which whole queued
    chains starved (a scenario-fuzzer false-positive class) — down/shed
    admissions defer onto `retry_q` instead."""
    if not txqs:
        if net.is_down(nid) or nid in scn.byzantine:
            nid = next(
                i for i in range(scn.n_validators)
                if not net.is_down(i) and i not in scn.byzantine
            )
        net.validators[nid].submit_client_tx(tx)
        return
    blob = tx.serialize()
    if gate_of is None:
        gate_of = {}
    for i in txqs:
        got = _admit_at(net, txqs, i, blob)
        if _client_should_retry(got):
            if retry_q is not None:
                retry_q.append((step + _CLIENT_RETRY_STEPS, i, blob, 0))
        if got is not None:
            ter, applied, copy = got
            _record_admission(admissions, gate_of, i, copy,
                              int(ter), applied)


def _drain_client_retries(net: SimNet, txqs: dict, retry_q: list,
                          step: int, admissions: Optional[dict] = None,
                          gate_of: Optional[dict] = None) -> None:
    """Re-admit deferred client submissions whose retry timer fired;
    still-down / still-shed ones re-defer. Order-preserving (a client's
    chain resubmits in sequence order). A retry outcome at the tx's
    reporting gate UPGRADES its admission record — a shed that later
    queues counts as queued in the fairness verdicts."""
    if not retry_q:
        return
    keep = []
    for due, i, blob, tries in retry_q:
        if due > step:
            keep.append((due, i, blob, tries))
            continue
        got = _admit_at(net, txqs, i, blob)
        if got is not None and admissions is not None \
                and gate_of is not None:
            ter, applied, copy = got
            _record_admission(admissions, gate_of, i, copy,
                              int(ter), applied)
        if _client_should_retry(got) and tries < 25:
            # a real client gives up eventually too — the bound keeps
            # the quiescence tail finite when a tx can never enter
            keep.append((step + _CLIENT_RETRY_STEPS, i, blob, tries + 1))
    retry_q[:] = keep


def _count_committed(watch, workload) -> int:
    """Workload (sender, sequence) pairs consumed on the FINAL validated
    chain of the watch validator. Sequence consumption is fork-proof
    ground truth: a sequence can only advance by applying the one
    workload tx that carries it (replace-by-fee pairs count once — the
    chain can only have taken one of the bids)."""
    from ..protocol.sfields import sfSequence

    final = watch.node.lm.validated
    if final is None:
        return 0
    next_seq: dict[bytes, int] = {}
    pairs = set()
    for _at, _nid, tx in workload:
        acct = tx.account
        if acct not in next_seq:
            root = final.account_root(acct)
            next_seq[acct] = root[sfSequence] if root is not None else 1
        if tx.sequence < next_seq[acct]:
            pairs.add((acct, tx.sequence))
    return len(pairs)


def _fairness(admissions: dict, commits: dict) -> dict:
    """Admission-plane fairness verdicts from observable outcomes on
    validator 0's chain: fee-ordered drain (queued high-fee txs commit
    no later, on average, than queued low-fee ones), no-starvation
    (every queued tx eventually commits), replace-by-fee (a replaced
    sequence commits at most once)."""
    # replace-by-fee: only ONE bid per (account, seq) can ever commit,
    # so queued bids collapse onto their chain slot — a replaced
    # original is not a starved tx (the fuzzer caught the per-txid
    # accounting under-reporting no_starvation on replacement-heavy
    # streams)
    slots: dict[tuple, list] = {}
    for txid, (ter, _applied, fee, acct, seq) in admissions.items():
        if ter == int(TER.terQUEUED):
            slots.setdefault((acct, seq), []).append((txid, fee))
    recs = admissions.values()
    out = {
        "admitted": sum(1 for _ter, a, _f, _a, _s in recs if a),
        "queued": len(slots),
        "rejected": sum(
            1 for ter, a, _f, _a, _s in recs
            if not a and ter != int(TER.terQUEUED)
        ),
    }
    if not slots:
        out.update(fee_order_drain=True, no_starvation=True)
        return out
    landed = []
    for bids in slots.values():
        done = [(fee, commits[txid]) for txid, fee in bids
                if txid in commits]
        if done:
            landed.append(max(done))  # the winning (highest) bid
    out["queued_committed"] = len(landed)
    out["no_starvation"] = len(landed) >= max(1, int(0.9 * len(slots)))
    if len(landed) >= 4:
        landed.sort(key=lambda p: -p[0])
        k = max(1, len(landed) // 4)
        top = sum(seq for _f, seq in landed[:k]) / k
        bot = sum(seq for _f, seq in landed[-k:]) / k
        out["fee_order_drain"] = top <= bot + 1e-9
    else:
        out["fee_order_drain"] = True
    return out


def _fork_seqs(net: SimNet, honest: list, common: int) -> list:
    """Seqs <= the common validated floor where honest validators'
    ledger histories disagree. After fork repair + validated-slot
    overwrite these must agree wherever two nodes both hold an entry."""
    out = []
    for seq in range(1, max(0, common) + 1):
        seen = {
            h for h in (
                net.validators[i].node.lm.ledger_history.get(seq)
                for i in honest
            ) if h is not None
        }
        if len(seen) > 1:
            out.append(seq)
    return out


def run_simnet(scn: Scenario, tmpdir: Optional[str] = None,
               device="cuda", devices=None) -> dict:
    """Execute one scenario on the deterministic simnet; returns the
    scorecard. `tmpdir` is required for segment scenarios (the serving
    validators persist real segstores there); its CONTENT never enters
    the scorecard, so determinism holds across paths.

    `device` and `devices` reach only the mesh leg (``mesh_width``), the
    one part of a run that touches a device: its hasher runs K2 on
    `device`, its mesh cut from `devices` (an explicit list, e.g. N CPU
    shards) or from every visible card. A mesh scenario resolves the
    device before the net is built, so ``"cuda"`` without a card raises;
    ``"cpu"`` runs the kernel's plain version. Nothing falls back to the
    host."""
    import os
    import tempfile

    from .byzantine import ByzantineValidator, FlooderPeer

    if scn.mesh_width:
        from ..utils.device import resolve_device

        resolve_device(device)

    net = SimNet(
        scn.n_validators, quorum=scn.quorum,
        latency_steps=scn.latency_steps,
        idle_interval=scn.idle_interval, seed=scn.seed,
        n_peers=scn.n_peers, squelch_size=scn.squelch_size,
        squelch_rotate=scn.squelch_rotate, resources=scn.resources,
        n_followers=scn.n_followers,
        follower_branching=scn.follower_branching,
    )
    # swap hostile slots in BEFORE start() so their genesis matches
    byz_validators = {}
    for nid, behaviors in scn.byzantine.items():
        bv = ByzantineValidator(
            net, nid, net.keys[nid],
            {k.public for k in net.keys}, scn.quorum or 0,
            scn.idle_interval, behaviors=behaviors, seed=scn.seed,
        )
        net.validators[nid] = bv
        net.nodes[nid] = bv
        byz_validators[nid] = bv
    # relay-tier flooders (flood-survival shape): swap hostile
    # peers into the relay tier, inheriting the slot's squelch/resource
    # attachments so their DELIVERIES behave like any peer's — only
    # their act() is hostile
    flooder_peers = {}
    for idx, spec in scn.flooders.items():
        nid = scn.n_validators + int(idx)
        old = net.nodes[nid]
        fp = FlooderPeer(net, nid, seed=scn.seed, **spec)
        fp.squelch = old.squelch
        fp.resources = old.resources
        net.peers[int(idx)] = fp
        net.nodes[nid] = fp
        flooder_peers[nid] = fp

    # schedule: data-form events + user builder + the cold-node join
    # choreography, merged onto one replayed schedule (its digest rides
    # the scorecard, so the merge is part of the replay identity)
    sched = FaultSchedule(scn.seed)
    if scn.schedule is not None:
        sched.extend(scn.schedule.events)
    if scn.build_schedule is not None:
        scn.build_schedule(sched, scn)
    for nid in scn.cold_nodes:
        sched.kill(0, nid, revive_at=scn.join_at)
    if scn.kill_server_at is not None:
        # the cold node's CURRENT server (2nd in order once the garbage
        # server condemned itself) dies mid-sync; revived for the tail
        victims = [
            i for i in range(scn.n_validators)
            if i not in scn.cold_nodes and i not in scn.byzantine
            and i != scn.garbage_server
        ]
        sched.kill(scn.kill_server_at, victims[0],
                   revive_at=scn.kill_server_at + 10)

    # workload (closure builder wins; else the named-workload spec)
    fac = TxFactory(seed=scn.seed)
    wl_rng = random.Random(0x301C ^ scn.seed)
    workload = []
    build_workload = scn.build_workload
    if build_workload is None and scn.workload is not None:
        build_workload = build_spec_workload(scn.workload)
    if build_workload is not None:
        workload = build_workload(fac, wl_rng, scn)
    by_step: dict[int, list] = {}
    for at, nid, tx in workload:
        by_step.setdefault(at, []).append((nid, tx))

    own_tmp = None
    dbs, catchups, shardstores = {}, {}, {}
    if scn.segments:
        if tmpdir is None:
            own_tmp = tempfile.mkdtemp(prefix="scn-seg-")
            tmpdir = own_tmp
        dbs, catchups, shardstores = _setup_segments(
            net, scn, lambda name: os.path.join(tmpdir, name)
        )
    txqs = _attach_txqs(net, scn) if scn.txq_cap else {}

    honest = [
        i for i in range(scn.n_validators) if i not in scn.byzantine
    ]
    # sharded hash plane under faults: one shared meshed
    # watched hasher (forced-device routing — the cost model would
    # bench a CPU-emulated kernel out and leave the leg vacuous) on
    # every honest validator's trees. Digests are digests: the chain's
    # bytes are identical to the host-hashed run of the same seed,
    # which is exactly the invariant the fuzzer then checks.
    mesh_hasher = None
    if scn.mesh_width:
        from ..crypto.backend import make_watched_hasher

        mesh_hasher = make_watched_hasher(
            "cuda", mesh=str(scn.mesh_width), routing="device",
            device=device, devices=devices,
        )
        # the FLAT facade (no hash_tree): tree hashing level-batches
        # through the routed hash_packed path, i.e. the SHARDED
        # masked-SHA kernel (K2) — the per-level pack_nodes shape the
        # close path feeds, which is the plane this axis exists to cover
        mesh_flat = mesh_hasher.flat_hasher()
        for i in honest:
            v = net.validators[i].node
            v.hash_batch = mesh_flat
            v.lm.hash_batch = mesh_flat
    # parallel speculation under faults: thread-mode pools (the simnet
    # is in-process; forking workers per validator would be pure
    # overhead) on every honest validator's chain
    spec_execs = []
    if scn.spec_workers > 1:
        from ..engine.specexec import SpecExecutor

        for i in honest:
            ex = SpecExecutor(workers=scn.spec_workers, mode="thread")
            ex.start()
            net.validators[i].node.lm.spec_executor = ex
            spec_execs.append(ex)
    # committed txids observed on ANY honest validator's accept feed —
    # one observer is not enough: fork-repair adoption can skip
    # unresolvable intermediate ledgers (no on_ledger fires for them),
    # so a lagging node's feed under-reports txs the net committed
    watch = net.validators[honest[0]]
    commits: dict[bytes, int] = {}

    def _record(led):
        for txid, _blob, _meta in led.tx_entries():
            commits.setdefault(txid, led.seq)

    for i in honest:
        net.validators[i].node.on_ledger.append(_record)

    # liquidity plane under faults: the watch validator's
    # accept feed drives the incremental book index + scn.path_subs
    # synthetic subscriptions. Fork repair can skip or replay closes —
    # exactly the continuity seams the index must survive (falling back
    # to a full rebuild, never diverging).
    path_plane = None
    path_stats = {"closes": 0, "identity_ok": True}
    if scn.path_subs:
        from ..paths import OrderBookDB
        from ..paths.plane import PathPlane

        path_plane = PathPlane(
            max_updates_per_close=max(1, (scn.path_subs + 1) // 2))
        path_keys = [("pathsub", j) for j in range(scn.path_subs)]

        def _path_close(led):
            path_plane.begin_close(led.seq)
            db = path_plane.books_for(led)
            if db.books != OrderBookDB().setup(led).books:
                path_stats["identity_ok"] = False
            path_stats["closes"] += 1
            for k in path_plane.order_keys(path_keys, led.seq):
                if path_plane.claim_update(k, led.seq):
                    path_plane.note_ranked(k, led.seq)

        watch.node.on_ledger.append(_path_close)

    net.start()
    admissions: dict = {}
    gate_of: dict = {}
    retry_q: list = []
    cur_step = [0]

    # SLO health dimension (node/health.py): a watchdog on VIRTUAL
    # step-time over the watch validator's close cadence — status is a
    # pure function of the replayed schedule, so the scorecard block is
    # deterministic per seed. The search plane's health invariants gate
    # on the (max observed gap, worst status) pair: an injected stall
    # must trip it, a clean run must not.
    from ..node.health import _RANK, FlightRecorder, HealthWatchdog

    health_flight = FlightRecorder(spans_cap=512)
    idle = float(max(1, scn.idle_interval))
    health_stall_warn = 10.0 * idle
    hw = HealthWatchdog(
        target_close_s=idle,
        stall_warn_s=health_stall_warn,
        stall_crit_s=30.0 * idle,
        drift_factor=8.0,
        clock=lambda: float(cur_step[0]),
        flight=health_flight,
    )
    health_state = {"worst": "ok", "last": None, "max_gap": 0}

    def _health_close(led):
        now = cur_step[0]
        if health_state["last"] is not None:
            gap = now - health_state["last"]
            if gap > health_state["max_gap"]:
                health_state["max_gap"] = gap
        health_state["last"] = now
        hw.note_close(led.seq, ts=float(now))

    watch.node.on_ledger.append(_health_close)

    def _health_tick():
        st = hw.evaluate()
        if _RANK[st] > _RANK[health_state["worst"]]:
            health_state["worst"] = st
    if txqs:
        # the client also RESUBMITS a tx the queue dropped (evicted /
        # expired while consensus stalled) — the product signals this
        # through TxQ.on_drop into LocalTxs, whose push_back makes the
        # tx resubmittable; without it, entries expiring under long
        # kill-stall windows read as admission-plane starvation.
        # Bounded per (txid, gate) so a permanently-dead tx terminates.
        blob_of: dict[bytes, bytes] = {}
        resubmits: dict[tuple, int] = {}

        def _mk_on_drop(i):
            def on_drop(txid):
                blob = blob_of.get(txid)
                n = resubmits.get((txid, i), 0)
                if blob is not None and n < 5:
                    resubmits[(txid, i)] = n + 1
                    retry_q.append((
                        cur_step[0] + _CLIENT_RETRY_STEPS, i, blob, 20,
                    ))
            return on_drop

        for i, txq in txqs.items():
            txq.on_drop = _mk_on_drop(i)
    submitted = 0
    try:
        for step in range(scn.steps):
            cur_step[0] = step
            for ev in sched.events_at(step):
                apply_event(net, ev)
            _drain_client_retries(net, txqs, retry_q, step,
                                  admissions, gate_of)
            for nid, tx in by_step.get(step, ()):
                if txqs:
                    blob_of[tx.txid()] = tx.serialize()
                _inject(net, scn, nid, tx, txqs, admissions,
                        step=step, retry_q=retry_q, gate_of=gate_of)
                submitted += 1
            for bv in byz_validators.values():
                if not net.is_down(bv.nid):
                    bv.act(step)
            for fp in flooder_peers.values():
                if not net.is_down(fp.nid):
                    fp.act(step)
            net.step()
            _health_tick()

        # drain the remaining schedule (heals/revives past the horizon)
        for ev in sorted(
            (e for e in sched.events if e.at >= scn.steps),
            key=lambda e: (e.at, e.order),
        ):
            if ev.kind in ("heal", "revive", "clear_link_fault"):
                apply_event(net, ev)

        # convergence tail: every honest validator quorum-validated on
        # one identical chain, `converge_extra` ledgers past the top
        def _hseqs():
            return [
                net.validators[i].node.lm.validated.seq
                if net.validators[i].node.lm.validated else 0
                for i in honest
            ]

        def _fseqs():
            return [
                f.node.lm.validated.seq if f.node.lm.validated else 0
                for f in net.followers
            ]

        def _tiers_at_target(target):
            # followers tail the validator wave one delivery-latency
            # behind by construction; their bar tracks the CURRENT
            # honest floor (validators keep closing during the
            # quiescence wait — a fixed target let the tail exit with
            # a follower legally-at-target but behind the floor the
            # synced verdict is judged against)
            hmin = min(_hseqs())
            if hmin < target:
                return False
            return not net.followers or min(_fseqs()) >= hmin - 1

        # two-phase tail: first reach the convergence target, then keep
        # stepping until the committed-tx count is QUIESCENT (held /
        # queued / disputed txs land a few rounds after the flood ends —
        # judging commit counts at first convergence undercounts them).
        # Quiescence additionally requires NO pending client work on
        # any live honest validator: a held sequence chain re-fires up
        # to ~2 retry horizons after a revive, and cutting the tail
        # inside that window reported healthy retries as lost txs
        # (a scenario-fuzzer false-positive class, fixed here)
        def _pending_client_work() -> bool:
            if retry_q:
                return True
            for i in honest:
                if net.is_down(i):
                    continue  # a frozen node's queues can't drain
                vn = net.validators[i].node
                if len(vn.local_txs):
                    return True
                if vn.lm.held:
                    return True
                txq = getattr(vn.lm, "txq", None)
                if txq is not None and len(txq):
                    return True
            return False

        target = max(_hseqs()) + scn.converge_extra
        tail = 0
        last_commits, stable = -1, 0
        while tail < scn.max_tail_steps:
            if _tiers_at_target(target):
                if len(commits) == last_commits:
                    stable += 1
                    if stable >= 3 * scn.idle_interval and \
                            not _pending_client_work():
                        break
                else:
                    stable = 0
                    last_commits = len(commits)
            cur_step[0] = scn.steps + tail
            _drain_client_retries(net, txqs, retry_q, scn.steps + tail,
                                  admissions, gate_of)
            net.step()
            _health_tick()
            tail += 1
        converged = min(_hseqs()) >= target
        common = min(_hseqs())
        hashes = {
            net.validators[i].node.lm.ledger_history.get(common)
            for i in honest
        }
        hashes.discard(None)

        splice: dict[str, int] = {}
        defense: dict[str, int] = {}
        degraded_transitions = 0
        for i in honest:
            vn = net.validators[i].node
            for k, v in vn.lm.delta_stats.snapshot().items():
                if isinstance(v, int):
                    splice[k] = splice.get(k, 0) + v
            for k, v in vn.defense.snapshot().items():
                defense[k] = defense.get(k, 0) + v
            degraded_transitions += vn.degrade_transitions

        card = {
            "scenario": scn.name,
            "seed": scn.seed,
            "transport": "simnet",
            "steps": scn.steps,
            "tail_steps": tail,
            "converged": converged,
            "final_seq": common,
            "final_hash": (
                next(iter(hashes)).hex() if len(hashes) == 1 else None
            ),
            "single_hash": len(hashes) == 1,
            "validated_seqs": _hseqs(),
            "submitted": submitted,
            "committed": _count_committed(watch, workload),
            "rounds": len(net.accept_log),
            "net": dict(net.net_stats),
            "splice": splice,
            "byzantine": {k: v for k, v in defense.items() if v},
            "byzantine_emitted": {
                nid: dict(bv.emitted)
                for nid, bv in byz_validators.items()
            },
            "degraded_transitions": degraded_transitions,
            "fault_digest": sched.digest(),
            # single-validated-hash-per-seq evidence: seqs at or below
            # the common validated floor where two honest validators'
            # repaired histories still disagree (must be empty — the
            # search plane's invariant registry gates on it)
            "fork_seqs": _fork_seqs(net, honest, common),
        }
        # SLO health dimension: deterministic ints/strings only (the
        # search plane's health_missed_stall / health_false_positive
        # invariants read the gap/worst pair)
        card["health"] = {
            "worst": health_state["worst"],
            "final": hw.status,
            "transitions": hw.transitions,
            "max_close_gap_steps": int(health_state["max_gap"]),
            "stall_warn_steps": int(health_stall_warn),
        }
        LAST_FLIGHT[:] = [health_flight]
        planted = getattr(net, "synth_planted", 0)
        if planted:
            card["synth"] = {"planted": planted}
        if scn.n_followers:
            fl_seqs = _fseqs()
            watch_hist = watch.node.lm.ledger_history
            card["followers"] = {
                "validated_seqs": fl_seqs,
                # every follower within one in-flight round of the
                # honest floor (the steady-state tailing lag) AND
                # byte-identical to the honest chain at its OWN floor
                "synced": bool(
                    converged
                    and len(hashes) == 1
                    and all(s >= common - 1 for s in fl_seqs)
                    and all(
                        f.node.lm.ledger_history.get(min(s, common))
                        == watch_hist.get(min(s, common))
                        for f, s in zip(net.followers, fl_seqs)
                    )
                ),
            }
            if scn.follower_branching:
                # tree shape + re-home evidence: leader
                # children bounded by branching, and a mid-tree kill
                # leaves a nonzero re-home count while `synced` above
                # still demands byte-identical reconvergence
                card["followers"]["tree"] = net.tree_json()
        if scn.squelch_size or scn.n_peers:
            # relay fan-out evidence: the squelch bound the flood gate
            # asserts (fan-out <= squelch_size + n_validators, never
            # the peer count)
            card["relay"] = {
                k: net.net_stats.get(k, 0)
                for k in ("relay_proposal", "relay_validation",
                          "relay_fanout_max")
            }
        if scn.resources:
            # `resource.*` evidence: charges paid, WARN/DROP crossings,
            # throttled sheds, refused deliveries per honest node
            card["resource"] = net.resource_json()
        if flooder_peers:
            card["flooders"] = {
                str(nid): {
                    "emitted": dict(fp.emitted),
                    # how many honest nodes reached DROP for this source
                    # and refused its deliveries (disconnect + gated
                    # readmission, collapsed onto the sim transport)
                    "refused_by": len(net.refusals.get(nid, ())),
                    # drop latency: virtual ms of flooding before the
                    # first honest node shut the door
                    "first_refusal_ms": net.first_refusal_ms.get(nid),
                }
                for nid, fp in sorted(flooder_peers.items())
            }
        if catchups:
            nid = scn.cold_nodes[0]
            cold = net.validators[nid].node
            cold_seq = cold.lm.validated.seq if cold.lm.validated else 0
            card["catchup"] = {
                "cold_nid": nid,
                "cold_validated_seq": cold_seq,
                "synced": (
                    converged
                    and cold_seq >= common
                    and cold.lm.ledger_history.get(common)
                    == next(iter(hashes), None)
                ),
                "segfetch": catchups[nid].get_json(),
            }
            if shardstores:
                # history-shard tier evidence: sealed ranges + how many
                # cold reads the shards actually served (anti-vacuity —
                # a shard leg where nothing read from a shard proves
                # nothing). trimmed=True pins that the live segstores
                # really lost the pre-floor range.
                reads = sum(
                    ss.segment_reads for ss in shardstores.values()
                )
                sealed = sum(ss.sealed for ss in shardstores.values())
                card["catchup"]["shards"] = {
                    "sealed": sealed,
                    "segment_reads": reads,
                    "trim_seq": scn.shard_trim_seq,
                }
        if scn.archive and shardstores:
            # archive tier: shard-network backfill into a
            # synthetic archive node + the byte-match invariant sweep
            card["archive"] = _run_archive_leg(
                scn, net, shardstores,
                lambda name: os.path.join(tmpdir, name),
            )
        if txqs:
            q0 = txqs[honest[0]]
            card["txq"] = {
                "stats": dict(q0.stats),
                "remaining": len(q0),
                **_fairness(admissions, commits),
            }
        if mesh_hasher is not None:
            # machinery-fired evidence for the mesh legs: the effective
            # width the plane resolved to and whether the device kernel
            # actually hashed nodes (booleans/config only — raw counts
            # stay out so scorecards remain byte-identical per seed)
            mj = mesh_hasher.get_json()
            card["mesh"] = {
                "width_requested": scn.mesh_width,
                "width": (mj.get("mesh") or {}).get("mesh_width"),
                "device_active": bool(mj.get("device_nodes")),
                "wedged": bool(mj.get("wedged")),
            }
        if spec_execs:
            # anti-vacuity evidence for the spec-pool legs: the pools
            # actually dispatched/committed work (wall-clock-dependent
            # counts — excluded from determinism comparisons by design)
            agg: dict[str, int] = {}
            for ex in spec_execs:
                for k, v in ex.counters.snapshot().items():
                    if isinstance(v, int):
                        agg[k] = agg.get(k, 0) + v
            card["spec"] = {
                "workers": scn.spec_workers,
                "dispatched": agg.get("dispatched", 0),
                "committed": agg.get("committed", 0),
                "retries": agg.get("retries", 0),
                "serial_fallbacks": agg.get("serial_fallbacks", 0),
            }
        if path_plane is not None:
            # liquidity-plane evidence: per-close identity held, the
            # budgeted re-ranker ran (anti-vacuity), bounded staleness,
            # and the index's advance/carry/rebuild mix — all
            # deterministic ints/bools, safe for scorecard identity
            pc = path_plane.index.counters()
            card["paths"] = {
                "subs": scn.path_subs,
                "closes": path_stats["closes"],
                "identity_ok": path_stats["identity_ok"],
                "reranked": path_plane.reranked,
                "shed_budget": path_plane.shed_budget,
                "staleness_max": path_plane.staleness_max,
                "incremental_advances": pc["incremental_advances"],
                "carries": pc["carries"],
                "full_rebuilds": pc["full_rebuilds"],
                "book_rereads": pc["book_rereads"],
            }
        return card
    finally:
        for ex in spec_execs:
            try:
                ex.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for db in dbs.values():
            try:
                db.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        if own_tmp is not None:
            import shutil

            shutil.rmtree(own_tmp, ignore_errors=True)
