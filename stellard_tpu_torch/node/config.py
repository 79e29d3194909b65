"""Node configuration: INI-style sections, CLI-friendly overrides.

Reference: src/ripple_core/functional/Config.cpp (816 LoC) parses
``stellard.cfg`` sections listed in ConfigSections.h:39-98. This config
keeps the same section names where they exist and adds the device
knobs (``[signature_backend]``, ``[hash_backend]``, batch-window tuning)
following the same pattern as the reference's ``[node_db] type=...``
pluggable-factory selection (doc/stellard-example.cfg:795-802).

This package's node is the standalone node or a networked validator,
follower or archive (``[peer_port]`` with ``[standalone] 0``: the TCP
overlay, its TLS and peer discovery, the TLS doors, SNTP and validator
list sources), and
its device backend is ``cuda``: both crypto sections default to
``type=cuda``, so a node runs on the card unless its config says
``type=cpu``, and a cuda node's signature, hash and path batches all go
to the card by default (``routing=device``, device floors of 1 and 0):
measured-cost routing, which may answer a batch on the host, is an
explicit ``routing=cost``. ``mesh=`` (0, N or ``auto``, the default of
both crypto sections, as in the JAX package) is the device width: the
batches shard over that many cards. The fleet roles (``[node]
mode=follower|archive``, ``upstream=``, ``[archive]``) and the health
watchdog (``[health]``, on by default) and the parallel speculation
pool (``[spec] workers=N|auto``, sized by ``resolve_spec_workers`` at
node build) parse as the JAX package's. A key that would turn on a plane
this package does not have (kernel tuning files) raises when the config
is parsed; nothing is dropped silently.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["Config", "parse_ini_sections"]

# the crypto-plane backends of this package (crypto/backend.py registry):
# the host verifiers and hashers, and the one device type, cuda
BACKENDS = {
    "signature_backend": ("cpu", "native", "openssl", "cuda"),
    "hash_backend": ("cpu", "cpp", "cuda"),
}


def _backend_type(section: str, value: str) -> str:
    """Validated ``type=`` of a crypto section, one of ``BACKENDS[section]``.
    ``tpu`` names the JAX package's device and raises with the name of
    this package's one."""
    backend = value.strip().lower()
    if backend == "tpu":
        raise ValueError(
            f"[{section}] type=tpu is the JAX package's device backend; "
            "this package's is type=cuda"
        )
    if backend not in BACKENDS[section]:
        raise ValueError(
            f"[{section}] type must be one of {list(BACKENDS[section])}, "
            f"got {backend!r}"
        )
    return backend


def resolve_spec_workers(workers, cpu_count=None, log=None) -> int:
    """Resolve ``[spec] workers`` to a concrete pool size at node setup.

    Integers pass through. ``"auto"`` resolves from ``os.cpu_count()``
    capped at 8 — and below 4 physical cores it LOUDLY disables the
    pool (returns 1, the inline serial path) instead of silently losing
    throughput: on a small box the pool's submit+committer overhead
    exceeds the serial speculation cost it replaces."""
    if workers != "auto":
        return int(workers)
    ncpu = cpu_count if cpu_count is not None else (os.cpu_count() or 1)
    if ncpu < 4:
        if log is not None:
            log.warning(
                "[spec] workers=auto: %d core(s) < 4 — parallel "
                "speculation pool DISABLED (inline serial path); the "
                "pool's IPC overhead would exceed the serial cost on "
                "this box", ncpu,
            )
        return 1
    return min(8, ncpu)


def parse_ini_sections(text: str) -> dict[str, list[str]]:
    """Parse the reference's cfg format: ``[section]`` headers followed by
    value lines; ``#``/``;`` comments; later duplicate sections extend
    earlier ones (reference: Config::load / ParseSection)."""
    sections: dict[str, list[str]] = {}
    current: Optional[str] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith(";"):
            continue
        if line.startswith("[") and line.endswith("]"):
            current = line[1:-1].strip().lower()
            sections.setdefault(current, [])
            continue
        if current is not None:
            sections[current].append(line)
    return sections


def _kv(lines: list[str]) -> dict[str, str]:
    out = {}
    for line in lines:
        if "=" in line:
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _reject_unknown(section: str, kv: dict, known: tuple) -> None:
    """The crypto-plane sections fail LOUDLY on unknown keys: before
    this, a typo'd (or never-plumbed) option like use_mesh= parsed
    clean and silently did nothing — dead config an operator believes
    is applied."""
    unknown = sorted(set(kv) - set(known))
    if unknown:
        raise ValueError(
            f"[{section}] unknown key(s) {unknown}; known: {sorted(known)}"
        )


def _crypto_mesh(section: str, backend: str, kv: dict, default: str) -> str:
    """Validated `mesh=` for a crypto section: parse_mesh canonicalizes
    (0/N/auto; garbage raises), and a mesh request on a HOST backend is
    a loud config error — the operator believes cards are in play."""
    from ..crypto.backend import parse_mesh

    if "mesh" not in kv:
        return default
    mesh = parse_mesh(kv["mesh"])
    if mesh != "0" and backend != "cuda":
        raise ValueError(
            f"[{section}] mesh={kv['mesh']} is meaningless with "
            f"type={backend} (host backends have no mesh); use type=cuda "
            "or mesh=0"
        )
    return mesh


def _crypto_routing(section: str, kv: dict, default: str) -> str:
    if "routing" not in kv:
        return default
    routing = kv["routing"].strip().lower()
    if routing not in ("cost", "device"):
        # a routing toggle must not fail open into an unintended mode
        raise ValueError(
            f"[{section}] routing must be cost/device, got {routing!r}"
        )
    return routing


def _crypto_backend_gate(section: str, backend: str, kv: dict,
                         device_only: tuple, host_only: tuple = ()) -> None:
    """Keys that only a device (cuda) backend honors are a loud error
    with a host type, and vice versa — otherwise they would parse clean
    and be silently dropped downstream, recreating the exact dead-config
    class _reject_unknown exists to eliminate."""
    if backend != "cuda":
        bad = sorted(k for k in device_only if k in kv)
        if bad:
            raise ValueError(
                f"[{section}] {bad} only apply to type=cuda "
                f"(type={backend} would silently drop them)"
            )
    else:
        bad = sorted(k for k in host_only if k in kv)
        if bad:
            raise ValueError(
                f"[{section}] {bad} only apply to host backends "
                f"(type=cuda would silently drop them)"
            )


# [kernel_tuning] off, for good: the JAX package's tuning files set
# XLA/Pallas knobs (unroll, comb, hoist, group, impl, block, wire) that no
# kernel of this package reads, and K1's lane group is fixed, so a path
# raises at parse rather than be silently ignored
DEFAULT_KERNEL_TUNING = "none"


@dataclass
class Config:
    # -- run modes (reference Config.h RUN_STANDALONE / START_UP) ---------
    standalone: bool = True
    start_up: str = "fresh"  # fresh | load
    ledger_history: int = 256  # reference [ledger_history]
    # [node] mode=validator|follower|archive — follower is the read-only
    # tier (doc/follower.md): no consensus rounds, validated ledgers
    # ingested from the net (bulk GetSegments catch-up + validation
    # tailing), reads served from the last validated snapshot with the
    # result cache on by default. "archive" is the full-history
    # reporting tier (doc/archive.md): follower ingest of the validated
    # tail PLUS deep-history backfill of sealed shards from peers, a
    # txdb that never trims, and forever-cached immutable-seq results.
    # "validator" is the classic networked node.
    node_mode: str = "validator"
    # [node] upstream= "host port" lines (follower trees, doc/follower.md):
    # a follower dials THESE instead of [ips] as its serving tier —
    # naming a peer FOLLOWER here cascades the validated-ledger tail and
    # the GetSegments catch-up door one tier down, so the leader's
    # egress is bounded by its direct children, not the fleet. Empty =
    # dial [ips] (the flat topology). Ignored on validators.
    node_upstream: list[str] = field(default_factory=list)

    # -- archive tier ([archive], doc/archive.md) --------------------------
    # shard-import directory for mode=archive (the archive's OWN sealed
    # set, distinct from [node_db] shards=). "" derives
    # <node_db path or database_path>.archive-shards.
    archive_path: str = ""
    # backfill=0 disables the deep-history fetcher (tail-only archive);
    # on by default — an archive that never backfills is a follower
    archive_backfill: int = 1
    # re-poll peers' manifests for newly sealed shards every N seconds
    archive_rescan_s: float = 30.0

    # -- storage ([node_db], [database_path]) ------------------------------
    node_db_type: str = "memory"
    node_db_path: str = ""
    node_db_compression: str = ""  # "" | zlib (cpplog snappy-role knob)
    # segstore durability: fsync (one fsync per flush batch — the
    # default), batch (group commit: one fsync per group_commit_ms
    # window), async (page cache only outside rolls/checkpoints/close)
    node_db_durability: str = "fsync"
    node_db_group_commit_ms: float = 5.0
    node_db_segment_mb: int = 64       # segment roll size
    node_db_checkpoint_mb: int = 32    # index snapshot every N MB appended
    node_db_compact_ratio: float = 0.5  # rewrite segments below this live%
    # online deletion (rippled SHAMapStore online_delete role): retain N
    # validated ledgers; unreachable nodes are mark-and-swept and their
    # segments compacted so disk stays bounded near the live set. 0=off.
    node_db_online_delete: int = 0
    # sweep every K validated ledgers (0 = retain/2)
    node_db_online_delete_interval: int = 0
    # trim txdb SQL history rows (tx/account-tx/ledger headers) below
    # the same retention horizon on the same drain worker (the
    # NodeStore sweep alone leaves the SQL mirror growing forever)
    node_db_sql_trim: int = 1
    # history shards ([node_db] shards=): directory where online-
    # deletion rotation SEALS the retired range as offline-verifiable
    # shard files before deleting it — below-floor account_tx and
    # cold-node catch-up serve from these instead of lgrIdxInvalid
    # (doc/storage.md "History shards"). "1" derives <path>.shards from
    # the node_db path; empty = off (trimmed history is discarded).
    node_db_shards: str = ""
    node_db_synchronous: str = ""      # sqlite PRAGMA synchronous= pass
    database_path: str = ""

    # -- crypto plane (device knobs; pattern of [node_db] type=) ----------
    signature_backend: str = "cuda"  # cpu | cuda
    hash_backend: str = "cuda"  # cpu | cuda
    # the torch device of a cuda backend ([signature_backend] device=,
    # [hash_backend] device=): "cuda" (the first card) by default; "cpu"
    # runs the kernels' plain versions, which the CPU tests use
    verify_device: str = "cuda"
    hash_device: str = "cuda"
    verify_batch_window_ms: float = 2.0  # coalescing window
    verify_max_batch: int = 16384
    # below this a batch is verified on the CPU: 1 keeps every batch of
    # a cuda node, a door's single signature included, on the card
    verify_min_device_batch: int = 1
    # mesh= is the device-width axis: 0 = no mesh (which still runs the
    # same sharded code at width 1), N = shard the batches over N cards,
    # auto = every visible card. Widths beyond the visible cards clamp
    # with a warning. Only meaningful on a cuda backend: mesh= with a
    # host type is a loud config error.
    verify_mesh: str = "auto"
    hash_mesh: str = "auto"
    # routing= device (default: every batch the floor admits goes to
    # the card) | cost (measured-latency host/device routing, which may
    # answer a batch on the host: an explicit opt-in)
    verify_routing: str = "device"
    hash_routing: str = "device"
    # device-wedge watchdog deadlines (utils.devicewatch defaults when
    # None) — previously constructor-only, unreachable from any cfg
    verify_device_first_timeout_s: Optional[float] = None
    verify_device_warm_timeout_s: Optional[float] = None
    hash_device_first_timeout_s: Optional[float] = None
    # flat-batch device floor for the hash plane: 0 sends every batch
    # to the card
    hash_min_device_nodes: int = 0
    # [kernel_tuning]: path to an on-chip sweep's KERNEL_TUNING.json —
    # applied as env defaults at node setup so a daemon honors the
    # measured kernel winner (default: the file name in the CWD, if
    # any; "none"/"off" disables)
    kernel_tuning: str = DEFAULT_KERNEL_TUNING

    # -- ledger-close pipeline ([close_pipeline]) --------------------------
    # enabled=1: standalone closes hand persistence (NodeStore flush,
    # tx rows, ordered CLF commit) to the bounded pipeline worker so
    # ledger N persists while N+1 applies; enabled=0 is the serial
    # fallback (persist in-line on the close path). depth bounds the
    # queue — a full queue back-pressures the next close.
    close_pipeline_enabled: bool = True
    close_pipeline_depth: int = 8

    # -- state-tree commit plane ([tree]) ----------------------------------
    # incremental=1: speculated writes fold into a pre-seal building
    # tree that a background drainer hashes through the routed hash
    # plane between closes, so the in-close seal adopts the pre-hashed
    # root and hashes only the residual (state/shamap.py bulk_update +
    # engine/deltareplay.py). incremental=0 is the kill-switch: the
    # full serial seal, which also remains the automatic per-close
    # fallback whenever adoption cannot apply. drain_batch is how many
    # folded writes accumulate before a background drain fires — bigger
    # batches suit the device kernel, smaller ones keep less residual.
    tree_incremental_seal: bool = True
    tree_drain_batch: int = 256
    # cache_mb bounds the process-wide hot-node cache — the resident
    # set of the out-of-core state plane (state/hotcache.py): lazy
    # trees fault nodes from the NodeStore through this cache and RSS
    # stays near the budget regardless of ledger size
    tree_cache_mb: int = 256
    # fused=1 (default): whole dirty trees hash through the device
    # hasher's fused level-chained pipeline (hash_tree) — digests stay
    # device-resident across levels, ONE readback per tree. fused=0 is
    # the kill-switch: the staged per-level hash_packed path, one
    # round-trip per level — kept as the fused-vs-staged identity leg.
    tree_fused: bool = True

    # -- admission control ([txq]) -----------------------------------------
    # enabled=1: post-verify intake routes through the TxQ (node/txq.py)
    # — a soft per-ledger cap adapted to measured close capacity, an
    # escalating open-ledger fee above it, and a bounded fee-priority
    # queue with per-account sequence chains, replace-by-fee, cheapest-
    # first eviction and close-time promotion. enabled=0 is the
    # kill-switch: the direct-apply path, byte-for-byte.
    txq_enabled: bool = True
    txq_ledgers_in_queue: int = 20    # queue bound = soft cap x this
    txq_account_cap: int = 10         # max queued txs per account
    txq_retry_fee_pct: int = 25       # replace-by-fee bump requirement
    txq_retention_ledgers: int = 20   # queued-entry expiry horizon
    txq_min_cap: int = 256            # soft-cap floor (txs per ledger)
    txq_max_cap: int = 100_000        # soft-cap ceiling
    txq_target_close_ms: float = 2000.0  # close budget the cap targets

    # -- parallel speculation ([spec]) -------------------------------------
    # workers=N (N>1): submitted and TxQ-promoted transactions execute
    # speculatively across an N-worker Block-STM pool with optimistic
    # read validation and ordered commit at the chain's speculation
    # index (engine/specexec.py); the close drains the window before
    # splicing. workers=1 (default) is the kill-switch: the serial
    # inline speculation path, byte-for-byte. mode selects the worker
    # transport: "process" (fork workers around the GIL — the scaling
    # path), "thread" (in-process, GIL-bound — the concurrency-hammer
    # configuration), "manual" (no workers; tests drive seeded
    # schedules). max_retries bounds optimistic re-execution before the
    # committing thread falls back to a serial in-order apply;
    # drain_timeout_s bounds how long a close waits on the pool before
    # completing the window serially itself. transport selects the
    # process-worker wire: "ring" (shared-memory SPSC rings + pickle-free
    # codec) or "pipe". workers=auto resolves at node build
    # (resolve_spec_workers).
    spec_workers: int | str = 1
    spec_mode: str = "process"
    spec_max_retries: int = 3
    spec_drain_timeout_s: float = 10.0
    spec_transport: str = "ring"

    # -- ledger close ([close]) --------------------------------------------
    # delta_replay=1: the open-ledger accept also executes the tx once in
    # close mode against a speculative overlay, recording its read/write
    # sets; the close then splices recorded deltas whose reads still
    # validate instead of re-running the transactor, falling back to the
    # full serial apply per tx on any conflict (engine/deltareplay.py).
    # delta_replay=0 is the always-available serial path.
    close_delta_replay: bool = True

    # -- network identity / trust ([validation_seed], [validators]) --------
    validation_seed: str = ""  # base58 seed; empty = not a validator
    validators: list[str] = field(default_factory=list)  # node public keys
    # same-operator cluster members ([cluster_nodes], ConfigSections.h:40):
    # members relay each other's load-fee reports (mtCLUSTER) so the
    # whole cluster escalates fees together. List the key each member
    # proves in its peer hello — its VALIDATION public when it
    # validates, its node identity public otherwise
    cluster_nodes: list[str] = field(default_factory=list)
    validators_file: str = ""  # local validators.txt ([validators_file])
    validators_site: str = ""  # hosted stellar.txt URL ([validators_site])
    validation_quorum: int = 1  # reference Config.h:406 default sizing
    consensus_threshold: int = 0  # Stellar addition (Config.h:407)

    # -- ops ([sntp_servers], [insight]) -----------------------------------
    sntp_servers: list[str] = field(default_factory=list)  # host[:port]
    insight: str = ""  # '' | 'statsd:host:port[:prefix]'
    # embedded metrics history (node/metrics.py MetricsHistory): bounded
    # ring of instrument snapshots every history_interval seconds kept
    # for history_window seconds, served by the `metrics_history` admin
    # RPC and scraped by the `GET /metrics` Prometheus door. history=0
    # disables sampling (and with it the health watchdog's metric rules).
    insight_history: bool = True
    insight_history_interval: float = 5.0
    insight_history_window: float = 300.0

    # -- tracing plane ([trace]) -------------------------------------------
    # enabled=1 (default): transaction-lifecycle spans recorded into a
    # bounded ring buffer (node/tracer.py), exported via the
    # trace_status/trace_dump admin RPCs (Chrome trace-event JSON) and
    # span-derived stage percentiles through [insight]. sample is the
    # deterministic per-transaction sampling rate (ledger-scoped spans
    # are always recorded); capacity bounds the ring.
    trace_enabled: bool = True
    trace_capacity: int = 16384
    trace_sample: float = 0.125
    # propagate=1 (default): outbound tx/proposal/validation/segment
    # frames carry a TraceContext extension (wire field 60) so spans on
    # different nodes join one causal tree; deterministic per-txid
    # sampling means every node samples the same transactions.
    # propagate=0 is the kill switch: frames are byte-identical to the
    # pre-extension wire, and inbound contexts are stripped on decode.
    trace_propagate: bool = True

    # -- SLO health watchdog + flight recorder ([health]) ------------------
    # node/health.py: EWMA/threshold rules over the metrics history —
    # close cadence stalls/drift, validation lag, fanout delivery p99,
    # verify/hash routing flips, cache hit collapse, persist backlog —
    # surfacing ok/warn/critical (with reasons) in server_state and
    # get_counts, plus an always-on bounded flight recorder dumped to
    # disk on crash, degradation to TRACKING, or health transitions.
    health_enabled: bool = True
    health_stall_warn_s: float = 12.0
    health_stall_crit_s: float = 45.0
    health_drift_factor: float = 2.5
    health_lag_warn: int = 4
    health_lag_crit: int = 16
    health_fanout_p99_warn_ms: float = 250.0
    health_flips_warn: int = 8
    health_cache_hit_warn: float = 0.10
    health_persist_depth_warn: float = 512.0
    health_flight_dir: str = ""  # '' = <database_path>/flight
    health_flight_spans: int = 2048

    # -- subscription fanout ([subs]) --------------------------------------
    # shards=N partitions InfoSub/RPCSub event delivery across N worker
    # threads (subscribers pinned to one shard so per-client order
    # holds); 0 delivers inline on the publishing thread (the legacy
    # path — one slow consumer then stalls publish for everyone).
    # sendq_cap bounds each client's pending-event queue (drop-OLDEST
    # on overflow: a slow reader sees a gap, never a stale stream);
    # evict_drops is the consecutive-drop threshold after which a slow
    # consumer is evicted outright. Counters ride get_counts `subs`.
    subs_shards: int = 4
    subs_sendq_cap: int = 512
    subs_evict_drops: int = 64
    # RPCSub HTTP-push retry (reference RPCSub keeps a retry deque):
    # bounded attempts with exponential backoff + jitter per event
    subs_push_retries: int = 5
    # resume_horizon=N keeps the last N published ledgerClosed events in
    # a bounded replay ring: a reconnecting client presents its
    # last-delivered seq and replays the gap instead of re-subscribing
    # cold; a cursor past the horizon gets an explicit cold-resubscribe
    # answer, never a silent gap (doc/follower.md). 0 disables resume.
    subs_resume_horizon: int = 1024

    # -- liquidity plane ([paths]) -----------------------------------------
    # The production path_find read plane (paths/plane.py):
    # enabled=0 removes the plane entirely (path RPCs fall back to the
    # on-demand per-request library). incremental=0 is the kill-switch
    # that forces a full OrderBookDB rebuild per close, pinned
    # result-identical to the incremental write-set advance.
    # device_prune=0 disables the device-batched candidate pre-ranking;
    # prune_floor/prune_keep bound when/how it prunes (sets at or below
    # the floor are never touched). max_updates_per_close caps how many
    # path subscriptions re-rank per validated close (the rest shed,
    # stalest-first next close). mesh/min_device_batch/routing shape the
    # evaluator's host/1-chip/N-chip routing exactly like
    # [hash_backend]'s (parse_mesh values; routing cost|device|host).
    paths_enabled: bool = True
    paths_incremental: bool = True
    paths_device_prune: bool = True
    paths_prune_floor: int = 64
    paths_prune_keep: int = 32
    paths_max_updates_per_close: int = 256
    paths_mesh: str = "0"
    # a cuda node pre-ranks every candidate batch on K4 (device, floor
    # 1); routing=cost sends batches under the floor, or where the host
    # measures cheaper, to NumPy
    paths_min_device_batch: int = 1
    paths_routing: str = "device"

    # -- validated-seq result cache ([rpc_cache]) --------------------------
    # whole-result memo for the hot read RPCs (account_info,
    # book_offers, ledger, account_tx), keyed by validated ledger seq —
    # entries are immutable by construction and a new validated seq
    # invalidates the whole generation (rpc/readplane.py). size=0 off.
    rpc_cache_size: int = 8192

    # -- API doors ([rpc_*], [websocket_*]) --------------------------------
    rpc_ip: str = "127.0.0.1"
    rpc_port: Optional[int] = None  # None = disabled, 0 = ephemeral
    # connections from these source IPs get ADMIN role (reference:
    # [rpc_admin_allow]); everything else is GUEST
    admin_ips: list[str] = field(default_factory=lambda: ["127.0.0.1", "::1"])
    websocket_ip: str = "127.0.0.1"
    websocket_port: Optional[int] = None  # None = disabled, 0 = ephemeral
    # TLS on the API doors (reference [rpc_secure]/[websocket_secure],
    # ConfigSections.h:85-86 + Config.cpp:475-492). Cert/key paths are
    # optional: empty means auto-generate a self-signed transport cert in
    # the state dir (same machinery as the peer links, overlay/peertls.py)
    rpc_secure: int = 0
    rpc_ssl_cert: str = ""  # [rpc_ssl_cert]
    rpc_ssl_key: str = ""  # [rpc_ssl_key]
    websocket_secure: int = 0
    websocket_ssl_cert: str = ""  # [websocket_ssl_cert]
    websocket_ssl_key: str = ""  # [websocket_ssl_key]

    # -- overlay ([peer_ip]/[peer_port]/[ips]/[overlay]) -------------------
    peer_ip: str = "127.0.0.1"
    peer_port: int = 0  # 0 = disabled
    ips: list[str] = field(default_factory=list)  # bootstrap peers host:port
    # [overlay] defense plane (doc/overlay.md): squelch= is the relay
    # subset size per validator (0 = full flood, the kill-switch that
    # reproduces pre-squelch behavior byte-for-byte);
    # squelch_rotate= ledgers per subset rotation epoch; sendq_cap=
    # bounds each peer's outbound queue (drop-oldest on overflow, 0 =
    # built-in default) and sendq_evict_drops= is the consecutive-drop
    # threshold that evicts a wedged peer; rpc_resource= prices RPC
    # clients with the peer charge schedule (admin IPs exempt)
    overlay_squelch: int = 8
    overlay_squelch_rotate: int = 16
    overlay_sendq_cap: int = 0
    overlay_sendq_evict_drops: int = 0
    overlay_rpc_resource: bool = True
    # [peer_ssl]: "" = plaintext, "allow" = TLS out + autodetect in,
    # "require" = TLS only (plaintext peers refused). Reference peers are
    # always SSL (PeerImp.h:88-90); "allow" exists for mixed-net upgrades.
    peer_ssl: str = ""
    # test-net accelerator: virtual seconds per real second for the
    # overlay clock (consensus windows shrink accordingly; 1.0 = live)
    clock_speed: float = 1.0

    # -- ops ([node_size], fees, [debug_logfile]) --------------------------
    node_size: str = "tiny"  # tiny|small|medium|large|huge (thread sizing)
    fee_default: int = 10
    debug_logfile: str = ""  # full-severity log mirror on disk
    network_time_offset: int = 0

    @classmethod
    def from_ini(cls, text: str) -> "Config":
        s = parse_ini_sections(text)
        cfg = cls()

        def one(name: str, default: str = "") -> str:
            vals = s.get(name, [])
            return vals[0] if vals else default

        if "standalone" in s:
            cfg.standalone = one("standalone", "1") not in ("0", "false", "no")
        cfg.start_up = one("start_up", cfg.start_up).lower()
        node_sec = _kv(s.get("node", []))
        if "mode" in node_sec:
            cfg.node_mode = node_sec["mode"].lower()
            if cfg.node_mode not in ("validator", "follower", "archive"):
                # a mode toggle must not fail open into a validator that
                # proposes when the operator believes it is read-only
                raise ValueError(
                    f"[node] mode must be validator/follower/archive, "
                    f"got {cfg.node_mode!r}"
                )
        # upstream= repeats (one "host port" line per upstream, like
        # [ips]); _kv would collapse duplicates so collect them raw
        upstreams = [
            line.split("=", 1)[1].strip()
            for line in s.get("node", [])
            if "=" in line and line.split("=", 1)[0].strip() == "upstream"
        ]
        if upstreams:
            if cfg.node_mode not in ("follower", "archive"):
                # an upstream on a validator would parse clean and be
                # silently dropped — the dead-config class again
                raise ValueError(
                    "[node] upstream= only applies to mode=follower/archive"
                )
            cfg.node_upstream = upstreams
        archive_sec = _kv(s.get("archive", []))
        if archive_sec:
            if cfg.node_mode != "archive":
                # [archive] on a validator/follower would parse clean
                # and be silently dropped — the dead-config class again
                raise ValueError(
                    "[archive] only applies to [node] mode=archive"
                )
            _reject_unknown("archive", archive_sec,
                            ("path", "backfill", "rescan_s"))
            cfg.archive_path = archive_sec.get("path", cfg.archive_path)
            if "backfill" in archive_sec:
                cfg.archive_backfill = int(archive_sec["backfill"])
            if "rescan_s" in archive_sec:
                cfg.archive_rescan_s = float(archive_sec["rescan_s"])
                if cfg.archive_rescan_s <= 0:
                    raise ValueError(
                        "[archive] rescan_s must be positive"
                    )
        if one("ledger_history"):
            cfg.ledger_history = int(one("ledger_history"))

        node_db = _kv(s.get("node_db", []))
        cfg.node_db_type = node_db.get("type", cfg.node_db_type).lower()
        cfg.node_db_path = node_db.get("path", cfg.node_db_path)
        cfg.node_db_compression = node_db.get(
            "compression", cfg.node_db_compression).lower()
        if "durability" in node_db:
            cfg.node_db_durability = node_db["durability"].lower()
            if cfg.node_db_durability not in ("fsync", "batch", "async"):
                # a durability toggle must not fail open into a default
                raise ValueError(
                    f"[node_db] durability must be fsync/batch/async, "
                    f"got {cfg.node_db_durability!r}"
                )
        for key, attr, conv in (
            ("group_commit_ms", "node_db_group_commit_ms", float),
            ("segment_mb", "node_db_segment_mb", int),
            ("checkpoint_mb", "node_db_checkpoint_mb", int),
            ("compact_ratio", "node_db_compact_ratio", float),
            ("online_delete", "node_db_online_delete", int),
            ("sql_trim", "node_db_sql_trim", int),
            ("online_delete_interval", "node_db_online_delete_interval",
             int),
        ):
            if key in node_db:
                setattr(cfg, attr, conv(node_db[key]))
        cfg.node_db_shards = node_db.get("shards", cfg.node_db_shards)
        cfg.node_db_synchronous = node_db.get(
            "synchronous", cfg.node_db_synchronous).lower()
        cfg.database_path = one("database_path", cfg.database_path)

        sig = _kv(s.get("signature_backend", []))
        _reject_unknown("signature_backend", sig, (
            "type", "window_ms", "max_batch", "min_device_batch", "mesh",
            "routing", "device", "device_first_timeout_s",
            "device_warm_timeout_s",
        ))
        cfg.signature_backend = _backend_type(
            "signature_backend",
            sig.get("type", one("signature_backend", cfg.signature_backend)),
        )
        if "device" in sig:
            cfg.verify_device = sig["device"].strip().lower()
        if "window_ms" in sig:
            cfg.verify_batch_window_ms = float(sig["window_ms"])
        if "max_batch" in sig:
            cfg.verify_max_batch = int(sig["max_batch"])
        if "min_device_batch" in sig:
            cfg.verify_min_device_batch = int(sig["min_device_batch"])
        if "device_first_timeout_s" in sig:
            cfg.verify_device_first_timeout_s = float(
                sig["device_first_timeout_s"]
            )
        if "device_warm_timeout_s" in sig:
            cfg.verify_device_warm_timeout_s = float(
                sig["device_warm_timeout_s"]
            )
        cfg.verify_mesh = _crypto_mesh(
            "signature_backend", cfg.signature_backend, sig, cfg.verify_mesh
        )
        cfg.verify_routing = _crypto_routing("signature_backend", sig,
                                             cfg.verify_routing)
        _crypto_backend_gate(
            "signature_backend", cfg.signature_backend, sig,
            device_only=("routing", "device", "device_first_timeout_s",
                         "device_warm_timeout_s"),
        )
        hsh = _kv(s.get("hash_backend", []))
        _reject_unknown("hash_backend", hsh, (
            "type", "mesh", "routing", "min_device_nodes", "device",
            "device_first_timeout_s",
        ))
        cfg.hash_backend = _backend_type(
            "hash_backend",
            hsh.get("type", one("hash_backend", cfg.hash_backend)),
        )
        if "device" in hsh:
            cfg.hash_device = hsh["device"].strip().lower()
        if "min_device_nodes" in hsh:
            cfg.hash_min_device_nodes = int(hsh["min_device_nodes"])
        if "device_first_timeout_s" in hsh:
            cfg.hash_device_first_timeout_s = float(
                hsh["device_first_timeout_s"]
            )
        cfg.hash_mesh = _crypto_mesh(
            "hash_backend", cfg.hash_backend, hsh, cfg.hash_mesh
        )
        cfg.hash_routing = _crypto_routing("hash_backend", hsh,
                                           cfg.hash_routing)
        _crypto_backend_gate(
            "hash_backend", cfg.hash_backend, hsh,
            device_only=("routing", "min_device_nodes", "device",
                         "device_first_timeout_s"),
        )
        cfg.kernel_tuning = one("kernel_tuning", cfg.kernel_tuning)
        cp = _kv(s.get("close_pipeline", []))
        if "enabled" in cp:
            cfg.close_pipeline_enabled = cp["enabled"].lower() not in (
                "0", "false", "no", "off"
            )
        if "depth" in cp:
            cfg.close_pipeline_depth = int(cp["depth"])
        txq = _kv(s.get("txq", []))
        if "enabled" in txq:
            cfg.txq_enabled = txq["enabled"].lower() not in (
                "0", "false", "no", "off"
            )
        for key, attr, conv in (
            ("ledgers_in_queue", "txq_ledgers_in_queue", int),
            ("account_cap", "txq_account_cap", int),
            ("retry_fee_pct", "txq_retry_fee_pct", int),
            ("retention_ledgers", "txq_retention_ledgers", int),
            ("min_cap", "txq_min_cap", int),
            ("max_cap", "txq_max_cap", int),
            ("target_close_ms", "txq_target_close_ms", float),
        ):
            if key in txq:
                setattr(cfg, attr, conv(txq[key]))
        spec = _kv(s.get("spec", []))
        if "workers" in spec:
            v = spec["workers"].strip().lower()
            if v == "auto":
                cfg.spec_workers = "auto"
            else:
                try:
                    cfg.spec_workers = int(v)
                except ValueError:
                    # dead-config-seam convention: a typo'd knob raises
                    # at build ("atuo" must not silently mean serial)
                    raise ValueError(
                        f"[spec] workers must be an integer or 'auto', "
                        f"got {spec['workers']!r}"
                    ) from None
        if "transport" in spec:
            cfg.spec_transport = spec["transport"].lower()
            if cfg.spec_transport not in ("ring", "pipe"):
                raise ValueError(
                    f"[spec] transport must be ring/pipe, "
                    f"got {cfg.spec_transport!r}"
                )
        if "mode" in spec:
            cfg.spec_mode = spec["mode"].lower()
            if cfg.spec_mode not in ("process", "thread", "manual"):
                # a parallelism toggle must not fail open into an
                # unintended transport
                raise ValueError(
                    f"[spec] mode must be process/thread/manual, "
                    f"got {cfg.spec_mode!r}"
                )
        if "max_retries" in spec:
            cfg.spec_max_retries = int(spec["max_retries"])
        if "drain_timeout_s" in spec:
            cfg.spec_drain_timeout_s = float(spec["drain_timeout_s"])
        close = _kv(s.get("close", []))
        if "delta_replay" in close:
            cfg.close_delta_replay = close["delta_replay"].lower() not in (
                "0", "false", "no", "off"
            )
        tree = _kv(s.get("tree", []))
        if "incremental" in tree:
            cfg.tree_incremental_seal = tree["incremental"].lower() not in (
                "0", "false", "no", "off"
            )
        if "drain_batch" in tree:
            cfg.tree_drain_batch = int(tree["drain_batch"])
        if "cache_mb" in tree:
            cfg.tree_cache_mb = int(tree["cache_mb"])
        if "fused" in tree:
            cfg.tree_fused = tree["fused"].lower() not in (
                "0", "false", "no", "off"
            )

        subs = _kv(s.get("subs", []))
        for key, attr in (
            ("shards", "subs_shards"),
            ("sendq_cap", "subs_sendq_cap"),
            ("evict_drops", "subs_evict_drops"),
            ("push_retries", "subs_push_retries"),
            ("resume_horizon", "subs_resume_horizon"),
        ):
            if key in subs:
                setattr(cfg, attr, int(subs[key]))
        rpc_cache = _kv(s.get("rpc_cache", []))
        if "size" in rpc_cache:
            cfg.rpc_cache_size = int(rpc_cache["size"])

        paths = _kv(s.get("paths", []))
        _reject_unknown("paths", paths, (
            "enabled", "incremental", "device_prune", "prune_floor",
            "prune_keep", "max_updates_per_close", "mesh",
            "min_device_batch", "routing",
        ))
        for key, attr in (
            ("enabled", "paths_enabled"),
            ("incremental", "paths_incremental"),
            ("device_prune", "paths_device_prune"),
        ):
            if key in paths:
                setattr(cfg, attr, paths[key].lower() not in (
                    "0", "false", "no", "off"
                ))
        for key, attr in (
            ("prune_floor", "paths_prune_floor"),
            ("prune_keep", "paths_prune_keep"),
            ("max_updates_per_close", "paths_max_updates_per_close"),
            ("min_device_batch", "paths_min_device_batch"),
        ):
            if key in paths:
                setattr(cfg, attr, int(paths[key]))
        if "mesh" in paths:
            from ..crypto.backend import parse_mesh

            cfg.paths_mesh = parse_mesh(paths["mesh"])
        if "routing" in paths:
            routing = paths["routing"].strip().lower()
            if routing not in ("cost", "device", "host"):
                # a routing toggle must not silently fail open
                raise ValueError(
                    f"[paths] routing must be cost|device|host, "
                    f"got {paths['routing']!r}"
                )
            cfg.paths_routing = routing

        cfg.validation_seed = one("validation_seed", cfg.validation_seed)
        cfg.sntp_servers = [line.split()[0] for line in s.get("sntp_servers", [])]
        cfg.validators_file = one("validators_file", cfg.validators_file)
        cfg.validators_site = one("validators_site", cfg.validators_site)
        # [insight] is a hybrid section: the legacy bare collector line
        # ('statsd:host:port[:prefix]') plus key=value history knobs
        insight_lines = s.get("insight", [])
        bare = [ln for ln in insight_lines if "=" not in ln]
        if bare:
            cfg.insight = bare[0]
        ikv = _kv(insight_lines)
        _reject_unknown("insight", ikv, (
            "history", "history_interval", "history_window",
        ))
        if "history" in ikv:
            cfg.insight_history = ikv["history"].lower() not in (
                "0", "false", "no", "off"
            )
        if "history_interval" in ikv:
            cfg.insight_history_interval = float(ikv["history_interval"])
        if "history_window" in ikv:
            cfg.insight_history_window = float(ikv["history_window"])
        trace = _kv(s.get("trace", []))
        _reject_unknown("trace", trace, (
            "enabled", "capacity", "sample", "propagate",
        ))
        if "enabled" in trace:
            cfg.trace_enabled = trace["enabled"].lower() not in (
                "0", "false", "no", "off"
            )
        if "capacity" in trace:
            cfg.trace_capacity = int(trace["capacity"])
        if "sample" in trace:
            cfg.trace_sample = float(trace["sample"])
        if "propagate" in trace:
            cfg.trace_propagate = trace["propagate"].lower() not in (
                "0", "false", "no", "off"
            )
        health = _kv(s.get("health", []))
        _reject_unknown("health", health, (
            "enabled", "stall_warn_s", "stall_crit_s", "drift_factor",
            "lag_warn", "lag_crit", "fanout_p99_warn_ms", "flips_warn",
            "cache_hit_warn", "persist_depth_warn", "flight_dir",
            "flight_spans",
        ))
        if "enabled" in health:
            cfg.health_enabled = health["enabled"].lower() not in (
                "0", "false", "no", "off"
            )
        for key, attr, conv in (
            ("stall_warn_s", "health_stall_warn_s", float),
            ("stall_crit_s", "health_stall_crit_s", float),
            ("drift_factor", "health_drift_factor", float),
            ("lag_warn", "health_lag_warn", int),
            ("lag_crit", "health_lag_crit", int),
            ("fanout_p99_warn_ms", "health_fanout_p99_warn_ms", float),
            ("flips_warn", "health_flips_warn", int),
            ("cache_hit_warn", "health_cache_hit_warn", float),
            ("persist_depth_warn", "health_persist_depth_warn", float),
            ("flight_spans", "health_flight_spans", int),
        ):
            if key in health:
                setattr(cfg, attr, conv(health[key]))
        if "flight_dir" in health:
            cfg.health_flight_dir = health["flight_dir"]
        cfg.validators = [
            line.split()[0] for line in s.get("validators", [])
        ]  # reference allows trailing comments per line
        cfg.cluster_nodes = [
            line.split()[0] for line in s.get("cluster_nodes", [])
        ]
        if one("validation_quorum"):
            cfg.validation_quorum = int(one("validation_quorum"))
        if one("consensus_threshold"):
            cfg.consensus_threshold = int(one("consensus_threshold"))

        if one("rpc_ip"):
            cfg.rpc_ip = one("rpc_ip")
        if s.get("rpc_admin_allow"):
            cfg.admin_ips = list(s["rpc_admin_allow"])
        if one("rpc_port"):
            cfg.rpc_port = int(one("rpc_port"))
        if one("websocket_ip"):
            cfg.websocket_ip = one("websocket_ip")
        if one("websocket_port"):
            cfg.websocket_port = int(one("websocket_port"))
        if one("rpc_secure"):
            cfg.rpc_secure = int(one("rpc_secure"))
        cfg.rpc_ssl_cert = one("rpc_ssl_cert", cfg.rpc_ssl_cert)
        cfg.rpc_ssl_key = one("rpc_ssl_key", cfg.rpc_ssl_key)
        if one("websocket_secure"):
            cfg.websocket_secure = int(one("websocket_secure"))
        cfg.websocket_ssl_cert = one(
            "websocket_ssl_cert", cfg.websocket_ssl_cert
        )
        cfg.websocket_ssl_key = one("websocket_ssl_key", cfg.websocket_ssl_key)
        if one("peer_ip"):
            cfg.peer_ip = one("peer_ip")
        if one("peer_port"):
            cfg.peer_port = int(one("peer_port"))
        cfg.ips = list(s.get("ips", []))
        ov = _kv(s.get("overlay", []))
        for key, attr in (
            ("squelch", "overlay_squelch"),
            ("squelch_rotate", "overlay_squelch_rotate"),
            ("sendq_cap", "overlay_sendq_cap"),
            ("sendq_evict_drops", "overlay_sendq_evict_drops"),
        ):
            if key in ov:
                setattr(cfg, attr, int(ov[key]))
        if "rpc_resource" in ov:
            cfg.overlay_rpc_resource = ov["rpc_resource"].lower() not in (
                "0", "false", "no", "off"
            )
        if one("peer_ssl"):
            cfg.peer_ssl = one("peer_ssl").lower()
            if cfg.peer_ssl not in ("", "allow", "require"):
                # a security toggle must not fail open: an unrecognized
                # value running plaintext while the operator believes TLS
                # is on would be silent downgrade
                raise ValueError(
                    f"[peer_ssl] must be 'allow' or 'require', "
                    f"got {cfg.peer_ssl!r}"
                )
        if one("clock_speed"):
            cfg.clock_speed = float(one("clock_speed"))
        if one("network_time_offset"):
            cfg.network_time_offset = int(one("network_time_offset"))

        cfg.node_size = one("node_size", cfg.node_size).lower()
        if one("fee_default"):
            cfg.fee_default = int(one("fee_default"))
        cfg.debug_logfile = one("debug_logfile", cfg.debug_logfile)
        cfg.check_ported()
        return cfg

    def check_ported(self) -> None:
        """Raise if this config turns on a plane this package does not
        have. Called by ``from_ini`` and by ``Node``, so a Config built
        in code is held to the same rule as a parsed one."""
        unported = []
        if self.kernel_tuning.strip().lower() not in ("", "none", "off"):
            unported.append(f"[kernel_tuning] {self.kernel_tuning}")
        from ..crypto.backend import parse_mesh

        for width in (self.verify_mesh, self.hash_mesh, self.paths_mesh):
            parse_mesh(width)
        _backend_type("signature_backend", self.signature_backend)
        _backend_type("hash_backend", self.hash_backend)
        if unported:
            raise ValueError(
                "not part of this package: " + "; ".join(unported)
            )

    def verify_backend_opts(self) -> dict:
        """Factory kwargs for make_verifier, built from the
        [signature_backend] section — the plumbing that makes backend
        options (mesh width, batch bounds, device) reachable from a cfg
        file. Unknown keys fail loudly inside make_verifier."""
        if self.signature_backend == "cuda":
            return {
                "mesh": self.verify_mesh,
                "max_batch": self.verify_max_batch,
                "device": self.verify_device,
            }
        return {}

    def thread_count(self) -> int:
        """reference: JobQueue thread heuristic from [node_size]
        (Config::getSize / Application.cpp). Standalone uses a small pool
        (the reference uses 0=caller-runs; we keep one worker so async
        submission still works)."""
        if self.standalone:
            return 1
        return {"tiny": 2, "small": 4, "medium": 6, "large": 8, "huge": 12}.get(
            self.node_size, 4
        )
