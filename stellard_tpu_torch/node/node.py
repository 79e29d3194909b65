"""Node: the application container of the standalone or networked node.

Reference: src/ripple_app/main/Application.cpp — ApplicationImp owns ~35
subsystems wired in constructor order (:257-365) with setup() (:659-917)
and run(); here the container is small because the build splits into a
host protocol machine + a device crypto plane on the card (K1 verifies,
K2/K3 hash, K4 pre-ranks paths), but the wiring order (storage → crypto
plane → executor → ledger chain → brain → API doors) mirrors the
reference.

This is the JAX package's ``Node`` as a standalone node or as a
networked validator: with ``[peer_port]`` and ``[standalone] 0`` it
joins a TCP net (``overlay/tcp.py``), whose ``ValidatorNode`` owns the
ledger chain, and it may take its clock from SNTP and its UNL from a
validators file or site. Its state is out of core: ``[start_up] load``
resumes the chain lazily (the header and two roots are read; every other
node faults through the hot-node cache, ``[tree] cache_mb``), and so do
the history fallback and historical reads. ``[node_db] online_delete=``
sweeps retired history, sealing it first into history shards with
``[node_db] shards=``, and the ledger cleaner checks stored ledgers.

Fleet roles: ``[node] mode=follower`` joins the net without proposing,
adopts every validated ledger (each acquired tree node's hash checked
on the hasher, every trusted validation on the verify plane) and serves
reads from the validated snapshot; ``mode=archive`` is a follower that
also backfills the validators' sealed history shards over the
``GetSegments`` door (node/archive.py) into a txdb that never trims.
``[node] upstream=`` pins either to named peers. A flight recorder is
always on and, with ``[health] enabled`` (the default), a health
watchdog (node/health.py) rides the metrics history. ``[spec]
workers>1`` (or ``auto``) runs the open window's speculation on the
parallel executor's Block-STM worker pool (engine/specexec.py), whose
process workers fork before anything else of the node starts a thread
or touches the card.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from ..nodestore.core import make_database
from ..protocol.keys import KeyPair, decode_seed
from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from ..state.ledger import Ledger
from ..utils import gcpolicy
from .config import Config
from .hashrouter import HashRouter
from .jobqueue import JobQueue
from .ledgermaster import LedgerMaster
from .networkops import NetworkOPs, TxStatus
from .txdb import TxDatabase
from .verifyplane import VerifyPlane

__all__ = ["Node"]

# reference: the well-known test genesis passphrase ("masterpassphrase")
MASTER_PASSPHRASE = "masterpassphrase"


def _parse_host_port(entry: str, default_port: int) -> Optional[tuple[str, int]]:
    """One "host port" / "host:port" / bare-host entry -> (host, port).
    A colon is only a separator when it appears exactly once — an IPv6
    literal like ::1 stays a bare host (reference Config.cpp IPS rules).
    Returns None for malformed entries (callers skip, never crash)."""
    entry = entry.strip()
    if not entry:
        return None
    if " " in entry:
        host, _, port = entry.partition(" ")
    elif entry.count(":") == 1:
        host, _, port = entry.partition(":")
    else:
        host, port = entry, ""
    try:
        return (host.strip(), int(port) if port else default_port)
    except ValueError:
        return None


def _parse_peer_addrs(ips: list[str]) -> list[tuple[str, int]]:
    """[ips] entries -> (host, port) dial pairs."""
    out = []
    for entry in ips:
        pair = _parse_host_port(entry, 51235)
        if pair is not None:
            out.append(pair)
    return out


def _results_from_meta(ledger: Ledger) -> dict:
    """{txid: TER} recovered from each committed tx's sfTransactionResult
    metadata byte — for ledgers adopted from the net (never applied
    locally, so no local results exist)."""
    from ..protocol.sfields import sfTransactionResult
    from ..protocol.stobject import STObject

    out = {}
    for txid, _blob, meta in ledger.tx_entries():
        if not meta:
            continue
        try:
            code = STObject.from_bytes(meta).get(sfTransactionResult)
            if code is not None:
                out[txid] = TER(code)
        except Exception:  # noqa: BLE001 — unparseable meta: skip this tx
            continue
    return out


def build_tx_rows(ledger: Ledger, results: dict) -> list[tuple]:
    """Materialize a closed ledger's txdb rows, reusing the close pass's
    parsed_txs/parsed_metas memos instead of re-parsing blobs. Pure
    Python tail work: close_and_advance runs it overlapped with the seal
    tree-hash (LedgerMaster.persist_prep), and the close pipeline's txdb
    stage falls back to it for adopted/repaired ledgers."""
    from ..protocol.meta import affected_accounts

    rows = []
    for txn_seq, (txid, blob, meta) in enumerate(ledger.tx_entries()):
        tx = ledger.parse_tx(txid, blob)
        meta_src = ledger.parsed_metas.get(txid, meta)
        affected = affected_accounts(meta_src) if meta else [tx.account]
        rows.append((
            txid,
            tx.tx_type.name,
            tx.account,
            tx.sequence,
            ledger.seq,
            _result_token(txid, results, meta),
            blob,
            meta,
            affected,
            txn_seq,
        ))
    return rows


def _result_token(txid: bytes, results: dict, meta: Optional[bytes]) -> str:
    """TER token for a committed tx: the local apply result when we
    closed the round ourselves, else the sfTransactionResult byte from
    the tx metadata (catch-up-adopted ledgers were not applied locally,
    and recording a blanket tesSUCCESS would misreport tec-class txs)."""
    if txid in results:
        return TER(results[txid]).token
    if meta:
        try:
            from ..protocol.sfields import sfTransactionResult
            from ..protocol.stobject import STObject

            code = STObject.from_bytes(meta).get(sfTransactionResult)
            if code is not None:
                return TER(code).token
        except Exception:  # noqa: BLE001 — unparseable meta: fall through
            pass
    return TER.tesSUCCESS.token


class Node:
    """One stellard node. Construct → setup() → (serve / drive)."""

    def __init__(self, config: Optional[Config] = None):
        self.config = config or Config()
        cfg = self.config
        # a plane this package does not have must not be turned on by a
        # Config built in code either (from_ini checks the parsed ones)
        cfg.check_ported()

        # tracing plane FIRST ([trace]): every subsystem below records
        # its lifecycle spans into this node's ring (node/tracer.py);
        # trace_status/trace_dump serve it, [insight] ships span-derived
        # stage percentiles
        from .tracer import Tracer

        self.tracer = Tracer.from_config(cfg)

        # [spec]: parallel speculative executor — workers>1 dispatches
        # open-window speculation to a Block-STM worker pool with
        # optimistic validation and ordered commit (engine/specexec.py);
        # workers=1 keeps the serial inline path byte-for-byte.
        # workers=auto resolves HERE (loudly disabling the pool below 4
        # cores); transport picks the shared-memory ring wire or the
        # pickled pipe. The process workers fork NOW, before anything of
        # this node starts a thread or touches the card (the verify
        # plane's K1 prewarm, the watched hasher): a fork while another
        # thread is inside CUDA leaves that thread's locks held in the
        # child. The JAX node forks later, after its prewarm; only the
        # start order differs, and nothing observable changes.
        import logging

        from ..engine.specexec import SpecExecutor
        from .config import resolve_spec_workers

        self.spec_executor = SpecExecutor(
            workers=resolve_spec_workers(
                cfg.spec_workers, log=logging.getLogger("stellard.spec")),
            mode=cfg.spec_mode,
            max_retries=cfg.spec_max_retries, tracer=self.tracer,
            drain_timeout_s=cfg.spec_drain_timeout_s,
            transport=cfg.spec_transport,
        )
        if self.spec_executor.active:
            self.spec_executor.start()
        try:
            self._build_planes(cfg)
        except BaseException:
            # a node that fails to build leaves no worker behind
            self.spec_executor.stop()
            raise

    def _build_planes(self, cfg: Config) -> None:
        """Everything of ``__init__`` after the tracer and the pool."""
        # storage plane (reference: NodeStore Manager + main db :330)
        db_kwargs = {}
        if cfg.node_db_path:
            db_kwargs["path"] = cfg.node_db_path
        if cfg.node_db_compression and cfg.node_db_type == "cpplog":
            db_kwargs["compression"] = cfg.node_db_compression
        if cfg.node_db_type == "segstore":
            db_kwargs.update(
                durability=cfg.node_db_durability,
                group_commit_ms=cfg.node_db_group_commit_ms,
                segment_bytes=cfg.node_db_segment_mb << 20,
                checkpoint_bytes=cfg.node_db_checkpoint_mb << 20,
                compact_ratio=cfg.node_db_compact_ratio,
                tracer=self.tracer,
            )
        if cfg.node_db_type == "sqlite" and cfg.node_db_synchronous:
            db_kwargs["synchronous"] = cfg.node_db_synchronous
        self.nodestore = make_database(type=cfg.node_db_type, **db_kwargs)
        # [node] mode=archive (doc/archive.md): the full-history
        # reporting tier — follower ingest + deep-history shard
        # backfill + a txdb that NEVER trims + forever-cached
        # immutable-seq results
        self.archive = cfg.node_mode == "archive"
        if self.archive:
            from .archive import ArchiveTxDatabase

            self.txdb = ArchiveTxDatabase(cfg.database_path or ":memory:")
        else:
            self.txdb = TxDatabase(cfg.database_path or ":memory:")

        # out-of-core state plane ([tree] cache_mb): the process-wide
        # hot-node cache is the resident set for lazily-faulted trees —
        # apply the operator's budget before anything loads a ledger
        from ..state.shamap import configure_inner_cache, inner_node_cache

        configure_inner_cache(cfg.tree_cache_mb)
        inner_node_cache().tracer = self.tracer  # `cache.fault` spans

        # history shards ([node_db] shards=): rotation seals retired
        # ranges here instead of discarding them (doc/storage.md)
        self.shardstore = None
        if cfg.node_db_shards:
            from ..nodestore.shards import HistoryShardStore

            shards_path = cfg.node_db_shards
            if shards_path.lower() in ("1", "true", "yes", "on"):
                shards_path = (cfg.node_db_path or "nodestore") + ".shards"
            self.shardstore = HistoryShardStore(shards_path)
        elif self.archive:
            # an archive ALWAYS has a shard store: it is the import
            # target of the backfill, the serving source for deep
            # account_tx, and (via the segment manifest) this node's
            # own advertisement in the shard distribution network —
            # imported shards re-serve downstream ([archive] path=)
            from ..nodestore.shards import HistoryShardStore

            self.shardstore = HistoryShardStore(
                cfg.archive_path
                or (cfg.node_db_path or cfg.database_path or "archive")
                + ".archive-shards"
            )

        # stellar CLF plane: SQL mirror + LCL pointer (reference:
        # stellar::gLedgerMaster + workingledger.db, Application.cpp:716)
        from ..state.clf import CLFMirror, LedgerSqlDatabase

        clf_path = (
            cfg.database_path + ".clf" if cfg.database_path else ":memory:"
        )
        self.clf = CLFMirror(LedgerSqlDatabase(clf_path))

        # ledger-close pipeline: closed ledgers persist on a bounded,
        # strictly-ordered drain OFF the close path (reference:
        # pendSaveValidated; ordered because concurrent workers could
        # commit ledger N+1's CLF pointer before N's, regressing the
        # resume point). Bounded: a disk that cannot keep up with the
        # close rate back-pressures closes (briefly) instead of pinning
        # an unbounded backlog of whole Ledgers in memory.
        # [close_pipeline] enabled=0 keeps closes on the serial in-line
        # path.
        from .closepipeline import ClosePipeline

        self.close_pipeline = ClosePipeline(
            save_stage=lambda led: led.save(self.nodestore),
            txdb_stage=self._persist_tx_rows,
            clf_stage=self._commit_clf,
            recover_results=_results_from_meta,
            depth=cfg.close_pipeline_depth,
            tracer=self.tracer,
        )

        # online deletion (rippled SHAMapStore online_delete role): a
        # rotation sweep driven from the validated-close stream keeps a
        # validator's disk bounded near the live set ([node_db]
        # online_delete=N; requires a backend with liveness — segstore)
        self.online_deleter = None
        if self.archive and cfg.node_db_online_delete > 0:
            # the archive contract is FULL history; a rotation sweep
            # would silently contradict it (and ArchiveTxDatabase
            # refuses the SQL trim anyway) — reject the config loudly
            raise ValueError(
                "[node_db] online_delete is incompatible with [node] "
                "mode=archive: the archive tier keeps full history "
                "(doc/archive.md)"
            )
        if cfg.node_db_online_delete > 0:
            if not getattr(
                self.nodestore.backend, "supports_online_delete", False
            ):
                raise ValueError(
                    f"[node_db] online_delete requires a backend with "
                    f"liveness accounting (segstore), not "
                    f"{cfg.node_db_type!r}"
                )
            from .ledgercleaner import OnlineDeleter

            self.online_deleter = OnlineDeleter(
                self,
                retain=cfg.node_db_online_delete,
                interval=cfg.node_db_online_delete_interval,
                sql_trim=bool(cfg.node_db_sql_trim),
                shardstore=self.shardstore,
            )

        # crypto plane: cpu | cuda batch backends. The cuda hasher runs
        # under the wedge watchdog (a device call that never returns
        # would freeze every ledger close, utils/devicewatch.py), and
        # every [hash_backend] / [signature_backend] option reaches its
        # factory — routing, floors, device and deadlines are cfg axes,
        # and unknown keys fail loudly at build, never silently no-op.
        # A cuda backend without a card raises here.
        from ..crypto.backend import make_watched_hasher

        self.hasher = make_watched_hasher(
            cfg.hash_backend,
            min_device_nodes=cfg.hash_min_device_nodes,
            mesh=cfg.hash_mesh,
            routing=cfg.hash_routing,
            first_timeout=cfg.hash_device_first_timeout_s,
            device=cfg.hash_device,
        )
        # [tree] fused=0 kill-switch: compute_hashes / the seal drainer
        # fall back to the staged per-level hash_packed path (one
        # round-trip per level) — the fused-vs-staged identity leg
        self.hasher.fused_enabled = cfg.tree_fused
        self.verify_plane = VerifyPlane(
            backend=cfg.signature_backend,
            window_ms=cfg.verify_batch_window_ms,
            max_batch=cfg.verify_max_batch,
            min_device_batch=cfg.verify_min_device_batch,
            backend_opts=cfg.verify_backend_opts(),
            routing=cfg.verify_routing,
            device_first_timeout=cfg.verify_device_first_timeout_s,
            device_warm_timeout=cfg.verify_device_warm_timeout_s,
            tracer=self.tracer,
        )
        self.verify_prewarm: Optional[threading.Thread] = None
        if cfg.signature_backend != "cpu":
            # build K1 and measure its batch sizes in the background;
            # serve() waits for it and fails if it failed
            self.verify_prewarm = self.verify_plane.start_prewarm()

        # executor (reference: JobQueue :287)
        self.job_queue = JobQueue(
            threads=cfg.thread_count(), tracer=self.tracer
        )
        self.hash_router = HashRouter()

        # load plane (reference: LoadFeeTrack :346, LoadManager :354)
        from .loadmgr import LoadFeeTrack, LoadManager

        self.fee_track = LoadFeeTrack()
        self.load_manager = LoadManager(self.job_queue, self.fee_track)

        # admission-control plane ([txq], node/txq.py): soft open-ledger
        # cap + escalating fee + bounded fee-priority queue between the
        # verify plane and the open ledger; wired into NetworkOPs
        # (admit) and LedgerMaster (promotion at _open_next) below
        from .txq import TxQ

        self.txq = TxQ.from_config(
            cfg, fee_track=self.fee_track, tracer=self.tracer
        )

        # trust + anti-DoS planes (reference: UNL :323, PoW factory :352,
        # LedgerCleaner)
        from ..utils.pow import PowFactory
        from .ledgercleaner import LedgerCleaner
        from .unl import UniqueNodeList

        unl_path = cfg.database_path + ".unl" if cfg.database_path else None
        self.unl = UniqueNodeList(unl_path)
        if cfg.validators or cfg.validators_file or cfg.validators_site:
            from ..protocol.keys import decode_node_public
            from .sitefiles import fetch_site_validators, load_validators_file

            def add_keys(pairs, default_comment):
                for key, comment in pairs:
                    try:
                        self.unl.add(
                            decode_node_public(key), comment or default_comment
                        )
                    except (ValueError, KeyError):
                        import logging

                        logging.getLogger("stellard.unl").warning(
                            "skipping malformed validator key from %s: %r",
                            default_comment, key,
                        )

            # the INLINE config is operator-written: a malformed key there
            # is a misconfiguration that must fail loudly, not shrink the
            # trusted set silently
            for v in cfg.validators:
                self.unl.add(decode_node_public(v), "config")
            if cfg.validators_file:
                try:
                    add_keys(load_validators_file(cfg.validators_file), "file")
                except OSError:
                    pass  # a missing file must not kill the node
            if cfg.validators_site:
                # fetched on a background thread: startup must not block
                # on a remote site, and NO exception class from urllib
                # may kill the node (reference fetches sites async too)
                def fetch_site():
                    try:
                        add_keys(
                            fetch_site_validators(cfg.validators_site), "site"
                        )
                    except Exception:  # noqa: BLE001 — log-and-skip source
                        pass

                threading.Thread(
                    target=fetch_site, name="validators-site", daemon=True
                ).start()
        self.pow_factory = PowFactory()
        self.ledger_cleaner = LedgerCleaner(self)

        # ops plane: SNTP network clock + insight metrics (reference:
        # SNTPClient init Application.cpp:698-699, CollectorManager :287)
        from .metrics import CollectorManager
        from .netclock import SntpClient

        self.collector = CollectorManager.from_config(cfg.insight)
        if cfg.insight_history:
            # embedded history: the bounded in-process ring the
            # metrics_history RPC and the GET /metrics door read
            self.collector.enable_history(
                cfg.insight_history_interval, cfg.insight_history_window
            )
        # SLO health plane ([health], node/health.py): always-on flight
        # recorder (black box: recent spans + health transitions +
        # counter snapshots, dumped on crash/degradation) + the EWMA/
        # threshold watchdog riding the metrics-history sample stream
        from .health import _RANK, FlightRecorder, HealthWatchdog

        flight_dir = cfg.health_flight_dir or (
            cfg.database_path + ".flight" if cfg.database_path else ""
        )
        self.flight = FlightRecorder(
            directory=flight_dir, spans_cap=cfg.health_flight_spans
        )
        self.tracer.flight = self.flight
        self._degraded_dump_done = False
        self.health: Optional[HealthWatchdog] = None
        if cfg.health_enabled:
            self.health = HealthWatchdog(
                stall_warn_s=cfg.health_stall_warn_s,
                stall_crit_s=cfg.health_stall_crit_s,
                drift_factor=cfg.health_drift_factor,
                lag_warn=cfg.health_lag_warn,
                lag_crit=cfg.health_lag_crit,
                fanout_p99_warn_ms=cfg.health_fanout_p99_warn_ms,
                flips_warn=cfg.health_flips_warn,
                cache_hit_warn=cfg.health_cache_hit_warn,
                persist_depth_warn=cfg.health_persist_depth_warn,
                tracer=self.tracer,
                flight=self.flight,
            )
            self.collector.on_sample(self.health.on_snapshot)

            def _dump_on_degrade(old, new, reasons):
                # the black box ships when health WORSENS; the recovery
                # transition is an instant in the trace, not a dump
                if _RANK.get(new, 0) > _RANK.get(old, 0):
                    self.flight.dump("health-" + new)

            self.health.on_transition.append(_dump_on_degrade)

        self.sntp: Optional[SntpClient] = None
        if cfg.sntp_servers:
            servers = [
                pair
                for pair in (
                    _parse_host_port(spec, 123) for spec in cfg.sntp_servers
                )
                if pair is not None
            ]
            if servers:
                self.sntp = SntpClient(servers)

        # node identity + validator identity must exist before the overlay
        # (the overlay handshakes and proposes with them)
        self.node_keys = self._load_or_create_identity()
        self.validation_keys: Optional[KeyPair] = None
        if cfg.validation_seed:
            self.validation_keys = KeyPair.from_seed(decode_seed(cfg.validation_seed))

        # overlay plane (reference: ApplicationImp Overlay :300 + Peers
        # start :811): when [peer_port] is configured the node joins a
        # TCP net and the overlay's ValidatorNode OWNS the ledger chain —
        # consensus and the RPC plane then share one LedgerMaster and
        # serialize on one master lock. Every relayed transaction,
        # proposal and validation is verified on the verify plane, every
        # tx set and seal hashed on the hasher.
        self.overlay = None
        # [node] mode=follower (doc/follower.md): the read-only serving
        # tier — no consensus rounds, validated ledgers ingested from
        # the net, reads served from the last validated snapshot.
        # mode=archive (doc/archive.md) runs the follower ingest plane
        # unchanged and layers deep-history backfill on top.
        self.follower = cfg.node_mode in ("follower", "archive")
        if self.follower and (cfg.standalone or not cfg.peer_port):
            raise ValueError(
                f"[node] mode={cfg.node_mode} requires a networked node "
                "([peer_port] set, standalone=0) — it ingests "
                "validated ledgers from its peers"
            )
        if cfg.peer_port and not cfg.standalone:
            self._build_overlay()

        # ledger chain + brain (networked: the overlay's chain IS ours)
        if self.overlay is not None:
            self.ledger_master = self.overlay.node.lm
            # the overlay built its own chain before our tracer existed;
            # repoint it so consensus/close spans land in THIS node's ring
            self.ledger_master.tracer = self.tracer
        else:
            self.ledger_master = LedgerMaster(
                hash_batch=self.hasher, router=self.hash_router,
                tracer=self.tracer,
            )

        def _fetch_fallback(h: bytes):
            # history-cache miss -> the in-flight close-pipeline entry
            # (read-your-writes: a queued-but-unpersisted ledger must
            # never miss), then rebuild from the NodeStore (consensus
            # promotion and peers must see everything persisted)
            led = self.close_pipeline.get(h)
            if led is not None:
                return led
            try:
                # lazy: history reads materialize only the nodes the
                # caller actually touches (out-of-core plane) — opening
                # a stored ledger is O(1), not O(state)
                return Ledger.load(self.nodestore, h,
                                   hash_batch=self.hasher, lazy=True)
            except (KeyError, ValueError):
                return None

        self.ledger_master.fetch_fallback = _fetch_fallback

        from ..state.ledger import parse_header, strip_ledger_prefix

        def _header_fetch(h: bytes):
            # LIGHT resolver for the reindex walk: header bytes only
            led = self.close_pipeline.get(h)  # read-your-writes
            if led is not None:
                return led.seq, led.parent_hash
            obj = self.nodestore.fetch(h)
            if obj is None:
                return None
            try:
                f = parse_header(strip_ledger_prefix(obj.data))
            except (ValueError, IndexError):
                return None
            return f["seq"], f["parent_hash"]

        self.ledger_master.header_fetch = _header_fetch
        # close-path overlap seam: close_and_advance materializes the
        # persist rows (Python meta/row tail) WHILE the two seal threads
        # hash the trees through the hasher
        self.ledger_master.persist_prep = build_tx_rows
        # [close] delta_replay: speculative close-mode execution at
        # submit + optimistic delta splice at close (serial fallback per
        # tx on any read-set conflict)
        self.ledger_master.delta_replay = cfg.close_delta_replay
        # [tree]: incremental O(dirty) seal — speculated writes pre-hash
        # in background batches between closes; the full seal stays the
        # automatic fallback (incremental=0 is the kill-switch)
        self.ledger_master.incremental_seal = cfg.tree_incremental_seal
        self.ledger_master.seal_drain_batch = cfg.tree_drain_batch
        self.ledger_master.spec_executor = self.spec_executor
        # [txq]: the ledger chain promotes queued txs at _open_next and
        # the queue's deferred (off-close-path) speculation rides the
        # job queue
        self.ledger_master.txq = self.txq
        from .jobqueue import JobType as _JT

        self.txq.spec_dispatch = lambda thunk: self.job_queue.add_job(
            _JT.jtTRANSACTION, "txqSpeculate", thunk
        )
        self.ops = NetworkOPs(
            self.ledger_master,
            self.job_queue,
            self.verify_plane,
            self.hash_router,
            standalone=cfg.standalone,
            fee_track=self.fee_track,
            tracer=self.tracer,
            txq=self.txq,
        )
        # configured skew applies to the ops-plane clock too (standalone
        # closes, status, staleness checks); the SNTP heartbeat COMPOSES
        # its measured correction with this base (see run)
        self.ops.net_time_offset = int(cfg.network_time_offset)
        if self.health is not None:
            # close-cadence feed: fires on standalone closes AND on the
            # networked path (publish_closed_ledger after persist), and
            # on follower adoption — one seam covers every mode
            hw2 = self.health
            self.ops.on_ledger_closed.append(
                lambda led, _res: hw2.note_close(led.seq)
            )

        # RPC-door resource pricing ([overlay] rpc_resource=1): one
        # decaying charge balance per CLIENT IP, priced with the peer
        # fee schedule's FEE_*_RPC charges (overlay/resource.py) —
        # abusive RPC clients warn/drop exactly like abusive peers.
        # [rpc_admin_allow] IPs are exempt (the reference never charges
        # admin requests), swept on the maintenance timer below.
        self.rpc_resources = None
        if cfg.overlay_rpc_resource:
            from ..overlay.resource import ResourceManager as _RM

            self.rpc_resources = _RM(admin=set(cfg.admin_ips))

        # read plane (rpc/readplane.py): the serving side's immutable
        # validated-snapshot pointer + validated-seq result cache. Read
        # RPCs resolve "validated" from the pointer (never the chain
        # lock); the hot four read RPCs memoize whole results per
        # validated seq. The snapshot is min(persisted, validated):
        # publish_closed_ledger feeds the persisted floor after its
        # sinks, on_validated below feeds the validated floor.
        from ..rpc.readplane import ReadPlane, ResultCache

        self.read_cache = (
            ResultCache(cfg.rpc_cache_size)
            if cfg.rpc_cache_size > 0 else None
        )
        self.read_plane = ReadPlane(cache=self.read_cache)
        self.ops.read_plane = self.read_plane
        if self.archive:
            # forever-cache eligibility (doc/archive.md): results whose
            # window closes at or below the verified floor are
            # immutable. A restarted archive re-publishes the floor of
            # whatever it already holds before any backfill runs.
            self._update_archive_floor()
        # the validated floor: on a quorum net validations land after
        # the close persisted, and this hook is what opens the epoch
        # (the read plane publishes min(persisted, validated))
        if self.health is None:
            self.ledger_master.on_validated = self.read_plane.note_validated
        else:
            # compose: the read plane opens the epoch, the watchdog's
            # validation-lag rule sees the quorum floor advance
            hw = self.health

            def _note_validated(led):
                self.read_plane.note_validated(led)
                hw.note_validated(led.seq)

            self.ledger_master.on_validated = _note_validated
        # follower consistency contract (doc/follower.md): selector-less
        # read RPCs serve the last VALIDATED snapshot, not the open
        # ledger — the read tier's answers are immutable and identical
        # across every follower at the same validated seq
        self.serve_validated_default = self.follower

        # liquidity plane ([paths], paths/plane.py): the incremental
        # per-close book index + device-routed candidate pre-ranking
        # (K4) + per-subscription staleness/shedding. The close hook
        # advances the index from each close's own write set so both
        # the RPC door and the subscription publisher serve a warm
        # index without ever rescanning unchanged books.
        self.path_plane = None
        if cfg.paths_enabled:
            from ..crypto.backend import make_path_evaluator
            from ..paths.plane import PathPlane

            evaluator = None
            if cfg.paths_device_prune:
                evaluator = make_path_evaluator(
                    mesh=cfg.paths_mesh,
                    min_device_batch=cfg.paths_min_device_batch,
                    routing=cfg.paths_routing,
                    # K4 runs where the hash plane runs: on the card for
                    # a cuda node, as the plain version for a cpu one
                    device=(cfg.hash_device if cfg.hash_backend == "cuda"
                            else "cpu"),
                )
            self.path_plane = PathPlane(
                incremental=cfg.paths_incremental,
                evaluator=evaluator,
                device_prune=cfg.paths_device_prune,
                prune_floor=cfg.paths_prune_floor,
                prune_keep=cfg.paths_prune_keep,
                max_updates_per_close=cfg.paths_max_updates_per_close,
                resources=self.rpc_resources,
            )
            self.ops.on_ledger_closed.append(
                lambda led, results: self.path_plane.note_close(led)
            )
        # hook(ledger, results) for each closed ledger once its
        # node-store, txdb and CLF writes have committed (on the close
        # pipeline's worker when the pipeline is on)
        self.on_persisted: list[Callable[[Ledger, dict], None]] = []
        if self.overlay is not None:
            # one master lock for consensus + RPC over the shared chain,
            # and the relay/local-retry seams (reference: the relay step
            # of NetworkOPs::processTransaction :544-556 + LocalTxs).
            # Persistence rides the overlay's on_ledger hook (which also
            # fires publish_closed_ledger), NOT the sinks below.
            self.ops.master_lock = self.overlay.node.lock
            self.ops.relay_tx = self.overlay.broadcast_tx
            self.ops.local_push = self.overlay.node.local_txs.push_back
            # a queued local tx the admission plane drops (eviction /
            # expiry / promote-drop) must stop re-applying across
            # rounds; a client resubmit then starts a fresh horizon
            self.txq.on_drop = self.overlay.node.local_txs.remove
        elif cfg.close_pipeline_enabled:
            # the ledger-closed sink ENQUEUES — ledger N's NodeStore/
            # txdb/CLF writes overlap ledger N+1's verify/apply
            self.ops.on_ledger_closed.append(self.persist_close)
        else:
            # serial fallback ([close_pipeline] enabled=0): persistence
            # rides the ledger-closed sink in-line, on the close path
            self.ops.on_ledger_closed.append(self._persist_closed_ledger)

        self.master_keys = KeyPair.from_passphrase(MASTER_PASSPHRASE)
        self._running = threading.Event()
        self.started_at = time.monotonic()  # server_info uptime
        self._debug_log_handler = None

        # API doors (started by serve(); reference: WSDoors/RPCDoor
        # Application.cpp:817-891)
        self.http_server = None
        self.ws_server = None
        self.subs = None
        # the collector's policy of a serving node (utils/gcpolicy.py),
        # held from serve() to stop()
        self._gc_held = False

    def _build_overlay(self) -> None:
        """The TCP overlay of a networked node: its clocks, TLS, dial set
        and chain, the catch-up seams on the node store, an archive's
        shard backfill, and persistence through the close pipeline."""
        from ..overlay.tcp import TcpOverlay

        cfg = self.config
        speed = max(cfg.clock_speed, 1e-9)
        clock = None
        ntime = None
        timer_interval = 1.0
        if speed != 1.0:
            t0 = time.monotonic()
            clock = lambda: (time.monotonic() - t0) * speed  # noqa: E731
            # virtual network time is a pure function of WALL time so
            # independently-started peers agree (anchoring to process
            # start would skew peers by (speed-1) x launch offset).
            # Only the delta from a FIXED recent anchor is scaled, so
            # the value stays well inside the u32 close-time wire
            # fields (scaling the whole 2000-epoch offset overflows
            # past speed ~5)
            _ANCHOR = 1_750_000_000  # fixed wall anchor (2025-06-15)
            _BASE = _ANCHOR - 946_684_800
            ntime = lambda: _BASE + int(  # noqa: E731
                (time.time() - _ANCHOR) * speed
            )
            timer_interval = max(0.1, 1.0 / speed)
        if cfg.network_time_offset:
            # deliberate clock skew ([network_time_offset], test-net
            # knob) on the overlay's consensus clock; the ops-plane
            # clock gets the same offset so both agree
            from .networkops import EPOCH_OFFSET

            base_nt = ntime
            if base_nt is None:
                base_nt = (  # noqa: E731
                    lambda: int(time.time()) - EPOCH_OFFSET
                )
            off = int(cfg.network_time_offset)
            ntime = lambda: base_nt() + off  # noqa: E731
        from ..protocol.keys import decode_node_public

        unl_keys = self.unl.publics()
        signer = self.validation_keys or self.node_keys
        peer_tls = None
        if cfg.peer_ssl in ("allow", "require"):
            import tempfile

            from ..overlay.peertls import PeerTLS

            # database_path is a sqlite FILE path; state files hang
            # suffixes off it (.clf/.unl/.wallet) — same here
            tls_dir = (
                cfg.database_path + ".tls"
                if cfg.database_path
                else tempfile.mkdtemp(prefix="stellard-tls-")
            )
            peer_tls = PeerTLS.from_state_dir(
                tls_dir, required=(cfg.peer_ssl == "require")
            )
        # follower trees (doc/follower.md): [node] upstream= names this
        # follower's serving tier — usually a peer FOLLOWER one tier up,
        # not the leader — and replaces [ips] as the dial set, so the
        # leader's egress is bounded by its direct children instead of
        # the whole fleet
        dial_addrs = (
            _parse_peer_addrs(cfg.node_upstream)
            if self.follower and cfg.node_upstream
            else _parse_peer_addrs(cfg.ips)
        )
        self.overlay = TcpOverlay(
            key=signer,
            unl=unl_keys,
            quorum=cfg.validation_quorum,
            port=cfg.peer_port,
            peer_addrs=dial_addrs,
            network_time=ntime,
            clock=clock,
            timer_interval=timer_interval,
            hash_batch=self.hasher,
            verify_many=self.verify_plane.verify_many,
            fee_track=self.fee_track,
            unl_store=self.unl,
            bootcache_path=(
                cfg.database_path + ".bootcache" if cfg.database_path else None
            ),
            proposing=self.validation_keys is not None,
            follower=self.follower,
            # upstream-pinned followers never discovery-dial past their
            # named upstreams (the tree stays a tree even as endpoint
            # gossip spreads the leader's address)
            pinned_upstream=bool(self.follower and cfg.node_upstream),
            router=self.hash_router,
            job_dispatch=self._peer_job_dispatch,
            peer_tls=peer_tls,
            # matched against peer.node_public from the hello, i.e.
            # the key the member HANDSHAKES with: its validation
            # public when it validates, else its node identity
            cluster={
                decode_node_public(v) for v in cfg.cluster_nodes
            } or None,
            # [overlay] defense plane: squelch subset size/rotation
            # + the per-peer sendq discipline
            squelch_size=cfg.overlay_squelch,
            squelch_rotate=cfg.overlay_squelch_rotate,
            sendq_cap=cfg.overlay_sendq_cap,
            sendq_evict_drops=cfg.overlay_sendq_evict_drops,
        )

        # catch-up acquisitions resolve nodes from OUR NodeStore
        # before asking peers: near-tip trees are mostly shared, so
        # only the delta crosses the wire (reference: SHAMap node
        # cache + fetch packs)
        def _local_node_blob(h: bytes):
            obj = self.nodestore.fetch(h)
            return obj.data if obj is not None else None

        self.overlay.node.inbound.local_fetch = _local_node_blob

        # segment-granular catch-up: a cold/lagging node bulk-transfers
        # whole store segments from a peer (wire GetSegments/SegmentData
        # over the segstore's fetch_segment read door) so the tree
        # acquisition above resolves locally; timeout/retry/backoff/
        # peer-scoring in node/inbound.SegmentCatchup
        backend = self.nodestore.backend
        if hasattr(backend, "fetch_segment"):
            from ..nodestore.core import NodeObjectType
            from ..overlay.resource import FEE_GARBAGE_SEGMENT
            from .inbound import SegmentCatchup

            vn = self.overlay.node
            if self.shardstore is not None:
                # history tiering: shard rows join the segment manifest
                # so a cold peer below our trim floor syncs the gap from
                # cold storage over the same GetSegments door
                # (nodestore/shards.py)
                from ..nodestore.shards import CombinedSegmentSource

                vn.segment_source = CombinedSegmentSource(
                    backend, self.shardstore
                )
            else:
                vn.segment_source = backend
            vn.segment_catchup = SegmentCatchup(
                send=self.overlay.send_segments_request,
                peers=self.overlay.segment_peers,
                store=lambda tb, key, blob: self.nodestore.store(
                    NodeObjectType(tb), key, blob
                ),
                clock=self.overlay._clock,
                note_byzantine=vn.note_byzantine,
                # unified peer scoring: a peer condemned for a garbage
                # segment transfer takes a FEE_BAD_DATA-class charge on
                # its overlay endpoint, so the same balance that gates
                # relay/admission sees the catch-up offense too
                on_condemn=lambda pub: self.overlay.charge_peer(
                    pub, FEE_GARBAGE_SEGMENT
                ),
            )

        # archive deep-history backfill (doc/archive.md): a second
        # fetcher on the same GetSegments door — peers' manifests
        # advertise sealed shard ranges, the backfill pulls whole
        # verified shard files for every range this node lacks and fans
        # each import out to the nodestore + full-history txdb
        if self.archive and cfg.archive_backfill:
            self._build_shard_backfill()

        # persistence rides the close pipeline's dedicated ORDERED
        # worker, NOT the consensus tick (the hook fires under the
        # master lock and a slow disk must not stall round timing —
        # reference: pendSaveValidated). WS streams + the
        # INCLUDED→COMMITTED promotion fire AFTER the persist, in
        # drain order, then the on_persisted hooks.
        def _persist_async(led):
            def done(results):
                self.ops.publish_closed_ledger(led, results)
                self._note_persisted(led, results)

            self.close_pipeline.submit_close(
                led, getattr(led, "apply_results", {}), done=done,
            )

        self.overlay.accepted_hooks.append(_persist_async)

    def _build_shard_backfill(self) -> None:
        """An archive's ShardBackfill on the overlay's GetSegments door:
        each verified import is fed into the node store and the
        never-trimming txdb (feed_shard), then the verified floor goes to
        the read plane's forever tier. A peer whose shard fails
        verification takes the garbage-segment charge on its overlay
        endpoint (the same stance as segment catch-up)."""
        from ..nodestore.core import NodeObjectType
        from ..overlay.resource import FEE_GARBAGE_SEGMENT
        from .archive import ShardBackfill, feed_shard

        vn = self.overlay.node
        if vn.segment_source is None:
            # no segment-capable live backend: the archive still
            # advertises + re-serves its imported shards (the
            # distribution network's re-serve half)
            vn.segment_source = self.shardstore

        def _on_shard_imported(res: dict) -> None:
            feed_shard(
                self.shardstore, res["id"],
                store=lambda tb, key, blob: self.nodestore.store(
                    NodeObjectType(tb), key, blob
                ),
                txdb=self.txdb,
            )
            self._update_archive_floor()

        vn.shard_backfill = ShardBackfill(
            send=self.overlay.send_segments_request,
            peers=self.overlay.segment_peers,
            shardstore=self.shardstore,
            clock=self.overlay._clock,
            rescan_s=self.config.archive_rescan_s,
            note_byzantine=vn.note_byzantine,
            on_imported=_on_shard_imported,
            on_condemn=lambda pub: self.overlay.charge_peer(
                pub, FEE_GARBAGE_SEGMENT
            ),
        )

    def _peer_job_dispatch(self, kind: str, thunk) -> None:
        """Overlay peer-message scheduler: proposals/validations ride
        their reference job types (latency targets feed LoadMonitor;
        the queue's per-type accounting makes them sheddable)."""
        from .jobqueue import JobType

        jt = (
            JobType.jtPROPOSAL_t
            if kind == "proposal"
            else JobType.jtVALIDATION_t
        )
        self.job_queue.add_job(jt, kind, thunk)

    def _load_or_create_identity(self) -> KeyPair:
        """reference: LocalCredentials::start (wallet.db node seed) — a
        stable per-node keypair, created on first start and persisted."""
        import json

        path = (
            self.config.database_path + ".wallet"
            if self.config.database_path
            else None
        )
        if path and os.path.exists(path):
            try:
                with open(path) as fh:
                    rec = json.loads(fh.read())
                return KeyPair.from_seed(bytes.fromhex(rec["node_seed"]))
            except (OSError, ValueError, KeyError):
                pass  # unreadable wallet: regenerate below
        kp = KeyPair.random()
        if path:
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                fh.write(json.dumps({
                    "node_seed": kp.seed.hex(),
                    "node_public": kp.human_node_public,
                }))
            os.replace(tmp, path)
            os.chmod(path, 0o600)
        return kp

    # -- lifecycle --------------------------------------------------------

    def setup(self) -> "Node":
        """reference: ApplicationImp::setup — START_UP switch
        (Application.cpp:733-762)."""
        if self.config.debug_logfile and self._debug_log_handler is None:
            # [debug_logfile]: full-severity mirror on disk regardless of
            # the console/partition levels (reference: setDebugLogFile,
            # Application.cpp:687-689). The handler is owned by this Node
            # and detached on stop() so setup/stop cycles in one process
            # neither duplicate lines nor leak descriptors.
            import logging

            handler = logging.FileHandler(self.config.debug_logfile)
            handler.setLevel(logging.DEBUG)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"
            ))
            root = logging.getLogger("stellard")
            root.addHandler(handler)
            if root.level > logging.DEBUG or root.level == logging.NOTSET:
                root.setLevel(logging.DEBUG)
            self._debug_log_handler = handler
        if self.config.start_up == "fresh":
            self.ledger_master.start_new_ledger(self.master_keys.account_id)
            # persist the genesis close so later offline replay can load
            # every ledger's parent (reference: startNewLedger saves the
            # seq-1 ledger before opening seq 2)
            genesis = self.ledger_master.closed_ledger()
            genesis.save(self.nodestore)
            self.txdb.save_ledger_header(genesis)
        elif self.config.start_up == "load":
            # resume preference order (reference: loadLastKnownCLF
            # Application.cpp:729, then loadOldLedger :737-758): the CLF
            # state pointer is the atomically-committed source of truth;
            # the txdb header index is the fallback
            led = self.clf.load_last_known(
                self.nodestore, hash_batch=self.hasher, lazy=True
            )
            if led is None:
                hdr = self.txdb.get_ledger_header()
                if hdr is not None:
                    # lazy resume (out-of-core plane): boot is O(1) in
                    # state size — the working set faults in on demand
                    led = Ledger.load(
                        self.nodestore, hdr["hash"],
                        hash_batch=self.hasher, lazy=True,
                    )
            if led is None:
                self.ledger_master.start_new_ledger(self.master_keys.account_id)
            else:
                self.ledger_master.load_ledger(led)
        return self

    def wait_device_ready(self) -> None:
        """Wait for the verify plane's K1 prewarm; raise its error if it
        failed to build or launch K1 (the node does not carry on on the
        CPU). A no-op for a cpu signature backend."""
        if self.verify_prewarm is not None:
            self.verify_prewarm.join()
        if self.verify_plane.prewarm_error is not None:
            raise RuntimeError(
                "the verify plane's device prewarm failed"
            ) from self.verify_plane.prewarm_error

    def serve(self) -> "Node":
        """Open the configured API doors (reference: ApplicationImp::setup
        WSDoors :817-868, RPCDoor :877-891). Waits for the verify
        plane's device prewarm first, and fails if it failed."""
        from ..rpc.infosub import SubscriptionManager

        self.wait_device_ready()
        cfg0 = self.config
        self.subs = SubscriptionManager(
            self.ops,
            shards=cfg0.subs_shards,
            sendq_cap=cfg0.subs_sendq_cap,
            evict_drops=cfg0.subs_evict_drops,
            push_retries=cfg0.subs_push_retries,
            resume_horizon=cfg0.subs_resume_horizon,
            tracer=self.tracer,
        )
        # `server` stream: publish on load-factor movement (pubServer)
        self.fee_track.on_change.append(self.subs.pub_server_status)
        # path subscriptions ride the liquidity plane's staleness budget
        self.subs.path_plane = self.path_plane
        door_state_dir: list[str] = []  # one shared auto-cert dir per serve

        def _door_ssl(secure: int, cert: str, key: str):
            # reference [rpc_secure]/[websocket_secure] (Config.cpp:475-492)
            if not secure:
                return None
            from ..overlay.peertls import make_door_ssl_context

            if not door_state_dir:
                if self.config.database_path:
                    door_state_dir.append(self.config.database_path + ".tls")
                else:
                    import tempfile

                    d = tempfile.mkdtemp(prefix="stellard-tls-")
                    door_state_dir.append(d)
                    self._tmp_tls_dir = d  # removed on stop()
            return make_door_ssl_context(cert, key, door_state_dir[0])

        if self.config.rpc_port is not None:
            from ..rpc.http_server import HttpRpcServer

            self.http_server = HttpRpcServer(
                self, self.config.rpc_ip, self.config.rpc_port,
                ssl_context=_door_ssl(
                    self.config.rpc_secure,
                    self.config.rpc_ssl_cert,
                    self.config.rpc_ssl_key,
                ),
            ).start()
        if self.config.websocket_port is not None:
            from ..rpc.ws_server import WsRpcServer

            self.ws_server = WsRpcServer(
                self, self.config.websocket_ip, self.config.websocket_port,
                subs=self.subs,
                ssl_context=_door_ssl(
                    self.config.websocket_secure,
                    self.config.websocket_ssl_cert,
                    self.config.websocket_ssl_key,
                ),
            ).start()
        self._running.set()
        self.load_manager.start()
        if self.overlay is not None:
            # chain already set up (fresh/load) by setup(); open the
            # first consensus round over it and join the net
            self.overlay.node.begin_round()
            self.overlay.start_network()
        if self.sntp is not None:
            self.sntp.start()
        # pull-gauges for the metrics plane (insight Hook shape)
        self.collector.hook(
            "jobq",
            lambda: {
                t: s["queued"] + s["running"]
                for t, s in self.job_queue.get_json().items()
            },
        )
        self.collector.hook(
            "verify",
            lambda: {
                "batches": self.verify_plane.batches,
                "verified": self.verify_plane.verified,
            },
        )
        # routing-flip telemetry: which side (cpu vs device) took the
        # majority of verify batches since the last flush; a majority
        # change is one flip
        _route = {"side": None, "cpu": 0, "dev": 0, "flips": 0}

        def _verify_routing():
            vp = self.verify_plane
            dc, cc = vp.device_batches, vp.cpu_batches
            d_dev, d_cpu = dc - _route["dev"], cc - _route["cpu"]
            _route["dev"], _route["cpu"] = dc, cc
            if d_dev or d_cpu:
                side = "device" if d_dev >= d_cpu else "cpu"
                if _route["side"] is not None and side != _route["side"]:
                    _route["flips"] += 1
                _route["side"] = side
            return {"flips": _route["flips"]}

        self.collector.hook("verify_routing", _verify_routing)
        self.collector.hook(
            "load", lambda: {"factor": self.fee_track.load_factor}
        )
        self.collector.hook(
            "txq",
            lambda: {
                "size": len(self.txq),
                "expected": self.txq.metrics.txns_expected,
                "evicted": self.txq.stats["evicted"],
                "promoted": self.txq.stats["promoted"],
            },
        )
        self.collector.hook(
            "close_pipeline",
            lambda: {
                "depth": self.close_pipeline.pending(),
                "persisted": self.close_pipeline.persisted,
                "backpressure_waits": self.close_pipeline.backpressure_waits,
            },
        )
        # subscription-fanout + read-cache gauges: published/delivered/
        # dropped/evicted and cache hit rates ride the same statsd
        # surface as everything else
        self.collector.hook(
            "subs",
            lambda: {
                k: v for k, v in self.subs.get_json().items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            },
        )
        self.collector.hook("subs_shard", self.subs.shard_stats)
        self.collector.register_hist("subs_fanout_lag_ms",
                                     self.subs.lag_hist)
        if self.read_cache is not None:
            self.collector.hook(
                "cache",
                lambda: {
                    k: v
                    for k, v in self.read_cache.get_json().items()
                    if isinstance(v, (int, float))
                },
            )
        if self.path_plane is not None:
            # liquidity-plane gauges (`paths.*`): re-ranks, sheds,
            # staleness, index continuity
            self.collector.hook(
                "paths",
                lambda: {
                    k: v for k, v in self.path_plane.get_json().items()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)
                },
            )
        # span-derived per-stage latency percentiles (trace.<stage>.p50_ms
        # et al.): the unified latency surface the tracing plane feeds
        self.collector.hook("trace", self.tracer.statsd_hook)
        if self.spec_executor.active:
            self.collector.hook(
                "spec",
                lambda: {
                    k: v
                    for k, v in self.spec_executor.counters.snapshot()
                    .items()
                    if k in ("dispatched", "committed", "retries",
                             "validation_aborts", "serial_fallbacks")
                },
            )
        self.collector.hook(
            "delta_replay",
            # snapshot via delta_replay_json: it takes the chain lock, so
            # the three counters are mutually consistent per sample
            lambda: {
                k: v
                for k, v in self.ledger_master.delta_replay_json().items()
                if k in ("spliced", "fallback", "invalidated")
            },
        )
        self.collector.start()
        # start-up done: what the node loaded lives as long as it serves
        gcpolicy.hold(freeze=True)
        self._gc_held = True
        return self

    def run(self) -> None:
        """Block until stopped (reference: ApplicationImp::run); a crash
        dumps the flight recorder before it propagates."""
        # watchdog armed only once the run loop drives heartbeats
        # (reference: activateDeadlockDetector from ApplicationImp::run
        # :1028); embedders that drive the node directly never arm it
        self.load_manager.arm()
        try:
            self._run_loop()
        except BaseException:
            # the flight recorder's whole point: the black box ships
            # BEFORE the stack unwinds
            try:
                self.flight.dump("crash")
            except Exception:  # noqa: BLE001 — dump must not mask the crash
                pass
            raise

    def _run_loop(self) -> None:
        import time as _time

        from .jobqueue import JobType

        last_beat = 0.0
        last_sweep = 0.0
        while self._running.is_set():
            # the heartbeat must flow THROUGH the job queue: a wedged
            # worker pool or master lock then starves the canary reset and
            # the detector fires (reference: the heartbeat is itself a
            # jtNETOP_TIMER job)
            now = _time.monotonic()
            if now - last_sweep >= 30.0:
                # cache sweep (reference: ApplicationImp::doSweep on the
                # sweep timer — jtSWEEP job over the aged caches)
                last_sweep = now
                self.job_queue.add_job(
                    JobType.jtSWEEP,
                    "sweep",
                    self.ledger_master.ledgers_by_hash.sweep,
                )
                # RPC-client charge-table expiry on the same maintenance
                # timer — idle client endpoints age out so a long-lived
                # node's map stays bounded
                if self.rpc_resources is not None:
                    self.job_queue.add_job(
                        JobType.jtSWEEP, "rpcResourceSweep",
                        self.rpc_resources.sweep,
                    )
                # disk-space guard (reference: doSweep fatals under 512MB
                # free, Application.cpp:1098-1106): stopping cleanly now
                # beats corrupting the stores on a full disk later
                if self.config.database_path:
                    import shutil

                    try:
                        free = shutil.disk_usage(
                            os.path.dirname(
                                os.path.abspath(self.config.database_path)
                            )
                        ).free
                    except OSError:
                        free = None
                    if free is not None and free < 512 * 1024 * 1024:
                        import logging

                        logging.getLogger("stellard.node").critical(
                            "remaining free disk space is less than "
                            "512MB (%d bytes) — shutting down", free,
                        )
                        self._running.clear()
            if now - last_beat >= 1.0:
                last_beat = now
                self.job_queue.add_job(
                    JobType.jtNETOP_TIMER,
                    "heartbeat",
                    self.load_manager.reset_deadlock_detector,
                )
                if self.sntp is not None and self.sntp.synced:
                    # discipline the network clock used for close times
                    # (reference getNetworkTimeNC via the SNTP offset),
                    # composed with any configured deliberate skew
                    self.ops.net_time_offset = int(
                        round(self.sntp.offset)
                    ) + int(self.config.network_time_offset)
                if self.overlay is not None:
                    self._overlay_heartbeat(now)
            _time.sleep(0.2)

    def _overlay_heartbeat(self, now: float) -> None:
        """Raise the card's error from under the overlay, then set the
        operating mode from overlay health (reference:
        NetworkOPs::setMode heuristics): FULL only while rounds are
        actually completing — a node that closed rounds once and then
        lost its peers must degrade. A follower's "round" is an ingested
        validated ledger. Entering degraded tracking dumps the flight
        recorder, once an episode."""
        from ..overlay.tcp import DeviceFailed
        from .networkops import OperatingMode

        if self.overlay.device_error is not None:
            raise DeviceFailed(
                "the card failed under the overlay"
            ) from self.overlay.device_error
        vn = self.overlay.node
        # a follower tracks the net without proposing: TRACKING while
        # its tail advances, CONNECTED/DISCONNECTED from peer health
        # otherwise
        rounds = vn.ledgers_ingested if vn.follower else vn.rounds_completed
        if rounds > getattr(self, "_last_rounds", 0):
            self._last_rounds = rounds
            self._last_round_at = now
        recently = now - getattr(self, "_last_round_at", 0.0) < 60.0
        if vn.follower:
            if rounds > 0 and recently:
                self.ops.mode = OperatingMode.TRACKING
            elif self.overlay.peer_count() > 0:
                self.ops.mode = OperatingMode.CONNECTED
            else:
                self.ops.mode = OperatingMode.DISCONNECTED
        elif vn.degraded:
            # closing without quorum validation: report TRACKING
            # honestly instead of a confident FULL from a node whose
            # ledgers nobody signs
            self.ops.mode = OperatingMode.TRACKING
            if not self._degraded_dump_done:
                # black box on entering degraded service — once per
                # episode, not per heartbeat
                self._degraded_dump_done = True
                self.flight.dump("degraded-tracking")
        elif rounds > 0 and recently:
            self.ops.mode = OperatingMode.FULL
            self._degraded_dump_done = False
        elif self.overlay.peer_count() > 0:
            self.ops.mode = OperatingMode.CONNECTED
        else:
            self.ops.mode = OperatingMode.DISCONNECTED

    def stop(self) -> None:
        self._running.clear()
        self.load_manager.stop()
        # the executor first: any open speculation window completes
        # serially before the chain machinery below winds down
        self.spec_executor.stop()
        self.ledger_master.stop_seal_drainer()
        if self.overlay is not None:
            stop = getattr(self.overlay, "stop", None)
            if stop is not None:  # embedders may attach bare adapters
                stop()
        if self.online_deleter is not None:
            self.online_deleter.stop()
        # drain-on-stop guarantee: everything queued persists before the
        # stores close (the CLF pointer lands on the last closed ledger)
        self.close_pipeline.stop(timeout=60)
        if self.subs is not None:
            self.subs.stop()
        self.collector.stop()
        if self.sntp is not None:
            self.sntp.stop()
        if self.http_server:
            self.http_server.stop()
        if self.ws_server:
            self.ws_server.stop()
        self.job_queue.stop()
        self.verify_plane.stop()
        self.nodestore.close()
        self.txdb.close()
        if self.shardstore is not None:
            self.shardstore.close()
        if self._debug_log_handler is not None:
            import logging

            logging.getLogger("stellard").removeHandler(self._debug_log_handler)
            self._debug_log_handler.close()
            self._debug_log_handler = None
        if getattr(self, "_tmp_tls_dir", None):
            import shutil

            shutil.rmtree(self._tmp_tls_dir, ignore_errors=True)
            self._tmp_tls_dir = None
        if self._gc_held:
            self._gc_held = False
            gcpolicy.release()

    def _update_archive_floor(self) -> None:
        """Publish the contiguous sealed-shard coverage hi
        (``HistoryShardStore.contiguous_floor``) to the read plane's
        forever tier: any result whose request window closes at or below
        it is backed by offline-verified shard bytes and immutable, so
        it is cached forever instead of per epoch."""
        rp = getattr(self, "read_plane", None)
        if rp is not None and self.shardstore is not None:
            rp.set_archive_floor(self.shardstore.contiguous_floor())

    # -- persistence on close (reference: pendSaveValidated + CLF commit) --

    def persist_close(self, ledger: Ledger, results: dict) -> None:
        """Queue a closed ledger on the close pipeline (the node's
        ledger-closed sink, and the door for a ledger closed on
        ``ledger_master`` directly): its writes overlap the next close,
        and the ``on_persisted`` hooks run once they commit."""
        self.close_pipeline.submit_close(
            ledger, results,
            done=lambda res: self._note_persisted(ledger, res),
        )

    def _note_persisted(self, ledger: Ledger, results: dict) -> None:
        for hook in list(self.on_persisted):
            hook(ledger, results)

    def _persist_closed_ledger(self, ledger: Ledger, results: dict) -> None:
        """Serial (in-line) persist: the close-pipeline-disabled path and
        embedders that drive persistence directly."""
        self.persist_ledger_data(ledger, results)
        self._commit_clf(ledger)
        self._note_persisted(ledger, results)

    def _commit_clf(self, ledger: Ledger) -> None:
        # CLF commit: one scoped SQL transaction — entry-row delta + LCL
        # pointer (reference: stellar::LedgerMaster::commitLedgerClose).
        # NOT part of persist_ledger_data: a repaired HISTORICAL ledger
        # must never move the CLF resume pointer backwards.
        prev = self.ledger_master.get_ledger_by_hash(ledger.parent_hash)
        self.clf.commit_ledger_close(ledger, prev)
        if self.online_deleter is not None:
            # rotation hook: runs on the drain worker AFTER the ledger
            # is fully durable; cheap check, sweeps happen in background
            self.online_deleter.on_validated(ledger.seq)

    def _persist_tx_rows(self, ledger: Ledger, results: dict) -> None:
        """Header + tx rows in ONE sqlite transaction (close-pipeline txdb
        stage). Rows were usually materialized at close time overlapped
        with the seal tree-hash (LedgerMaster.persist_prep)."""
        rows = getattr(ledger, "persist_rows", None)
        if rows is None:
            rows = build_tx_rows(ledger, results)
        else:
            # one-shot: the memo must not pin row data in the ledger
            # cache for the ledger's whole cache lifetime
            ledger.persist_rows = None
        self.txdb.save_ledger(ledger, rows)

    def persist_ledger_data(self, ledger: Ledger, results: dict) -> None:
        """NodeStore + header + tx rows for one ledger (no CLF pointer) —
        the shared half of close-persistence and history repair."""
        ledger.save(self.nodestore)
        self._persist_tx_rows(ledger, results)

    # -- convenience driving (tests / CLI) --------------------------------

    def submit(self, tx: SerializedTransaction) -> tuple[TER, bool]:
        return self.ops.process_transaction(tx)

    def close_ledger(self):
        """Test/CLI convenience close: synchronous-DURABLE — the close
        pipeline drains before returning, so callers may immediately read
        txdb/CLF state. The perf paths (`ledger_accept` RPC) call
        ops.accept_ledger directly and stay pipelined."""
        out = self.ops.accept_ledger()
        if not self.close_pipeline.flush(timeout=60):
            # the docstring's durability promise must not fail silently
            raise RuntimeError(
                "close_ledger: persistence pipeline failed to drain within "
                "60s — storage stalled or wedged"
            )
        # synchronous contract extends to the admission plane: the
        # deferred open-window replenish (promotion + queue-aware
        # speculation) lands before this returns, so a caller's next
        # close sees the promoted txs (perf paths stay deferred)
        if not self.txq.quiesce(timeout=30):
            raise RuntimeError(
                "close_ledger: admission-queue replenish failed to land "
                "within 30s — job queue stalled or wedged"
            )
        return out

    def tx_status(self, txid: bytes) -> Optional[TxStatus]:
        return self.ops.on_tx_result.get(txid)
