"""Archive tier: full-history reporting nodes (doc/archive.md).

Production XRPL moved heavy history/API traffic off validators entirely
(reporting mode / Clio), while this repo's validators deliberately SHED
history: online deletion seals retiring ledger runs into
offline-verifiable shards (nodestore/shards.py) and trims. The archive
role re-assembles those pieces into "years of history, queryable at
scale":

- **tail ingest**: an archive runs the follower ingest plane unchanged
  (validation tailing + GetSegments catch-up, doc/follower.md);
- **deep-history backfill**: :class:`ShardBackfill` — the shard
  distribution network's fetch side. Peers advertise held shard seq
  ranges in their segment manifests (``lo``/``hi``/``file_bytes`` row
  fields, nonzero-only on the wire); the backfill selects uncovered
  ranges and fetches COMPLETE shard files over the existing
  GetSegments door (ids offset by ``SHARD_FILE_BASE``), so the
  transferred image is exactly what the offline verification contract
  covers. Every import is gated by ``verify_shard_blob`` — a peer whose
  shard fails verification is condemned (resource-charged via the
  overlay's ``charge_peer``, excluded for the session) and ZERO hostile
  bytes are retained;
- **full-history indexes**: :func:`feed_shard` fans a verified import
  out to the archive's nodestore (deep ``ledger``/state queries resolve
  through the ordinary lazy ``Ledger.load`` path) and its
  :class:`ArchiveTxDatabase` — a txdb with NO retain floor, fed in
  ``(ledger_seq, txn_seq)`` order, that refuses to trim;
- **forever cache**: the archive's verified floor (the contiguous
  sealed-shard coverage, ``HistoryShardStore.contiguous_floor``) feeds
  the read plane's immutable-seq result tier (rpc/readplane.py): any
  result whose window closes at or below the floor is cached forever,
  not swapped per epoch.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..nodestore.shards import SHARD_FILE_BASE, SHARD_SEG_BASE
from ..overlay.wire import GetSegments
from .txdb import TxDatabase

__all__ = ["ArchiveTxDatabase", "ShardBackfill", "feed_shard"]

# NodeObjectType values (nodestore.core) mirrored from shards.py so the
# feed walk stays self-contained
_T_LEDGER = 1


class ArchiveTxDatabase(TxDatabase):
    """Full-history txdb: the retain floor NEVER rises. The archive
    tier's contract is that every historical row stays queryable, so
    `trim_below` — the SQL half of online deletion — is a loud
    RuntimeError here, not a silent no-op: wiring [node_db] sql_trim or
    online deletion into an archive is an operator error, and an error
    that parses clean and drops rows would be the exact dead-config
    class the config plane rejects everywhere else."""

    def trim_below(self, ledger_seq: int) -> dict:
        raise RuntimeError(
            "archive txdb never trims: mode=archive keeps full history "
            "(doc/archive.md); disable [node_db] online_delete/sql_trim"
        )


def feed_shard(shardstore, sid: int, store: Optional[Callable] = None,
               txdb: Optional[TxDatabase] = None) -> dict:
    """Fan ONE verified, just-imported shard out to the archive's other
    stores: every record into the nodestore sink (``store(type_byte,
    key, blob)`` — deep-history ``ledger`` and state queries then
    resolve through the ordinary lazy ``Ledger.load`` path) and the
    never-trimming txdb — ledger headers first, then tx rows in
    ``(ledger_seq, txn_seq)`` order, statuses recovered from each tx's
    metadata result byte exactly like catch-up-adopted closes. The
    affected-accounts set comes from the shard's OWN account index rows
    (the set recorded at seal time), so the rebuilt SQL index
    byte-matches the sealed one instead of re-deriving from metadata."""
    from ..state.ledger import parse_header
    from ..utils.hashes import HP_LEDGER_MASTER

    ledger_prefix = HP_LEDGER_MASTER.to_bytes(4, "big")
    headers: list[dict] = []
    n_records = 0
    for key, type_byte, blob in shardstore.iter_records(sid):
        n_records += 1
        if store is not None:
            try:
                store(type_byte, key, blob)
            except Exception:  # noqa: BLE001 — one failed local write
                pass           # must not abort the whole import feed
        if type_byte == _T_LEDGER and blob[:4] == ledger_prefix:
            h = parse_header(blob[4:])
            h["hash"] = key
            headers.append(h)
    out = {"records": n_records, "headers": len(headers), "txs": 0}
    if txdb is None:
        return out
    if headers:
        txdb.save_header_dicts(sorted(headers, key=lambda h: h["seq"]))
    # group the account-index rows by txid: one Transactions row per tx,
    # every account sharing the txid becomes its affected set
    by_txid: dict[bytes, dict] = {}
    for acct, lseq, tseq, txid in shardstore.acct_rows(sid):
        ent = by_txid.setdefault(
            txid, {"accounts": [], "ledger_seq": lseq, "txn_seq": tseq}
        )
        ent["accounts"].append(acct)
    rows = []
    for txid, ent in sorted(
        by_txid.items(),
        key=lambda kv: (kv[1]["ledger_seq"], kv[1]["txn_seq"]),
    ):
        got = shardstore.tx_blob(sid, txid)
        if got is None:
            continue  # index row without a record: skip, not crash
        raw, meta = got
        tx_type, account, seq = "", b"", 0
        try:
            from ..protocol.sttx import SerializedTransaction

            tx = SerializedTransaction.from_bytes(raw)
            tx_type = tx.tx_type.name
            account = tx.account
            seq = tx.sequence
        except Exception:  # noqa: BLE001 — an unparseable tx still gets
            pass           # its raw/meta row (binary-mode serving works)
        rows.append((
            txid, tx_type, account, seq, ent["ledger_seq"],
            _meta_status(meta), raw, meta,
            ent["accounts"] or [account],
            ent["txn_seq"],
        ))
    if rows:
        txdb.save_transactions(rows)
    out["txs"] = len(rows)
    return out


def _meta_status(meta: Optional[bytes]) -> str:
    """TER token from the tx metadata's result byte (the import feed
    never applied these txs locally — same stance as adopted closes)."""
    from ..protocol.ter import TER

    if meta:
        try:
            from ..protocol.sfields import sfTransactionResult
            from ..protocol.stobject import STObject

            code = STObject.from_bytes(meta).get(sfTransactionResult)
            if code is not None:
                return TER(code).token
        except Exception:  # noqa: BLE001 — unparseable meta: default
            pass
    return TER.tesSUCCESS.token


class ShardBackfill:
    """Deep-history shard fetcher: the archive side of the shard
    distribution network (see module doc).

    Transport-agnostic and clock-driven like SegmentCatchup — the owner
    supplies ``send(peer, msg)``, ``peers()``, a monotonic ``clock()``
    and the target :class:`~..nodestore.shards.HistoryShardStore`;
    ``tick(now)`` drives timeouts/retries AND the session lifecycle
    (self-arming: an idle backfill rescans peers' manifests every
    ``rescan_s`` for newly sealed shards, so the archive keeps tracking
    the validators' rotation without an external trigger).

    Correctness stance: the ONLY install door is
    ``HistoryShardStore.import_shard``, which runs the full offline
    verification contract against the transferred image in memory
    first. A failing image condemns the serving peer — resource charge
    via ``on_condemn`` (the owner wires TcpOverlay.charge_peer with
    FEE_GARBAGE_SEGMENT), byzantine note, session exclusion — and the
    same shard is refetched from the next-best peer; zero hostile bytes
    are ever retained."""

    # a finished session re-arms after this long (fresh-manifest rescan
    # cadence); transfer failure re-arms on the same clock
    GROWTH_SLACK = 8 << 20
    # absolute per-shard-file ceiling, manifest or not
    MAX_SHARD_TRANSFER = 512 << 20

    def __init__(
        self,
        send: Callable[[object, object], None],
        peers: Callable[[], list],
        shardstore,
        clock: Callable[[], float],
        request_timeout: float = 4.0,
        max_retries: int = 8,
        backoff_base: float = 1.0,
        backoff_max: float = 30.0,
        rescan_s: float = 30.0,
        grace_s: float = 2.0,
        seed: int = 0,
        note_byzantine: Optional[Callable] = None,
        on_imported: Optional[Callable[[dict], None]] = None,
        on_condemn: Optional[Callable] = None,
    ):
        import random

        from .metrics import AtomicCounters

        # one lock for every public entry point: TCP replies land on
        # per-peer reader threads while tick() runs on the timer thread
        self._lock = threading.RLock()
        self.send = send
        self.peers = peers
        self.shardstore = shardstore
        self.clock = clock
        self.request_timeout = request_timeout
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.rescan_s = rescan_s
        self.rng = random.Random(0xA2C1 ^ seed)
        self.note_byzantine = note_byzantine
        self.on_imported = on_imported
        self.on_condemn = on_condemn
        self.active = False
        self.state = "idle"  # idle | manifest | fetch | done | fallback
        self._next_scan = grace_s  # vs a monotonic clock starting ~0
        self._started_once = False
        self.counters = AtomicCounters(
            "started", "completed", "requests", "replies", "timeouts",
            "retries", "backoffs", "peer_switches", "garbage_peers",
            "fallbacks", "imported", "duplicates", "import_rejects",
            "bytes", "late_replies", "epoch_restarts", "rescans",
        )
        self._reset_session()

    def _reset_session(self) -> None:
        # queue rows: (file_seg_id, advertised_file_bytes, lo, hi)
        self._queue: list[tuple[int, int, int, int]] = []
        self._cur: Optional[tuple[int, int, int, int]] = None
        self._buf = bytearray()
        self._want: Optional[tuple] = None  # ("manifest",) | ("file", id)
        self._deadline: Optional[float] = None
        self._backoff_until = 0.0
        self._attempts = 0
        self._peer = None
        self._peer_failures: dict = {}
        self._bad_peers: set = set()
        self._snap_epoch = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> bool:
        """Begin (or ignore if already running) a backfill session."""
        with self._lock:
            if self.active:
                return False
            self._reset_session()
            self.active = True
            self._started_once = True
            self.state = "manifest"
            self._want = ("manifest",)
            self.counters.add("started")
            self._send_current(self.clock())
            return True

    def stop(self) -> None:
        with self._lock:
            self.active = False
            self.state = "idle"
            self._want = None

    # -- peer selection (SegmentCatchup's fewest-failures discipline) ------

    def _eligible_peers(self) -> list:
        return [p for p in self.peers() if p not in self._bad_peers]

    def _pick_peer(self):
        cands = self._eligible_peers()
        if not cands:
            return None
        return min(
            cands, key=lambda p: (self._peer_failures.get(p, 0),
                                  cands.index(p))
        )

    def _maybe_switch_peer(self) -> None:
        best = self._pick_peer()
        if best is not None and best != self._peer:
            self._peer = best
            self.counters.add("peer_switches")

    # -- request machinery -------------------------------------------------

    def _send_current(self, now: float) -> None:
        if self._want is None:
            return
        if self._peer is None:
            self._peer = self._pick_peer()
        if self._peer is None:
            self._fallback("no_peers")
            return
        if self._want[0] == "manifest":
            msg = GetSegments(-1, 0)
        else:
            msg = GetSegments(self._want[1], len(self._buf),
                              snap_epoch=self._snap_epoch)
        self.counters.add("requests")
        self._deadline = now + self.request_timeout
        try:
            self.send(self._peer, msg)
        except Exception:  # noqa: BLE001 — a dead transport is a timeout
            pass

    def tick(self, now: float) -> None:
        """Timeout/backoff clock + the self-arming session lifecycle."""
        with self._lock:
            if not self.active:
                if now >= self._next_scan:
                    if self._started_once:
                        self.counters.add("rescans")
                    self._next_scan = now + self.rescan_s
                    self.start()
                return
            self._tick_locked(now)

    def _tick_locked(self, now: float) -> None:
        if self._want is None:
            return
        if self._deadline is not None and now >= self._deadline:
            self._deadline = None
            self.counters.add("timeouts")
            if self._peer is not None:
                self._peer_failures[self._peer] = (
                    self._peer_failures.get(self._peer, 0) + 1
                )
            self._attempts += 1
            if self._attempts > self.max_retries:
                self._fallback("retries_exhausted")
                return
            delay = min(
                self.backoff_max,
                self.backoff_base * (2 ** (self._attempts - 1)),
            )
            delay *= 1.0 + 0.25 * self.rng.random()  # jitter
            self._backoff_until = now + delay
            self.counters.add("backoffs")
            self._maybe_switch_peer()
            return
        if self._deadline is None and now >= self._backoff_until:
            self.counters.add("retries")
            self._send_current(now)

    # -- replies -----------------------------------------------------------

    def on_manifest(self, peer, segments: list, epoch: int = 0,
                    snap_seq: int = 0) -> None:
        """Select the peer's advertised shard rows this archive does not
        cover yet (range selection — never probe), translating each
        manifest id into its whole-file door id."""
        with self._lock:
            if not self.active or self._want != ("manifest",):
                self.counters.add("late_replies")
                return
            if peer != self._peer:
                self.counters.add("late_replies")
                return
            self.counters.add("replies")
            self._attempts = 0
            self._deadline = None
            self._snap_epoch = int(epoch)
            queue = []
            for row in segments:
                rid = int(row[0])
                if not (SHARD_SEG_BASE <= rid < SHARD_FILE_BASE):
                    continue  # live segstore rows: the tail ingest's job
                lo = int(row[4]) if len(row) > 4 else 0
                hi = int(row[5]) if len(row) > 5 else 0
                fbytes = int(row[6]) if len(row) > 6 else 0
                if lo <= 0 or hi < lo:
                    continue  # pre-range peer: cannot select, skip
                if (self.shardstore.covers(lo) is not None
                        and self.shardstore.covers(hi) is not None):
                    continue  # already held
                fid = SHARD_FILE_BASE + (rid - SHARD_SEG_BASE)
                queue.append((fid, fbytes, lo, hi))
            queue.sort(key=lambda r: r[2])  # oldest history first
            self._queue = queue
            if not self._queue:
                self._complete()
                return
            self.state = "fetch"
            self._next_shard()

    def _next_shard(self) -> None:
        if not self._queue:
            self._complete()
            return
        self._cur = self._queue.pop(0)
        self._buf = bytearray()
        self._want = ("file", self._cur[0])
        self._send_current(self.clock())

    def on_data(self, peer, msg) -> None:
        with self._lock:
            if (
                not self.active
                or self._want is None
                or self._want[0] != "file"
                or msg.seg_id != self._want[1]
                or peer != self._peer
                or msg.offset != len(self._buf)
            ):
                self.counters.add("late_replies")
                return
            self.counters.add("replies")
            self._attempts = 0
            self._deadline = None
            if (
                msg.snap_epoch
                and self._snap_epoch
                and msg.snap_epoch != self._snap_epoch
            ):
                # the source's sealed set moved under us: restart from a
                # fresh manifest instead of splicing two snapshots
                self.counters.add("epoch_restarts")
                self.state = "manifest"
                self._want = ("manifest",)
                self._queue = []
                self._buf = bytearray()
                self._cur = None
                self._snap_epoch = 0
                self._send_current(self.clock())
                return
            # transfer-size defense: advertised file size + slack, and a
            # hard ceiling — a hostile total never buys unbounded RAM
            advertised = self._cur[1] if self._cur else 0
            limit = min(
                self.MAX_SHARD_TRANSFER,
                (advertised + self.GROWTH_SLACK) if advertised
                else self.MAX_SHARD_TRANSFER,
            )
            if msg.total > limit or len(self._buf) + len(msg.data) > limit:
                self._condemn_peer(peer, "oversized_transfer")
                return
            if len(self._buf) < msg.total and not msg.data:
                self._condemn_peer(peer, "short_transfer")
                return
            self._buf.extend(msg.data)
            if len(self._buf) < msg.total:
                self._send_current(self.clock())  # next chunk
                return
            self._import_current(peer)

    def _condemn_peer(self, peer, why: str) -> None:
        """This peer served a shard that failed verification (or a
        hostile transfer shape): charge + exclude it, refetch the SAME
        shard from the next-best peer. Only an out-of-peers session
        falls back (the tail ingest keeps the archive live)."""
        self.counters.add("garbage_peers")
        if self.note_byzantine is not None:
            self.note_byzantine(
                "garbage_segment", peer=None,
                seg=self._cur[0] if self._cur else None, why=why,
            )
        if self.on_condemn is not None:
            try:
                self.on_condemn(peer)
            except Exception:  # noqa: BLE001 — the charge is bookkeeping
                pass
        self._bad_peers.add(peer)
        self._peer = None
        if not self._eligible_peers():
            self._fallback("all_peers_garbage")
            return
        self._buf = bytearray()
        self._maybe_switch_peer()
        self._send_current(self.clock())

    def _import_current(self, peer) -> None:
        """Verify-then-install the completed transfer. import_shard runs
        the full offline contract in memory BEFORE the store directory
        is touched; a rejected image retains zero bytes and condemns
        the serving peer."""
        data = bytes(self._buf)
        self._buf = bytearray()
        res = self.shardstore.import_shard(data)
        if not res.get("ok"):
            self.counters.add("import_rejects")
            self._condemn_peer(peer, "shard_verify_failed")
            return
        if res.get("duplicate"):
            self.counters.add("duplicates")
        else:
            self.counters.add("imported")
            self.counters.add("bytes", len(data))
            if self.on_imported is not None:
                try:
                    self.on_imported(res)
                except Exception:  # noqa: BLE001 — a failed index feed
                    pass           # must not kill the session
        self._next_shard()

    # -- terminal states ---------------------------------------------------

    def _complete(self) -> None:
        self.active = False
        self.state = "done"
        self._want = None
        self._next_scan = self.clock() + self.rescan_s
        self.counters.add("completed")

    def _fallback(self, reason: str) -> None:
        """Give up on THIS session (no peers / retries exhausted / every
        peer served garbage); the rescan clock re-arms a fresh one, so a
        bad episode never disables backfill forever."""
        self.active = False
        self.state = "fallback"
        self._want = None
        self._next_scan = self.clock() + self.rescan_s
        self.counters.add("fallbacks")

    def get_json(self) -> dict:
        out = self.counters.snapshot()
        with self._lock:
            out["state"] = self.state
            out["active"] = self.active
            out["queue"] = len(self._queue)
            out["snap_epoch"] = self._snap_epoch
            out["verified_floor"] = self.shardstore.contiguous_floor()
        return out
