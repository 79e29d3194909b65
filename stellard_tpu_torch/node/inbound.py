"""InboundLedger: network acquisition of a ledger by hash, and the
serving side that answers peers' requests.

Reference: src/ripple_app/ledger/InboundLedger.cpp (state machine: base
header → tx tree → state tree; trigger/takeNodes) and InboundLedgers.cpp
(container with dedup). Used for catch-up: when validations show the
network is on a ledger we don't have, we acquire it and switch
(reference: NetworkOPs::checkLastClosedLedger → switchLastClosedLedger).

``SegmentCatchup`` is the segment-granular bulk path layered under the
tree walk: instead of pulling a cold node's whole state one
GetLedger/LedgerData node wave at a time, it transfers entire store
segments (nodestore/segstore ``fetch_segment`` — contiguous byte ranges
whose every record is self-verifying: key == SHA-512-half of the blob)
into the local NodeStore, after which the tree acquisition resolves
almost everything via ``local_fetch`` and only the tip delta crosses the
wire node-by-node. Faults are first-class: per-request timeout on the
node's own clock, bounded retries with exponential backoff + seeded
jitter, peer scoring on failure, and per-peer fallback when a peer
serves garbage (a record whose bytes do not hash to its key).

Every acquired tree node is checked against its expected hash in one
batch a reply, on the node's hasher (``InboundLedgers.hash_many``: K2
on the card for a cuda node); a hasher without the packed door leaves
the check on the host, as the JAX package always does.
"""

from __future__ import annotations

import struct
from typing import Callable, Optional

from ..overlay.wire import GetLedger, GetSegments, LedgerData, SegmentData
from ..state.ledger import Ledger, parse_header, strip_ledger_prefix
from ..state.shamap import SHAMap, TNType, resolve_node
from ..state.shamapsync import IncompleteMap, SHAMapNodeID
from ..utils.hashes import HP_LEDGER_MASTER, prefix_hash

__all__ = [
    "InboundLedger",
    "InboundLedgers",
    "SegmentCatchup",
    "iter_segment_records",
    "serve_get_ledger",
]

# GetLedger.what codes
W_HEADER = 0
# reply-size budget for fat GetLedger answers (nodes per LedgerData)
MAX_REPLY_NODES = 512
W_TX_TREE = 1
W_STATE_TREE = 2


class InboundLedger:
    """One acquisition session (reference: InboundLedger.cpp:93-265)."""

    def __init__(self, ledger_hash: bytes, hash_batch: Optional[Callable] = None,
                 now: Optional[float] = None,
                 hash_many: Optional[Callable] = None):
        import time as _time

        self.hash = ledger_hash
        self.hash_batch = hash_batch
        # batched SHA-512-half of the arriving nodes' blobs (IncompleteMap)
        self.hash_many = hash_many
        self.header: Optional[bytes] = None
        self.fields: Optional[dict] = None
        self.tx_map: Optional[IncompleteMap] = None
        self.state_map: Optional[IncompleteMap] = None
        self.failed = False
        self.created_at = _time.monotonic() if now is None else now
        self.last_progress = self.created_at
        # True when the LCL catch-up path requested this ledger; repair
        # acquisitions (LedgerCleaner) must NEVER route through LCL
        # adoption (on_complete), only through their own callbacks
        self.for_lcl = False

    # -- progress ---------------------------------------------------------

    def is_complete(self) -> bool:
        return (
            self.header is not None
            and self.tx_map is not None
            and self.state_map is not None
            and self.tx_map.is_complete()
            and self.state_map.is_complete()
        )

    def next_requests(self, per_tree: int = 256) -> list[GetLedger]:
        """What to ask peers for next (reference: trigger)."""
        if self.header is None:
            return [GetLedger(self.hash, 0, W_HEADER, [])]
        out = []
        for what, imap in (
            (W_TX_TREE, self.tx_map),
            (W_STATE_TREE, self.state_map),
        ):
            if imap is not None and not imap.is_complete():
                missing = imap.missing_nodes(per_tree)
                out.append(
                    GetLedger(
                        self.hash, 0, what, [nid.encode() for nid, _h in missing]
                    )
                )
        return out

    def resolve_local(self, fetch: Callable[[bytes], Optional[bytes]]) -> int:
        """Fill missing nodes from a LOCAL (hash -> prefix-blob) source
        before asking the network: near-tip ledgers share almost their
        whole trees with ledgers we already hold, so catch-up only
        fetches the delta over the wire (the reference gets this from
        SHAMap's node cache + fetch packs). Returns nodes resolved."""
        total = 0
        for imap in (self.tx_map, self.state_map):
            if imap is None:
                continue
            while not imap.is_complete():
                found = []
                for _nid, h in imap.missing_nodes(4096):
                    blob = fetch(h)
                    if blob is not None:
                        found.append((h, blob))
                if not found or imap.add_nodes(found) == 0:
                    break
                total += len(found)
        return total

    # -- data intake ------------------------------------------------------

    def take_header(self, blob: bytes) -> bool:
        """Verify and accept the ledger header (the 'base' in the
        reference). The header IS the hashed content: LWR-prefixed
        SHA-512-half must equal the ledger hash we're acquiring."""
        if self.header is not None:
            return False  # duplicate — no progress
        if prefix_hash(HP_LEDGER_MASTER, blob) != self.hash:
            return False
        self.header = blob
        f = parse_header(blob)
        self.fields = f
        self.tx_map = IncompleteMap(f["tx_hash"], TNType.TX_MD,
                                    hash_many=self.hash_many)
        self.state_map = IncompleteMap(f["account_hash"], TNType.ACCOUNT_STATE,
                                       hash_many=self.hash_many)
        return True

    def take_nodes(self, what: int, pairs: list[tuple[bytes, bytes]]) -> int:
        """Accept LedgerData nodes: (node_id_wire, blob) pairs. Node
        position ids route the request; integrity comes from the
        hash-verified attach inside IncompleteMap (reference: takeNodes →
        SHAMapSync::addKnownNode)."""
        imap = self.tx_map if what == W_TX_TREE else self.state_map
        if imap is None:
            return 0
        by_id: dict[SHAMapNodeID, bytes] = {}
        for nid_wire, blob in pairs:
            try:
                by_id[SHAMapNodeID.decode(nid_wire)] = blob
            except ValueError:
                continue
        # a reply can contain several tree levels; every accepted level
        # exposes new positions, so keep matching until nothing new lands
        n = 0
        progressed = True
        while progressed and by_id:
            progressed = False
            want = {
                nid: h
                for nid, h in imap.missing_nodes(limit=4 * len(by_id) + 16)
            }
            batch = [
                (h, by_id[nid])
                for nid, h in want.items()
                if nid in by_id and not imap.have_node(h)
            ]
            if batch:
                got = imap.add_nodes(batch)
                n += got
                progressed = got > 0
        return n

    # -- completion -------------------------------------------------------

    def build_ledger(self) -> Ledger:
        assert self.is_complete()
        f = self.fields
        led = Ledger(
            seq=f["seq"],
            parent_hash=f["parent_hash"],
            tot_coins=f["tot_coins"],
            fee_pool=f["fee_pool"],
            inflation_seq=f["inflation_seq"],
            close_time=f["close_time"],
            parent_close_time=f["parent_close_time"],
            close_resolution=f["close_resolution"],
            close_flags=f["close_flags"],
            tx_map=self.tx_map.to_shamap(self.hash_batch),
            state_map=self.state_map.to_shamap(self.hash_batch),
        )
        led.closed = True
        led.accepted = True
        if led.hash() != self.hash:
            raise ValueError("acquired ledger does not hash to target")
        return led


class InboundLedgers:
    """Dedup container of running acquisitions
    (reference: InboundLedgers.cpp)."""

    def __init__(self, send: Callable[[GetLedger], None],
                 hash_batch: Optional[Callable] = None,
                 local_fetch: Optional[Callable[[bytes], Optional[bytes]]] = None,
                 clock: Optional[Callable[[], float]] = None):
        import time as _time

        self.send = send  # broadcast/anycast a GetLedger to peers
        # progress/expiry clock: the NODE's clock (virtual on the
        # deterministic simnet — wall-clock deadlines never fire there,
        # which once let a dead acquisition pin LCL catch-up forever)
        self.clock = clock if clock is not None else _time.monotonic
        self.hash_batch = hash_batch
        # arrival hashing: batches of acquired nodes checked on the
        # hasher, and their nodes
        self.hash_batches = 0
        self.hashed_nodes = 0
        # optional hash -> prefix-blob lookup into local storage so
        # acquisitions only fetch the DELTA over the wire
        self.local_fetch = local_fetch
        self.live: dict[bytes, InboundLedger] = {}
        self.on_complete: Optional[Callable[[Ledger], None]] = None
        # per-acquisition completion callbacks (repair path)
        self._callbacks: dict[bytes, list[Callable]] = {}
        # hashes of acquisitions that recently left `live` (completed,
        # failed, or expired) -> monotonic time of departure. Late
        # replies from peers we legitimately asked (timer re-anycasts
        # rotate targets) must be neither charged nor scored.
        self._recent: dict[bytes, float] = {}

    RECENT_TTL = 60.0

    RECENT_CAP = 256

    def _mark_recent(self, ledger_hash: bytes) -> None:
        now = self.clock()
        self._recent.pop(ledger_hash, None)  # re-insert at newest position
        self._recent[ledger_hash] = now
        if len(self._recent) > self.RECENT_CAP:
            # TTL prune first; if everything is still fresh (fast
            # catch-up), evict oldest-first so the dict stays bounded
            self._recent = {
                h: t for h, t in self._recent.items()
                if now - t < self.RECENT_TTL
            }
            while len(self._recent) > self.RECENT_CAP:
                del self._recent[next(iter(self._recent))]

    def hash_many(self, blobs) -> list[bytes]:
        """SHA-512-half of acquired nodes' prefix-format blobs in one
        batch of the hasher's packed door (each blob carries its 4-byte
        domain prefix, as a packed message does); on the host where the
        hasher has no such door."""
        packed = getattr(self.hash_batch, "hash_packed", None)
        if packed is None:
            from ..utils.hashes import sha512_half

            return [sha512_half(b) for b in blobs]
        offsets = [0]
        for b in blobs:
            offsets.append(offsets[-1] + len(b))
        self.hash_batches += 1
        self.hashed_nodes += len(blobs)
        return packed(b"".join(blobs), offsets)

    def recently_done(self, ledger_hash: bytes) -> bool:
        t = self._recent.get(ledger_hash)
        return t is not None and self.clock() - t < self.RECENT_TTL

    def acquire(
        self, ledger_hash: bytes, callback: Optional[Callable] = None,
        for_lcl: bool = False,
    ) -> InboundLedger:
        """Start (or join) an acquisition. `callback(ledger)` fires for
        THIS request on completion; the global on_complete (the LCL
        adoption hook) fires only for sessions marked ``for_lcl`` —
        repair acquisitions (LedgerCleaner) persist old ledgers without
        ever switching the live chain onto them."""
        il = self.live.get(ledger_hash)
        if callback is not None:
            self._callbacks.setdefault(ledger_hash, []).append(callback)
        if il is None:
            il = InboundLedger(ledger_hash, self.hash_batch,
                               now=self.clock(), hash_many=self.hash_many)
            il.for_lcl = for_lcl
            self.live[ledger_hash] = il
            self.trigger(il)
        elif for_lcl:
            il.for_lcl = True
        return il

    def abandon(self, ledger_hash: bytes) -> None:
        """Drop a live acquisition (retargeting): callers' slots are
        released with a None result, late replies are absorbed by the
        recently-done set."""
        il = self.live.pop(ledger_hash, None)
        if il is None:
            return
        self._mark_recent(ledger_hash)
        for cb in self._callbacks.pop(ledger_hash, []):
            cb(None)

    def trigger(self, il: InboundLedger) -> None:
        if self.local_fetch is not None:
            if il.header is None:
                # the header lives in the same store under the ledger
                # hash (HP_LEDGER_MASTER-prefixed); a ledger we already
                # hold on disk must not need a peer at all
                blob = self.local_fetch(il.hash)
                if blob is not None:
                    il.take_header(strip_ledger_prefix(blob))
            if il.header is not None and il.resolve_local(self.local_fetch):
                il.last_progress = self.clock()
            if self._finish(il):
                return
        for req in il.next_requests():
            self.send(req)

    def _finish(self, il: InboundLedger) -> bool:
        """Completion/failure bookkeeping; True when the session ended."""
        if not il.is_complete():
            return False
        h = il.hash
        try:
            ledger = il.build_ledger()
        except (ValueError, KeyError):
            il.failed = True
            del self.live[h]
            self._mark_recent(h)
            for cb in self._callbacks.pop(h, []):
                cb(None)  # failure: callers release their slots
            return True
        del self.live[h]
        self._mark_recent(h)
        for cb in self._callbacks.pop(h, []):
            cb(ledger)
        if self.on_complete is not None and il.for_lcl:
            self.on_complete(ledger)
        return True

    def expire_stale(self, max_age_s: float = 120.0) -> int:
        """Drop acquisitions that made no progress for `max_age_s` —
        unserveable requests (e.g. history no peer holds) must not pin
        sessions and re-broadcast forever (reference: PeerSet failure
        timeouts). Runs on the injected clock (virtual on the simnet).
        Returns the number expired."""
        now = self.clock()
        stale = [
            h
            for h, il in self.live.items()
            if now - il.last_progress > max_age_s
        ]
        for h in stale:
            del self.live[h]
            self._mark_recent(h)
            for cb in self._callbacks.pop(h, []):
                cb(None)  # expiry: callers release their slots
        return len(stale)

    def take_ledger_data(self, msg: LedgerData) -> int:
        """Route a LedgerData reply; returns how much PROGRESS it made
        (0 = ignored/duplicate/unknown — callers use this to score the
        sending peer). Only replies that made progress re-trigger
        requests — a duplicate reply from a second peer must not fan out
        another request wave (the reference throttles the same way via
        PeerSet progress timeouts)."""
        il = self.live.get(msg.ledger_hash)
        if il is None:
            return 0
        progressed = 0
        if msg.what == W_HEADER:
            for _nid, blob in msg.nodes:
                if il.take_header(blob):
                    progressed += 1
        else:
            progressed = il.take_nodes(msg.what, msg.nodes)
        if progressed:
            il.last_progress = self.clock()
        if self._finish(il):
            return max(progressed, 1) if not il.failed else progressed
        if progressed:
            self.trigger(il)
        return progressed


def serve_get_ledger(ledger: Optional[Ledger], msg: GetLedger) -> Optional[LedgerData]:
    """Answer a peer's GetLedger from a closed ledger we hold
    (reference: PeerImp::getLedger → TMLedgerData reply)."""
    if ledger is None:
        return None
    if msg.what == W_HEADER:
        return LedgerData(
            msg.ledger_hash, ledger.seq, W_HEADER, [(b"", ledger.header_bytes())]
        )
    tree = ledger.tx_map if msg.what == W_TX_TREE else ledger.state_map
    nodes: list[tuple[bytes, bytes]] = []
    if not msg.node_ids:
        # no specific request → send the root
        ids = [SHAMapNodeID.root()]
    else:
        ids = []
        for nid_wire in msg.node_ids:
            try:
                ids.append(SHAMapNodeID.decode(nid_wire))
            except ValueError:
                continue
    tree.get_hash()
    from ..state.shamap import serialize_node_prefix

    for nid in ids:
        node = _descend(tree, nid)
        if node is None:
            continue
        # FAT reply (reference: fetch-pack / 'fat' related-node
        # serving): greedy preorder DFS under each requested node,
        # budget-bounded. Preorder guarantees every child lands AFTER
        # its parent in the reply, so the acquirer's frontier matching
        # consumes the whole pack in one pass. Depth-first (not one
        # level) matters: order-book directory keys share 24-byte
        # prefixes, so state trees carry ~48-nibble single-child chain
        # paths — serving one level per round trip made deep-tree
        # catch-up structurally slower than the close cadence (a
        # scenario-fuzzer find: a revived validator could NEVER catch
        # up under an order-book workload).
        stack = [(nid, node)]
        while stack and len(nodes) < MAX_REPLY_NODES:
            cur_id, cur = stack.pop()
            cur = resolve_node(cur)  # lazy serving tree: fault on touch
            nodes.append((cur_id.encode(), serialize_node_prefix(cur)))
            if hasattr(cur, "children"):
                for branch in range(len(cur.children) - 1, -1, -1):
                    child = cur.children[branch]
                    if child is not None:
                        stack.append((cur_id.child(branch), child))
    if not nodes:
        return None
    return LedgerData(msg.ledger_hash, ledger.seq, msg.what, nodes)


def _descend(tree: SHAMap, nid: SHAMapNodeID):
    node = tree.root
    for nb in nid.nibbles():
        node = resolve_node(node)
        if node is None or not hasattr(node, "children"):
            return None
        node = node.children[nb]
    return resolve_node(node)


# -- segment-granular catch-up ---------------------------------------------

# segstore record layout (shared with cpplog, nodestore/segstore.py):
# [u32 body_len LE | u8 flags | 32B key | u8 type | blob]
_SEG_REC_HEADER = 37


def iter_segment_records(data: bytes):
    """Parse one segment's raw bytes into (key, type_byte, blob) records.
    A trailing partial record (snapshot of a growing active segment) is
    ignored; a structurally impossible length raises ValueError so the
    caller can treat the whole transfer as garbage."""
    off, n = 0, len(data)
    while off + _SEG_REC_HEADER <= n:
        body_len, flags = struct.unpack_from("<IB", data, off)
        if body_len < 1 or body_len > (64 << 20):
            raise ValueError(f"segment record length {body_len} at {off}")
        if flags != 0:
            raise ValueError(f"unknown segment record flags {flags}")
        end = off + _SEG_REC_HEADER + body_len
        if end > n:
            break  # torn tail of an active-segment snapshot
        key = data[off + 5: off + 37]
        body = data[off + _SEG_REC_HEADER: end]
        yield key, body[0], body[1:]
        off = end


class SegmentCatchup:
    """Bulk segment transfer into the local NodeStore (see module doc).

    Transport-agnostic and clock-driven: the owner supplies ``send(peer,
    msg)``, ``peers()`` (candidate peer ids, stable order), a monotonic
    ``clock()`` and a ``store(type_byte, key, blob)`` sink; ``tick(now)``
    advances timeouts/retries. On the deterministic simnet the clock is
    virtual, so every timeout, retry and backoff replays bit-identically
    for a given seed.
    """

    # a finished session (done OR fallback) re-arms after this long, so
    # a transient first-episode failure can never disable the bulk path
    # for the node's lifetime
    REARM_S = 60.0
    # a segment transfer may exceed its manifest-advertised size only by
    # this much (the active segment grows between manifest and fetch);
    # anything bigger is a hostile total and condemns the peer
    GROWTH_SLACK = 8 << 20
    # absolute per-segment ceiling, manifest or not
    MAX_SEGMENT_TRANSFER = 512 << 20

    def __init__(
        self,
        send: Callable[[object, object], None],
        peers: Callable[[], list],
        store: Callable[[int, bytes, bytes], None],
        clock: Callable[[], float],
        request_timeout: float = 4.0,
        max_retries: int = 8,
        backoff_base: float = 1.0,
        backoff_max: float = 30.0,
        seed: int = 0,
        note_byzantine: Optional[Callable] = None,
        on_complete: Optional[Callable[[], None]] = None,
        on_condemn: Optional[Callable] = None,
    ):
        import random
        import threading

        from .metrics import AtomicCounters

        # one lock for every public entry point: over TCP, replies land
        # on per-peer reader threads while tick() runs on the timer
        # thread — unsynchronized interleaving could double-charge
        # timeouts for answered requests or abandon a healthy transfer.
        # The simnet is single-threaded; an uncontended lock is free.
        self._lock = threading.RLock()
        self.send = send
        self.peers = peers
        self.store = store
        self.clock = clock
        self.request_timeout = request_timeout
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.rng = random.Random(0xCA7C ^ seed)
        self.note_byzantine = note_byzantine
        self.on_complete = on_complete
        # unified peer scoring seam: a condemned peer also takes a
        # resource charge on its overlay endpoint (the owner wires
        # this to TcpOverlay.charge_peer with FEE_GARBAGE_SEGMENT), so
        # relay, catch-up, and admission privilege degrade together
        self.on_condemn = on_condemn
        self.active = False
        self.state = "idle"  # idle | manifest | fetch | done | fallback
        self._finished_at: Optional[float] = None  # for can_start rearm
        self.counters = AtomicCounters(
            "started", "completed", "requests", "replies", "timeouts",
            "retries", "backoffs", "peer_switches", "garbage_records",
            "garbage_peers", "fallbacks", "segments", "records", "bytes",
            "late_replies", "epoch_restarts",
        )
        self._reset_session()

    def _reset_session(self) -> None:
        self._queue: list[int] = []      # segment ids still to fetch
        self._sizes: dict[int, int] = {}  # manifest-advertised sizes
        self._cur_seg: Optional[int] = None
        self._cur_total = 0
        self._buf = bytearray()
        self._want: Optional[tuple] = None  # ("manifest",) | ("seg", id)
        self._deadline: Optional[float] = None
        self._backoff_until = 0.0
        self._attempts = 0               # for the CURRENT want
        self._peer = None
        self._peer_failures: dict = {}
        self._bad_peers: set = set()
        # snapshot-handoff epoch (doc/follower.md): the serving peer's
        # sealed-set fingerprint from the manifest reply; every chunk
        # fetch is pinned to it and a mid-transfer move restarts the
        # session from a fresh manifest. 0 = pre-epoch peer (don't-care)
        self._snap_epoch = 0
        self._snap_seq = 0

    # -- lifecycle ---------------------------------------------------------

    def can_start(self, now: float) -> bool:
        """A new session may begin: never ran, or the previous one
        (completed or fallen back) finished REARM_S ago."""
        with self._lock:
            if self.active:
                return False
            if self.state == "idle":
                return True
            return (
                self._finished_at is not None
                and now - self._finished_at >= self.REARM_S
            )

    def start(self) -> bool:
        """Begin (or ignore if already running) a catch-up session.
        Returns whether a new session started."""
        with self._lock:
            if self.active:
                return False
            self._reset_session()
            self.active = True
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

    # -- peer selection ----------------------------------------------------

    def _eligible_peers(self) -> list:
        return [p for p in self.peers() if p not in self._bad_peers]

    def _pick_peer(self):
        """Fewest recorded failures wins; ties break on list order (the
        owner supplies a stable order, so runs replay identically)."""
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
            # epoch-pinned snapshot_fetch: the request names the
            # manifest's epoch so the server (and the wire trace) can
            # tell which snapshot the fetcher believes it is reading
            msg = GetSegments(self._want[1], len(self._buf),
                              snap_epoch=self._snap_epoch)
        self.counters.add("requests")
        self._deadline = now + self.request_timeout
        try:
            self.send(self._peer, msg)
        except Exception:  # noqa: BLE001 — a dead transport is a timeout
            pass

    def tick(self, now: float) -> None:
        """Advance timeouts/backoff; the owner calls this from its timer."""
        with self._lock:
            self._tick_locked(now)

    def _tick_locked(self, now: float) -> None:
        if not self.active or self._want is None:
            return
        if self._deadline is not None and now >= self._deadline:
            # request timed out: score the peer, back off exponentially
            # (seeded jitter decorrelates a fleet of cold nodes), rotate
            # to the best-scoring other peer, give up after max_retries
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
            # snapshot_offer accepted: pin this session to the offered
            # epoch; chunk replies from a different epoch restart it
            self._snap_epoch = int(epoch)
            self._snap_seq = int(snap_seq)
            self._sizes = {int(s[0]): int(s[1]) for s in segments}
            self._queue = sorted(self._sizes)
            if not self._queue:
                self._complete()
                return
            self.state = "fetch"
            self._next_segment()

    def _next_segment(self) -> None:
        if not self._queue:
            self._complete()
            return
        self._cur_seg = self._queue.pop(0)
        self._cur_total = 0
        self._buf = bytearray()
        self._want = ("seg", self._cur_seg)
        self._send_current(self.clock())

    def on_data(self, peer, msg: SegmentData) -> None:
        with self._lock:
            if (
                not self.active
                or self._want is None
                or self._want[0] != "seg"
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
                # the source's sealed set moved under us (rotation /
                # compaction / online deletion): the manifest's sizes
                # and this segment's byte range may describe a snapshot
                # that no longer exists. Honest behavior, not garbage —
                # restart from a fresh manifest on the SAME peer instead
                # of splicing records from two different snapshots.
                self.counters.add("epoch_restarts")
                self.state = "manifest"
                self._want = ("manifest",)
                self._queue = []
                self._sizes = {}
                self._buf = bytearray()
                self._cur_seg = None
                self._snap_epoch = 0
                self._send_current(self.clock())
                return
            # transfer-size defense: the claimed total is bounded by the
            # manifest-advertised size (plus active-segment growth
            # slack) and a hard ceiling — a hostile total must never buy
            # unbounded buffering on the very node this path defends
            limit = min(
                self.MAX_SEGMENT_TRANSFER,
                self._sizes.get(msg.seg_id, 0) + self.GROWTH_SLACK,
            )
            if msg.total > limit or len(self._buf) + len(msg.data) > limit:
                self._condemn_peer(peer, "oversized_transfer")
                return
            if len(self._buf) < msg.total and not msg.data:
                # the peer claims more bytes exist but sent none: it
                # cannot serve what it advertised — treating the torn
                # buffer as a complete segment would silently record a
                # partial transfer as success
                self._condemn_peer(peer, "short_transfer")
                return
            self._buf.extend(msg.data)
            self._cur_total = msg.total
            if len(self._buf) < self._cur_total:
                self._send_current(self.clock())  # next chunk
                return
            self._ingest_segment(peer)

    def _condemn_peer(self, peer, why: str) -> None:
        """Per-peer fallback: this peer served garbage (bad records, a
        hostile total, or a short transfer) — condemn it for the session
        and refetch the SAME segment elsewhere; only an out-of-peers
        session falls back to the node-granular walk."""
        self.counters.add("garbage_peers")
        if self.note_byzantine is not None:
            self.note_byzantine("garbage_segment", peer=None,
                                seg=self._cur_seg, why=why)
        if self.on_condemn is not None:
            try:
                self.on_condemn(peer)
            except Exception:  # noqa: BLE001 — the charge is bookkeeping;
                pass           # session fallback below must still run
        self._bad_peers.add(peer)
        self._peer = None
        if not self._eligible_peers():
            self._fallback("all_peers_garbage")
            return
        self._buf = bytearray()
        self._maybe_switch_peer()
        self._send_current(self.clock())

    def _ingest_segment(self, peer) -> None:
        """Verify and store a completed segment transfer. Every record is
        content-addressed, so garbage is detected per record without any
        out-of-band trust; ONE bad record condemns the transfer and the
        serving peer (per-peer fallback), never the whole session."""
        good: list[tuple[bytes, int, bytes]] = []
        bad = 0
        try:
            for key, type_byte, blob in iter_segment_records(bytes(self._buf)):
                if _sha512_half(blob) == key:
                    good.append((key, type_byte, blob))
                else:
                    bad += 1
        except ValueError:
            bad += 1
        if bad:
            self.counters.add("garbage_records", bad)
            self._condemn_peer(peer, "bad_records")
            return
        for key, type_byte, blob in good:
            try:
                self.store(type_byte, key, blob)
            except Exception:  # noqa: BLE001 — a failed local write must
                pass           # not kill the session; the tree walk re-fetches
        self.counters.add_many(
            segments=1, records=len(good), bytes=len(self._buf)
        )
        self._next_segment()

    # -- terminal states ---------------------------------------------------

    def _complete(self) -> None:
        self.active = False
        self.state = "done"
        self._want = None
        self._finished_at = self.clock()
        self.counters.add("completed")
        if self.on_complete is not None:
            try:
                self.on_complete()
            except Exception:  # noqa: BLE001 — completion hook only
                pass

    def _fallback(self, reason: str) -> None:
        """Give up on the bulk path for THIS session: the node-granular
        GetLedger walk (always running underneath) remains the way
        forward, and can_start re-arms a fresh session after REARM_S —
        one bad episode must not disable bulk catch-up forever. Loud in
        the counters, silent in behavior — graceful degradation."""
        self.active = False
        self.state = "fallback"
        self._want = None
        self._finished_at = self.clock()
        self.counters.add("fallbacks")

    def get_json(self) -> dict:
        out = self.counters.snapshot()
        with self._lock:
            out["state"] = self.state
            out["active"] = self.active
            out["snap_epoch"] = self._snap_epoch
            out["snap_seq"] = self._snap_seq
        return out


def _sha512_half(blob: bytes) -> bytes:
    from ..utils.hashes import sha512_half

    return sha512_half(blob)
