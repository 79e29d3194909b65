"""InfoSub: pub/sub subscriber abstraction + subscription manager.

Reference: src/ripple_net/rpc/InfoSub.cpp + NetworkOPsImp's mSub* maps
(NetworkOPsImp.h:372-392) — streams: `ledger`, `server`, `transactions`,
`transactions_proposed` (rt_transactions), per-`accounts` and per-`books`
subscriptions. WS connections implement the InfoSub sink; closes fan out
from the close path.

Fan-out is SHARDED ([subs] shards=N, ROADMAP item 3): event delivery
rides N worker threads, each subscriber pinned to one shard so its
per-client order holds, with a bounded per-client send queue
(drop-OLDEST on overflow — a slow reader sees a gap, never a stale
stream) and slow-consumer eviction past a consecutive-drop threshold.
The publishing thread (in networked mode: the ordered persist worker)
only ENQUEUES — one wedged websocket can never stall publish for the
other 10k subscribers. shards=0 is the legacy inline path (tests that
want synchronous delivery construct the manager that way).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from ..state.ledger import Ledger

__all__ = ["InfoSub", "SubscriptionManager"]


class InfoSub:
    """One subscriber (a WS connection or an in-process test sink)."""

    _next_id = 0

    def __init__(self, send: Callable[[dict], None], client_ip: str = ""):
        self.send = send
        InfoSub._next_id += 1
        self.id = InfoSub._next_id
        # resource-plane identity: path-update shedding/charging keys on
        # the client endpoint (empty for in-process sinks: never charged)
        self.client_ip = client_ip
        self.streams: set[str] = set()
        self.accounts: set[bytes] = set()
        self.accounts_proposed: set[bytes] = set()
        # live path-find subscriptions (reference: PathRequest) —
        # request id -> decoded {src, dst, dst_amount, send_max, echo}
        self.path_requests: dict[int, dict] = {}
        self._next_path_id = 0
        # sharded-fanout state (owned by the shard's lock, not this
        # object): bounded pending-event queue + slow-consumer tracking
        self.sendq: deque = deque()
        self.queued = False      # currently in its shard's ready ring
        self.drop_run = 0        # consecutive drops (resets on delivery)
        self.dropped = 0
        self.evicted = False
        # resume cursor: highest ledgerClosed seq ENQUEUED to this
        # client (guarded by the manager's replay lock) — the monotonic
        # floor that suppresses duplicates when a resume replay overlaps
        # a live publish (doc/follower.md "Resume cursors")
        self.last_seq = 0


class _FanoutShard:
    """One fanout worker: a ready-ring of subscribers with pending
    events, drained FIFO per subscriber. All queue state is guarded by
    this shard's lock; the actual send runs OUTSIDE it."""

    # per-turn drain budget: bounds how long one chatty subscriber can
    # hold the worker before the ring rotates
    DRAIN_BURST = 16

    def __init__(self, mgr: "SubscriptionManager", idx: int):
        self.mgr = mgr
        self.idx = idx
        self.cv = threading.Condition()
        self.ready: deque[InfoSub] = deque()
        # per-shard accounting (satellite of the tree scale-out): queue
        # depth + drop/evict counts, scraped via GET /metrics so the
        # watchdog's fanout rule can be cross-checked from Prometheus
        self.depth = 0       # pending events across this shard's subs
        self.dropped = 0
        self.evicted = 0
        self._stop = False
        self._idle = True
        self.thread = threading.Thread(
            target=self._run, name=f"subs-fanout-{idx}", daemon=True
        )
        self.thread.start()

    def enqueue(self, sub: InfoSub, msg: dict, now: float) -> None:
        mgr = self.mgr
        evict = False
        with self.cv:
            if sub.evicted:
                return
            if len(sub.sendq) >= mgr.sendq_cap:
                # drop-OLDEST: the freshest state wins; the client sees
                # a gap, never a stale stream stretching back minutes
                sub.sendq.popleft()
                sub.dropped += 1
                sub.drop_run += 1
                self.depth -= 1
                self.dropped += 1
                mgr._bump("dropped_events")
                if sub.drop_run >= mgr.evict_drops:
                    sub.evicted = True
                    evict = True
                    self.evicted += 1
                    self.depth -= len(sub.sendq)
                    sub.sendq.clear()
            if not evict:
                sub.sendq.append((msg, now))
                self.depth += 1
                mgr._bump("published")
                if not sub.queued:
                    sub.queued = True
                    self.ready.append(sub)
                    self.cv.notify()
        if evict:
            mgr._evict(sub, reason="slow_consumer")

    def _run(self) -> None:
        mgr = self.mgr
        while True:
            with self.cv:
                while not self.ready and not self._stop:
                    self._idle = True
                    self.cv.notify_all()  # flush() waits on idle
                    self.cv.wait(timeout=1.0)
                if self._stop:
                    return
                self._idle = False
                sub = self.ready.popleft()
                batch = []
                for _ in range(self.DRAIN_BURST):
                    if not sub.sendq:
                        break
                    batch.append(sub.sendq.popleft())
                self.depth -= len(batch)
                if sub.sendq:
                    self.ready.append(sub)  # rotate: fairness
                else:
                    sub.queued = False
            dead = False
            for msg, t_enq in batch:
                try:
                    sub.send(msg)
                except Exception:  # noqa: BLE001 — a dead subscriber must
                    dead = True    # not break the fan-out plane
                    break
                now = time.perf_counter()
                lag_ms = (now - t_enq) * 1000.0
                with mgr._stats_lock:
                    mgr.lag_hist.record(lag_ms)
                    mgr.stats["delivered"] += 1
                sub.drop_run = 0
                if (
                    mgr.tracer is not None
                    and mgr.tracer.enabled
                    and msg.get("type") == "ledgerClosed"
                    and sub.id % 256 == 1
                ):
                    # sampled publish→deliver spans (`subs.fanout`): one
                    # representative per ~256 subscribers per close, so
                    # a 10k-subscriber fanout leaves evidence without
                    # flooding the ring
                    mgr.tracer.complete(
                        "subs.fanout", "publish", t_enq, now,
                        shard=self.idx, sub=sub.id,
                        seq=msg.get("ledger_index"),
                    )
            if dead:
                with self.cv:
                    self.evicted += 1
                    self.depth -= len(sub.sendq)
                    sub.sendq.clear()
                mgr._evict(sub, reason="dead")

    def drained(self) -> bool:
        with self.cv:
            return self._idle and not self.ready

    def stop(self) -> None:
        with self.cv:
            self._stop = True
            self.cv.notify_all()
        self.thread.join(timeout=5)


class SubscriptionManager:
    """Fan-out hub wired into NetworkOPs' close/tx hooks."""

    def __init__(self, ops, shards: int = 0, sendq_cap: int = 512,
                 evict_drops: int = 64, push_retries: int = 5,
                 resume_horizon: int = 1024, tracer=None):
        from ..node.metrics import LatencyHist
        from ..node.tracer import STAGE_BOUNDS

        self.ops = ops
        self.tracer = tracer
        # liquidity plane (paths/plane.py), wired by the node when
        # [paths] is enabled; None keeps the legacy unbudgeted publisher
        self.path_plane = None
        self.sendq_cap = max(1, int(sendq_cap))
        self.evict_drops = max(1, int(evict_drops))
        self.push_retries = int(push_retries)
        self._lock = threading.Lock()
        self._subs: dict[int, InfoSub] = {}
        # url -> RpcSub (reference: NetworkOPs mRpcSubMap): HTTP-callback
        # subscriptions outlive any one request; found/created by
        # `subscribe` with a url (admin-only)
        self.rpc_subs: dict[str, InfoSub] = {}
        # fanout plane: publish→deliver lag + drop/evict accounting.
        # stats writes ride the shard locks (or the publish thread when
        # inline), so plain int bumps under those locks suffice.
        self.stats = {
            "published": 0, "delivered": 0, "dropped_events": 0,
            "slow_evicted": 0, "dead_evicted": 0,
            "resumed": 0, "resume_replayed": 0, "resume_cold": 0,
            "dup_suppressed": 0,
        }
        # resume-from-seq replay ring (reconnect-storm hardening): the
        # last `resume_horizon` ledgerClosed events, so a dropped client
        # replays its gap instead of re-subscribing cold. The replay
        # lock ALSO serializes each sub's cursor stamp (last_seq) with
        # resume's replay — without that, a live publish racing a replay
        # could jump the cursor past undelivered replayed seqs.
        self.resume_horizon = max(0, int(resume_horizon))
        self._replay: deque = deque(maxlen=max(1, self.resume_horizon))
        self._replay_lock = threading.Lock()
        # one lock for the shared counters + lag histogram: enqueues
        # ride per-shard locks and deliveries ride worker threads, so
        # bare `+=` across shards would lose updates
        self._stats_lock = threading.Lock()
        self.lag_hist = LatencyHist(bounds=STAGE_BOUNDS, interpolate=True)
        self._shards: list[_FanoutShard] = [
            _FanoutShard(self, i) for i in range(max(0, int(shards)))
        ]
        ops.on_ledger_closed.append(self._pub_ledger)
        ops.on_proposed_tx.append(self._pub_proposed)

    def rpc_sub(self, url: str, username: str = "", password: str = ""):
        """Find-or-create the RPCSub for a url (reference: findRpcSub /
        addRpcSub); fresh credentials update an existing sub."""
        from .rpcsub import RpcSub

        with self._lock:
            sub = self.rpc_subs.get(url)
            if sub is None:
                sub = RpcSub(url, username, password,
                             max_retries=self.push_retries)
                self.rpc_subs[url] = sub
            elif username or password:
                sub.set_credentials(username, password)
        # slow-consumer eviction for the HTTP-push side too: a url whose
        # listener keeps exhausting delivery retries is dead weight and
        # gets pruned outright (rpcsub.py fires this past its threshold)
        sub.on_dead = lambda s=sub: self._evict(s, reason="slow_consumer")
        return sub

    def rpc_sub_lookup(self, url: str):
        """Find only (unsubscribe must never create — a typo'd url would
        register a phantom subscription and report success)."""
        with self._lock:
            return self.rpc_subs.get(url)

    def prune_rpc_sub(self, sub) -> None:
        """Drop an RpcSub that no longer subscribes to anything: a url
        entry with no streams/accounts must not live (and get POSTed
        events) forever. Emptiness is re-checked under the registry
        lock so a concurrent re-subscribe (which adds a stream through
        the same lock-guarded find-or-create) is never destroyed."""
        with self._lock:
            if (sub.streams or sub.accounts or sub.accounts_proposed
                    or sub.path_requests):
                return
            self.rpc_subs.pop(getattr(sub, "url", None), None)
            self._subs.pop(sub.id, None)
        close = getattr(sub, "close", None)
        if close is not None:
            close()

    # -- subscribe / unsubscribe (reference: handlers/Subscribe.cpp) ------

    def add(self, sub: InfoSub) -> None:
        with self._lock:
            self._subs[sub.id] = sub

    def remove(self, sub_id: int) -> None:
        with self._lock:
            self._subs.pop(sub_id, None)

    def subscribe_streams(self, sub: InfoSub, streams: list[str]) -> dict:
        """Returns the initial result payload (ledger stream returns the
        current state snapshot, reference Subscribe.cpp:86-112)."""
        result: dict = {}
        for stream in streams:
            if stream not in ("ledger", "server", "transactions",
                              "transactions_proposed", "rt_transactions"):
                continue
            sub.streams.add(stream)
            if stream == "ledger":
                result.update(self._ledger_snapshot())
        self.add(sub)
        return result

    def unsubscribe_streams(self, sub: InfoSub, streams: list[str]) -> None:
        for stream in streams:
            sub.streams.discard(stream)

    def subscribe_accounts(self, sub: InfoSub, accounts: list[bytes],
                           proposed: bool = False) -> None:
        target = sub.accounts_proposed if proposed else sub.accounts
        target.update(accounts)
        self.add(sub)

    # -- path-find subscriptions (reference: PathRequests) ----------------

    def create_path_request(self, sub: InfoSub, request: dict) -> int:
        """Register a live path search; updates push on every close."""
        sub._next_path_id += 1
        rid = sub._next_path_id
        sub.path_requests[rid] = request
        self.add(sub)
        return rid

    def close_path_request(self, sub: InfoSub,
                           rid: Optional[int] = None) -> bool:
        if rid is None:
            had = bool(sub.path_requests)
            sub.path_requests.clear()
            return had
        return sub.path_requests.pop(rid, None) is not None

    def _pub_path_updates(self, ledger: Ledger) -> None:
        from ..paths import find_paths
        from ..paths.pathfinder import PATH_SEARCH_DEFAULT, PATH_SEARCH_FAST

        from ..protocol.stobject import STPathSet

        pairs = [
            (sub, rid, req)
            for sub in self._each()
            for rid, req in list(sub.path_requests.items())
        ]
        if not pairs:
            return
        # liquidity plane: all subscriptions of one close
        # share the incrementally-advanced book index, re-rank
        # stalest-first under the per-close budget, and shed (not queue)
        # past it or when the endpoint is resource-throttled
        plane = self.path_plane
        books = pre_rank = None
        if plane is not None:
            plane.begin_close(ledger.seq)
            books = plane.books_for(ledger)
            pre_rank = plane.make_pre_rank(ledger)
            by_key = {(sub.id, rid): (sub, rid, req)
                      for sub, rid, req in pairs}
            plane.sync_live(by_key.keys())
            pairs = [by_key[k]
                     for k in plane.order_keys(by_key.keys(), ledger.seq)]
        for sub, rid, req in pairs:
            if plane is not None:
                ip = getattr(sub, "client_ip", "")
                endpoint = (ip, 0) if ip else None
                if not plane.claim_update((sub.id, rid), ledger.seq,
                                          endpoint=endpoint):
                    continue
            # level ramp (reference: PathRequest.cpp:370-379 —
            # answer at PATH_SEARCH_FAST on the first update, then
            # jump to the full PATH_SEARCH level)
            level = (
                PATH_SEARCH_FAST
                if req.get("level", 0) < PATH_SEARCH_FAST
                else PATH_SEARCH_DEFAULT
            )
            req["level"] = level
            try:
                alts = find_paths(
                    ledger, req["src"], req["dst"], req["dst_amount"],
                    send_max=req.get("send_max"), level=level,
                    books=books, pre_rank=pre_rank,
                )
            except Exception:  # noqa: BLE001 — a bad request must not kill publishing
                continue
            if plane is not None:
                plane.note_ranked((sub.id, rid), ledger.seq)
            msg = {
                "type": "path_find",
                "id": rid,
                # only the full-depth search is a definitive answer;
                # the FAST first pass is marked partial so clients
                # wait for the deeper updates (reference:
                # PathRequest's iLastLevel / full_reply contract)
                "full_reply": level >= PATH_SEARCH_DEFAULT,
                "ledger_index": ledger.seq,
                "alternatives": [
                    {
                        "paths_computed": STPathSet(a["paths"]).to_json(),
                        "source_amount": a["source_amount"].to_json(),
                    }
                    for a in alts
                ],
                **req.get("echo", {}),
            }
            self._deliver(sub, msg)

    def unsubscribe_accounts(self, sub: InfoSub, accounts: list[bytes],
                             proposed: bool = False) -> None:
        target = sub.accounts_proposed if proposed else sub.accounts
        target.difference_update(accounts)

    def _ledger_snapshot(self) -> dict:
        lcl = self.ops.lm.closed_ledger()
        return {
            "ledger_index": lcl.seq,
            "ledger_hash": lcl.hash().hex().upper(),
            "ledger_time": lcl.close_time,
            "fee_base": lcl.base_fee,
            "fee_ref": lcl.reference_fee_units,
            "reserve_base": lcl.reserve_base,
            "reserve_inc": lcl.reserve_increment,
        }

    # -- fan-out ----------------------------------------------------------

    def _each(self):
        with self._lock:
            return list(self._subs.values())

    def _pub_ledger(self, ledger: Ledger, results: dict) -> None:
        """reference: NetworkOPs::pubLedger — ledgerClosed stream msg,
        then per-tx accepted messages."""
        msg = {
            "type": "ledgerClosed",
            "ledger_index": ledger.seq,
            "ledger_hash": ledger.hash().hex().upper(),
            "ledger_time": ledger.close_time,
            "fee_base": ledger.base_fee,
            "fee_ref": ledger.reference_fee_units,
            "reserve_base": ledger.reserve_base,
            "reserve_inc": ledger.reserve_increment,
            "txn_count": len(results),
        }
        if self.resume_horizon > 0:
            with self._replay_lock:
                self._replay.append((ledger.seq, msg))
        for sub in self._each():
            if "ledger" in sub.streams:
                self._deliver_ledger(sub, msg)
        # accepted transactions (reference: pubAcceptedTransaction)
        for txid, blob, meta in ledger.tx_entries():
            tx = ledger.parse_tx(txid, blob)
            ter = results.get(txid, TER.tesSUCCESS)
            self._pub_tx(tx, ter, ledger=ledger, validated=True, meta=meta)
        # live path-find subscriptions re-search against the new state on
        # a jtUPDATE_PF job (reference: PathRequests::updateAll) — NOT on
        # this thread, which in networked mode is the ordered persist
        # worker and must not serialize pathfinding into ledger persists
        if any(s.path_requests for s in self._each()):
            from ..node.jobqueue import JobType

            self.ops.jq.add_job(
                JobType.jtUPDATE_PF,
                "pathUpdates",
                lambda: self._pub_path_updates(ledger),
            )

    def pub_server_status(self) -> None:
        """serverStatus event to `server`-stream subscribers (reference:
        NetworkOPs::pubServer on load-factor movement)."""
        from ..node.loadmgr import NORMAL_FEE

        ft = getattr(self.ops, "fee_track", None)
        msg = {
            "type": "serverStatus",
            "server_status": self.ops.server_state(),
            "load_base": NORMAL_FEE,
            "load_factor": ft.load_factor if ft is not None else NORMAL_FEE,
        }
        for sub in self._each():
            if "server" in sub.streams:
                self._deliver(sub, msg)

    def _pub_proposed(self, tx: SerializedTransaction, ter: TER) -> None:
        self._pub_tx(tx, ter, ledger=None, validated=False)

    def _pub_tx(self, tx: SerializedTransaction, ter: TER,
                ledger: Optional[Ledger], validated: bool,
                meta: bytes = b"") -> None:
        msg = {
            "type": "transaction",
            "transaction": _tx_json_with_hash(tx),
            "status": "closed" if validated else "proposed",
            "engine_result": ter.token,
            "engine_result_code": int(ter),
            "engine_result_message": ter.human,
            "validated": validated,
        }
        if ledger is not None:
            msg["ledger_index"] = ledger.seq
            msg["ledger_hash"] = ledger.hash().hex().upper()
        if meta:
            from ..protocol.stobject import STObject

            msg["meta"] = STObject.from_bytes(meta).to_json()

        # accounts touched: from the metadata when we have it (covers
        # crossed offers, trust-line counterparties, issuers — reference
        # getAffectedAccounts); fall back to Account/Destination for
        # proposed txns that carry no meta yet
        touched = {tx.account}
        from ..protocol.sfields import sfDestination

        dest = tx.obj.get(sfDestination)
        if dest:
            touched.add(dest)
        if meta:
            from ..protocol.meta import affected_accounts

            touched.update(affected_accounts(meta))

        if self.tracer is not None and validated and self.tracer.enabled:
            # per-sampled-tx fanout leaf: the publish stage of the tx's
            # cross-node causal tree (subs.fanout spans stay the sampled
            # per-subscriber delivery evidence)
            self.tracer.instant(
                "subs.fanout.tx", "publish", txid=tx.txid(),
                ledger_seq=msg.get("ledger_index"),
            )

        for sub in self._each():
            wants = False
            if validated and "transactions" in sub.streams:
                wants = True
            if not validated and (
                "transactions_proposed" in sub.streams
                or "rt_transactions" in sub.streams
            ):
                wants = True
            if sub.accounts & touched and validated:
                wants = True
            if sub.accounts_proposed & touched:
                wants = True
            if wants:
                self._deliver(sub, msg)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def _deliver(self, sub: InfoSub, msg: dict) -> None:
        """Route one event: shard enqueue (bounded, async) when the
        fanout plane is on, inline send otherwise."""
        if self._shards:
            shard = self._shards[sub.id % len(self._shards)]
            shard.enqueue(sub, msg, time.perf_counter())
            return
        self._bump("published")
        try:
            sub.send(msg)
            self._bump("delivered")
        except Exception:  # noqa: BLE001 — a dead subscriber must not break the pub path
            self.remove(sub.id)
            self._bump("dead_evicted")

    def _deliver_ledger(self, sub: InfoSub, msg: dict) -> None:
        """ledgerClosed funnel: monotonic per-client cursor stamp +
        duplicate suppression (a resume replay overlapping a live
        publish must deliver each seq once, in order). The stamp is
        serialized on the replay lock with resume()'s replay loop."""
        seq = msg.get("ledger_index", 0)
        with self._replay_lock:
            if seq <= sub.last_seq:
                self._bump("dup_suppressed")
                return
            sub.last_seq = seq
            self._deliver(sub, msg)

    def resume(self, sub: InfoSub, last_seq: int) -> dict:
        """Resume-from-seq cursor (reconnect-storm hardening): a
        reconnecting client presents its last-delivered ledgerClosed
        seq; every later event still inside the bounded replay ring is
        re-enqueued in order and the `ledger` stream re-attaches — no
        cold re-subscribe, no silent gap. A cursor PAST the horizon
        gets an explicit cold answer ({"cold": True} with the current
        replay floor) so the client knows to re-subscribe cold.

        The whole replay + registration runs under the replay lock:
        publishes that landed in the ring before we locked are replayed
        here, publishes after we release see the registered sub and
        deliver live, and the per-sub cursor stamp (serialized on the
        same lock) suppresses the overlap — zero gaps, zero dups."""
        with self._replay_lock:
            ring = list(self._replay) if self.resume_horizon > 0 else []
            floor = ring[0][0] if ring else 0
            # resumable iff the client's next event (last_seq+1) is at
            # or above the ring floor — exactly-at-horizon resumes
            cold = (
                self.resume_horizon <= 0
                or last_seq + 1 < floor
                or (not ring and last_seq > 0)
            )
            if cold:
                self._bump("resume_cold")
                return {
                    "resumed": False, "cold": True, "replayed": 0,
                    "horizon": floor,
                }
            sub.last_seq = max(sub.last_seq, int(last_seq))
            replayed = 0
            for seq, msg in ring:
                if seq <= sub.last_seq:
                    continue
                sub.last_seq = seq
                self._deliver(sub, msg)
                replayed += 1
            sub.streams.add("ledger")
            self.add(sub)
        self._bump("resumed")
        self._bump("resume_replayed", replayed)
        return {
            "resumed": True, "cold": False, "replayed": replayed,
            "horizon": floor,
        }

    def shard_stats(self) -> dict:
        """Flat per-shard depth/drop/evict gauges for the Prometheus
        hook (subs_shard.shard<N>_*)."""
        out = {}
        for s in self._shards:
            with s.cv:
                out[f"shard{s.idx}_depth"] = s.depth
                out[f"shard{s.idx}_dropped"] = s.dropped
                out[f"shard{s.idx}_evicted"] = s.evicted
        return out

    def _evict(self, sub: InfoSub, reason: str) -> None:
        """Drop a subscriber the fanout plane gave up on (slow consumer
        past the drop threshold, or a dead sink). Idempotent: the slow
        path and a later dead-sink detection may both fire for one
        sub."""
        with self._lock:
            already = getattr(sub, "_evict_done", False)
            sub._evict_done = True
            sub.evicted = True
            self._subs.pop(sub.id, None)
            url = getattr(sub, "url", None)
            if url is not None and self.rpc_subs.get(url) is sub:
                del self.rpc_subs[url]
        if already:
            return
        self._bump(
            "slow_evicted" if reason == "slow_consumer" else "dead_evicted"
        )
        close = getattr(sub, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every shard drained its queues (tests/smokes that
        assert on delivered events; the serving path never calls it)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(s.drained() for s in self._shards):
                return True
            time.sleep(0.002)
        return all(s.drained() for s in self._shards)

    def stop(self) -> None:
        for s in self._shards:
            s.stop()
        with self._lock:
            rpc_subs = list(self.rpc_subs.values())
        for sub in rpc_subs:
            close = getattr(sub, "close", None)
            if close is not None:
                close()

    def get_json(self) -> dict:
        """`subs.*` counters for get_counts: fanout shape, publish /
        deliver / drop / evict counts, publish→deliver lag quantiles,
        and the HTTP-push (RPCSub) delivery aggregate."""
        with self._lock:
            n_subs = len(self._subs)
            rpc_list = list(self.rpc_subs.values())
        out = {
            "subscribers": n_subs,
            "rpc_subs": len(rpc_list),
            "shards": len(self._shards),
            "sendq_cap": self.sendq_cap,
            "evict_drops": self.evict_drops,
            "resume_horizon": self.resume_horizon,
            **self.stats,
            **self.shard_stats(),
        }
        if self.lag_hist.count:
            out["fanout_lag_p50_ms"] = self.lag_hist.quantile(0.5)
            out["fanout_lag_p99_ms"] = self.lag_hist.quantile(0.99)
        push = {"sent": 0, "retries": 0, "failures": 0, "dropped": 0}
        for sub in rpc_list:
            for k in push:
                push[k] += getattr(sub, "stats", {}).get(k, 0)
        out["push"] = push
        return out


def _tx_json_with_hash(tx: SerializedTransaction) -> dict:
    j = tx.obj.to_json()
    j["hash"] = tx.txid().hex().upper()
    return j
