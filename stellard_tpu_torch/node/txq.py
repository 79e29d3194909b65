"""Admission-control plane: the fee-escalating transaction queue.

Role parity with production XRPL's FeeEscalation/TxQ design (TxQ.cpp):
the reference this repo reproduces predates it and its only overload
story is coarse shedding (job latency targets, the >100-queued-jobs
relay drop), which lets a flood above close capacity grow the open
ledger without bound and collapse close latency. SEDA (Welsh et al.,
SOSP 2001) is the classic argument that a well-conditioned service
needs an explicit bounded queue with admission control at the front
door, not best-effort shedding.

Shape:

- **soft per-ledger cap** (`FeeMetrics`): the number of transactions a
  close can absorb inside its latency budget, adapted continuously from
  an EWMA of the measured per-transaction close cost of recent closes
  (`txns_expected = target_close_ms / ewma_per_tx_ms`, clamped).
- **escalating open-ledger fee**: below the cap the required fee level
  is the reference level (256 = paying exactly the base fee); at or
  above it the requirement rises quadratically with open-ledger size
  (`mult * (n+1)^2 / expected^2`), so a flood prices itself out
  instead of growing the open ledger.
- **bounded fee-priority queue**: transactions paying less than the
  escalated requirement wait in per-account sequence chains, promoted
  in fee-level order (FIFO within a level) into the next open ledger at
  close time. Same (account, seq) resubmissions replace-by-fee (>= 25%
  bump). Overflow evicts the cheapest entry; entries expire after a
  bounded number of ledgers.
- **queue-aware speculation**: promoted transactions are speculatively
  pre-executed against the open window's delta-replay overlay on a
  deferred job OFF the close path, so the close that commits them
  splices recorded deltas instead of re-running the transactor
  (engine/deltareplay.py; records carry origin="promote").
- **kill-switch**: `[txq] enabled=0` restores the direct-apply path
  byte-for-byte (NetworkOPs bypasses `admit`, LedgerMaster re-applies
  the legacy held pile).

Thread model: `admit` runs under the NetworkOPs master lock and
`promote`/`after_close` under the LedgerMaster chain lock; the internal
lock only protects queue structures against concurrent RPC readers and
is NEVER held across an engine apply.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Optional

from ..protocol.sfields import sfBalance, sfSequence
from ..protocol.sttx import SerializedTransaction
from ..protocol.ter import TER
from .loadmgr import NORMAL_FEE

__all__ = ["TxQ", "FeeMetrics", "NORMAL_LEVEL", "fee_level"]

# the reference fee level: a tx paying exactly the base fee.
# meets_network_floor compares fee levels against LoadFeeTrack factors
# directly, so this MUST stay the same 1/256 scale as loadmgr's
# NORMAL_FEE — imported, not redefined, to keep the coupling explicit.
NORMAL_LEVEL = NORMAL_FEE


def fee_level(fee_drops: int, base_fee: int) -> int:
    """Fee level of a payment of `fee_drops` against `base_fee`."""
    return fee_drops * NORMAL_LEVEL // max(1, base_fee)


def level_to_drops(level: int, base_fee: int) -> int:
    """Smallest drops amount whose fee level is >= `level` (ceil)."""
    return -(-level * base_fee // NORMAL_LEVEL)


class FeeMetrics:
    """The adaptive soft cap + escalation curve.

    `txns_expected` is the per-ledger admission cap: how many txs fit in
    `target_close_ms` at the EWMA of the measured per-tx close cost.
    Slow closes shrink it, fast ones grow it — AIMD on the close budget
    rather than rippled's largest-recent-ledger heuristic, because this
    node's capacity is whatever the hardware measures, not a constant.
    """

    def __init__(self, min_cap: int = 32, max_cap: int = 100_000,
                 target_close_ms: float = 500.0, alpha: float = 0.25,
                 escalation_mult: int = NORMAL_LEVEL * 500):
        self.min_cap = max(1, int(min_cap))
        self.max_cap = max(self.min_cap, int(max_cap))
        self.target_close_ms = float(target_close_ms)
        self.alpha = float(alpha)
        self.escalation_mult = int(escalation_mult)
        self.txns_expected = min(self.max_cap, max(self.min_cap, 256))
        self.per_tx_ms: Optional[float] = None
        self.closes = 0

    def note_close(self, tx_count: int, apply_ms: float) -> None:
        """Fold one close's (size, apply wall ms) into the cap."""
        self.closes += 1
        if tx_count <= 0 or apply_ms < 0:
            return  # empty closes carry no capacity signal
        per_tx = apply_ms / tx_count
        if self.per_tx_ms is None:
            self.per_tx_ms = per_tx
        else:
            self.per_tx_ms = (
                (1.0 - self.alpha) * self.per_tx_ms + self.alpha * per_tx
            )
        if self.per_tx_ms > 1e-9:
            cap = int(self.target_close_ms / self.per_tx_ms)
            self.txns_expected = max(self.min_cap, min(self.max_cap, cap))

    def required_level(self, open_count: int) -> int:
        """Required fee level to enter an open ledger holding
        `open_count` txs (reference: TxQ escalation curve — quadratic
        above the expected size)."""
        expected = max(1, self.txns_expected)
        if open_count < expected:
            return NORMAL_LEVEL
        return max(
            NORMAL_LEVEL,
            self.escalation_mult * (open_count + 1) ** 2 // expected ** 2,
        )

    def get_json(self) -> dict:
        return {
            "txns_expected": self.txns_expected,
            "min_cap": self.min_cap,
            "max_cap": self.max_cap,
            "target_close_ms": self.target_close_ms,
            "per_tx_close_ms": (
                round(self.per_tx_ms, 4) if self.per_tx_ms is not None
                else None
            ),
            "closes": self.closes,
        }


class _Entry:
    __slots__ = ("tx", "fee_level", "order", "expire_seq")

    def __init__(self, tx: SerializedTransaction, level: int, order: int,
                 expire_seq: int):
        self.tx = tx
        self.fee_level = level
        self.order = order
        self.expire_seq = expire_seq


class TxQ:
    """The admission-control subsystem between the verify plane and the
    open ledger. One instance per node, shared by NetworkOPs (admit) and
    LedgerMaster (promotion at `_open_next`)."""

    def __init__(
        self,
        metrics: Optional[FeeMetrics] = None,
        enabled: bool = True,
        ledgers_in_queue: int = 20,
        account_cap: int = 10,
        retry_fee_pct: int = 25,
        retention_ledgers: int = 20,
        fee_track=None,
        tracer=None,
    ):
        from .tracer import get_tracer

        self.metrics = metrics or FeeMetrics()
        self.enabled = enabled
        self.ledgers_in_queue = max(1, int(ledgers_in_queue))
        self.account_cap = max(1, int(account_cap))
        self.retry_fee_pct = max(0, int(retry_fee_pct))
        self.retention_ledgers = max(1, int(retention_ledgers))
        self.fee_track = fee_track  # loadmgr.LoadFeeTrack or None
        self.tracer = tracer if tracer is not None else get_tracer()
        self._lock = threading.RLock()
        # account -> {sequence -> _Entry}; chains are small (account_cap)
        self._accounts: dict[bytes, dict[int, _Entry]] = {}
        # lazy min-heap over (fee_level, order, account, seq) for
        # cheapest-first eviction; stale entries (replaced/promoted/
        # expired) are skipped on pop by order mismatch
        self._heap: list[tuple[int, int, bytes, int]] = []
        self._size = 0
        self._order = 0  # arrival counter: FIFO within a fee level
        # promoted-but-not-yet-speculated txs: (target open seq, tx),
        # drained by a deferred job off the close path (spec_dispatch)
        self._pending_spec: list[tuple[int, SerializedTransaction]] = []
        self.spec_dispatch: Optional[Callable[[Callable], bool]] = None
        self._lm = None  # LedgerMaster backref for the deferred drain
        self._deferred_jobs = 0  # open-window jobs in flight (quiesce)
        # drop notifier (eviction / expiry / promote-drop): wired to
        # LocalTxs.remove in networked mode so a dropped local tx stops
        # re-applying and a client resubmit starts a fresh horizon
        self.on_drop: Optional[Callable[[bytes], None]] = None
        # txids promoted into the CURRENT open window — intersected with
        # the next close's splice/fallback classes for the
        # promote_spliced / promote_fallback counters
        self._promoted_window: set[bytes] = set()
        # promoted txs awaiting relay (fee floor met only at promotion);
        # drained outside the chain lock by publish_closed_ledger
        self._pending_relay: list[SerializedTransaction] = []
        self.stats = {
            "admitted_direct": 0,   # applied straight to the open ledger
            "queued": 0,            # entered the queue (incl. replaces)
            "replaced": 0,          # replace-by-fee of a queued entry
            "rejected": 0,          # refused admission (shed)
            "evicted": 0,           # pushed out by a better-paying tx
            "expired": 0,           # aged out by ledger seq
            "absorbed_held": 0,     # terPRE_SEQ holds folded into the queue
            "promoted": 0,          # applied to a new open ledger at close
            "promote_dropped": 0,   # dropped at promotion (tem/tef/tec)
            "promote_spliced": 0,   # promoted txs spliced at their close
            "promote_fallback": 0,  # promoted txs serially re-applied
            "deferred_specs": 0,    # speculations run off the close path
        }

    @classmethod
    def from_config(cls, cfg, fee_track=None, tracer=None) -> "TxQ":
        return cls(
            metrics=FeeMetrics(
                min_cap=cfg.txq_min_cap,
                max_cap=cfg.txq_max_cap,
                target_close_ms=cfg.txq_target_close_ms,
            ),
            enabled=cfg.txq_enabled,
            ledgers_in_queue=cfg.txq_ledgers_in_queue,
            account_cap=cfg.txq_account_cap,
            retry_fee_pct=cfg.txq_retry_fee_pct,
            retention_ledgers=cfg.txq_retention_ledgers,
            fee_track=fee_track,
            tracer=tracer,
        )

    # -- introspection helpers --------------------------------------------

    @property
    def max_size(self) -> int:
        return self.metrics.txns_expected * self.ledgers_in_queue

    def __len__(self) -> int:
        with self._lock:
            return self._size

    @staticmethod
    def open_size(ledger) -> int:
        """Applied-tx count of an OPEN ledger (parsed_txs is seeded by
        LedgerMaster._open_apply exactly once per applied tx)."""
        return len(ledger.parsed_txs)

    def open_ledger_fee(self, ledger) -> int:
        """Drops required to enter the open ledger RIGHT NOW."""
        level = self.metrics.required_level(self.open_size(ledger))
        return level_to_drops(level, ledger.base_fee)

    def meets_network_floor(self, tx: SerializedTransaction,
                            ledger) -> bool:
        """Whether a queued tx pays at least the current NETWORK fee
        floor (local + remote load fees — NOT our open-ledger escalation,
        which is local admission state other nodes don't share). Queued
        txs below the floor are not relayed until promotion applies them
        (reference: TxQ holds relay for queued txs)."""
        floor = NORMAL_LEVEL
        if self.fee_track is not None:
            floor = self.fee_track.network_floor
        fee = tx.fee
        if not fee.is_native or fee.negative:
            return False
        return fee.mantissa * NORMAL_LEVEL >= floor * ledger.base_fee

    # -- admission (NetworkOPs.process_transaction) ------------------------

    def admit(self, tx: SerializedTransaction, lm,
              params) -> tuple[TER, bool]:
        """Post-verify intake: apply directly when the open ledger has
        room (or the tx pays the escalated fee), else queue/shed.
        Caller holds the master lock; returns (TER, did_apply) with the
        same contract as LedgerMaster.do_transaction."""
        tr = self.tracer
        txid = tx.txid()
        open_ledger = lm.current_ledger()
        fee = tx.fee
        if not fee.is_native or fee.negative:
            # malformed fee: the engine's passes_local_checks gate
            # rejects it (temINVALID) before the transactor's sequence
            # check can run, so this bypass cannot surface terPRE_SEQ
            # today. Guard anyway: NetworkOPs skips the legacy hold pile
            # when the queue is on, so if that check ordering ever
            # changed, returning terPRE_SEQ from here would report HELD
            # while silently dropping the tx — fold it into the queue at
            # level 0 like any other hold instead.
            ter, did_apply = lm.do_transaction(tx, params)
            if ter == TER.terPRE_SEQ:
                with lm._lock:
                    qter = self._try_queue(tx, 0, lm, open_ledger)
                return qter, False
            return ter, did_apply
        level = fee_level(fee.mantissa, open_ledger.base_fee)
        open_count = self.open_size(open_ledger)
        required = self.metrics.required_level(open_count)
        with tr.span("txq.admit", "submit", txid=txid,
                     open_count=open_count, required_level=required,
                     fee_level=level):
            if level >= required:
                ter, did_apply = lm.do_transaction(tx, params)
                if ter == TER.terPRE_SEQ:
                    # fold the would-be held pile into the queue: future-
                    # sequence txs wait fee-ordered like everything else
                    with lm._lock:
                        qter = self._try_queue(tx, level, lm, open_ledger)
                    return qter, False
                if did_apply:
                    self.stats["admitted_direct"] += 1
                return ter, did_apply
            # above the soft cap and paying less than the escalated
            # fee. The chain lock covers the open-ledger reads inside
            # _try_queue (account root, open_tx_seqs): the deferred
            # promotion job mutates the same open window under it.
            with lm._lock:
                ter = self._try_queue(tx, level, lm, open_ledger)
            return ter, False

    def _try_queue(self, tx: SerializedTransaction, level: int, lm,
                   open_ledger) -> TER:
        """Queue-entry path; returns terQUEUED on success or the shed/
        reject code. Never applies state."""
        account = tx.account
        seq = tx.sequence
        with self._lock:
            chain = self._accounts.get(account)
            replacing = chain is not None and seq in chain
            # cheap sanity against the open view: a tx that can never
            # apply must not occupy queue space
            root = open_ledger.read_entry_pristine(
                _account_index(account)
            )
            if root is None:
                self.stats["rejected"] += 1
                return TER.terNO_ACCOUNT
            if not replacing:
                a_seq = root[sfSequence]
                cached = open_ledger.open_tx_seqs.get(account)
                if cached is not None and cached + 1 > a_seq:
                    a_seq = cached + 1
                if seq < a_seq:
                    self.stats["rejected"] += 1
                    return TER.tefPAST_SEQ
            bal = root[sfBalance]
            if bal.is_native and tx.fee.is_native:
                # the WHOLE chain's queued fees must be payable, not
                # just this tx's (reference: TxQ's potential-spend
                # check): otherwise a balance-20 account queues
                # account_cap fee-15 txs of which only the first can
                # ever pay, and the rest squat as terINSUF_FEE_B
                # retries until expiry
                queued_spend = sum(
                    e.tx.fee.mantissa for s, e in chain.items()
                    if s != seq and e.tx.fee.is_native
                ) if chain else 0
                if bal.mantissa < queued_spend + tx.fee.mantissa:
                    self.stats["rejected"] += 1
                    return TER.terINSUF_FEE_B
            if replacing:
                return self._replace_by_fee(chain, seq, tx, level)
            if chain is not None and len(chain) >= self.account_cap:
                self.stats["rejected"] += 1
                return TER.telINSUF_FEE_P
            # overflow: evict strictly-cheaper entries, else shed the
            # newcomer (resubmittable: the fee can be raised). Never
            # evict from the NEWCOMER's own account: dropping its tail
            # to insert a higher sequence would manufacture the exact
            # mid-chain gap eviction is designed to avoid.
            while self._size >= self.max_size:
                if not self._evict_cheaper_than(level, account):
                    self.stats["rejected"] += 1
                    return TER.telINSUF_FEE_P
            if chain is None:
                chain = self._accounts[account] = {}
            expire = self._closed_seq(lm) + self.retention_ledgers
            self._insert(chain, account, seq, tx, level, expire)
            self.stats["queued"] += 1
            return TER.terQUEUED

    def _replace_by_fee(self, chain: dict, seq: int,
                        tx: SerializedTransaction, level: int) -> TER:
        old = chain[seq]
        bump = old.fee_level * (100 + self.retry_fee_pct) // 100
        if level < max(bump, old.fee_level + 1):
            self.stats["rejected"] += 1
            return TER.telINSUF_FEE_P
        account = tx.account
        self._remove(account, seq)  # drops the old entry (heap laziness)
        self._insert(chain if chain else
                     self._accounts.setdefault(account, {}),
                     account, seq, tx, level, old.expire_seq)
        self.stats["replaced"] += 1
        self.stats["queued"] += 1
        return TER.terQUEUED

    def _insert(self, chain: dict, account: bytes, seq: int,
                tx: SerializedTransaction, level: int,
                expire_seq: int) -> None:
        self._order += 1
        entry = _Entry(tx, level, self._order, expire_seq)
        chain[seq] = entry
        self._accounts.setdefault(account, chain)
        self._size += 1
        heapq.heappush(self._heap, (level, entry.order, account, seq))

    def _remove(self, account: bytes, seq: int) -> Optional[_Entry]:
        chain = self._accounts.get(account)
        if chain is None:
            return None
        entry = chain.pop(seq, None)
        if entry is None:
            return None
        if not chain:
            del self._accounts[account]
        self._size -= 1
        return entry  # its heap tuple goes stale; skipped on pop

    def _evict_cheaper_than(self, floor_level: int,
                            newcomer_account: bytes) -> bool:
        """Evict one entry to make room, or return False when nothing
        queued is strictly cheaper than `floor_level`. The cheapest live
        entry picks the victim ACCOUNT, but the eviction takes that
        account's chain TAIL (highest sequence): dropping a mid-chain
        entry would orphan every later sequence behind an unpromotable
        gap (reference: rippled TxQ::erase evicts chain ends for the
        same reason). The newcomer's own account is never the victim —
        evicting its tail to insert a later sequence would create that
        same gap — the newcomer is shed instead (reference: rippled
        rejects in this case too)."""
        while self._heap:
            lvl, order, account, seq = self._heap[0]
            chain = self._accounts.get(account)
            entry = chain.get(seq) if chain else None
            if entry is None or entry.order != order:
                heapq.heappop(self._heap)  # stale
                continue
            if lvl >= floor_level or account == newcomer_account:
                return False
            tail_seq = max(chain)
            victim = self._remove(account, tail_seq)
            # the cheapest entry's heap tuple stays valid unless it WAS
            # the tail; either way stale tuples skip on later pops
            self.stats["evicted"] += 1
            self.tracer.instant("txq.evict", "submit",
                                txid=victim.tx.txid(),
                                fee_level=victim.fee_level)
            self._notify_drop(victim.tx.txid())
            return True
        return False

    def _notify_drop(self, txid: bytes) -> None:
        """A tx left the admission plane without applying (eviction,
        expiry, promote-drop, rejected held absorption): tell LocalTxs
        so networked re-apply stops and a client resubmit starts
        fresh."""
        if self.on_drop is not None:
            try:
                self.on_drop(txid)
            except Exception:  # noqa: BLE001 — observers must not break
                pass           # admission control

    @staticmethod
    def _closed_seq(lm) -> int:
        closed = lm.closed
        return closed.seq if closed is not None else 0

    # -- held-pile absorption (LedgerMaster._open_next) --------------------

    def absorb_held(self, tx: SerializedTransaction, lm,
                    expire_seq: Optional[int] = None) -> TER:
        """Fold a terPRE_SEQ hold (legacy pile / validator path) into the
        queue so holds are fee-ordered and bounded like everything else.
        Caller holds the chain lock."""
        open_ledger = lm.current_ledger()
        level = (
            fee_level(tx.fee.mantissa, open_ledger.base_fee)
            if tx.fee.is_native and not tx.fee.negative else 0
        )
        ter = self._try_queue(tx, level, lm, open_ledger)
        if ter == TER.terQUEUED:
            self.stats["absorbed_held"] += 1
            if expire_seq is not None:
                # preserve the ORIGINAL hold horizon so re-held txs
                # cannot refresh themselves forever
                with self._lock:
                    chain = self._accounts.get(tx.account)
                    entry = chain.get(tx.sequence) if chain else None
                    if entry is not None:
                        entry.expire_seq = min(entry.expire_seq, expire_seq)
        else:
            # the hold is DROPPED (queue full / hopeless): the drop
            # contract applies — LocalTxs must stop the cross-round
            # re-apply or the tx bypasses admission forever
            self._notify_drop(tx.txid())
        return ter

    # -- close integration (LedgerMaster._open_next) -----------------------

    def after_close(self, lm, closed_ledger, apply_ms: float) -> int:
        """The per-close drive: update the capacity model and expire
        aged entries synchronously (cheap), then replenish the new open
        window — promotion in fee order, queue-aware speculation, fee
        feedback — on a deferred job OFF the close path, so the close
        itself stays at its spliced-apply cost (the whole point of the
        admission plane). Falls back to inline replenish when no
        dispatcher is wired (bare LedgerMaster embedders, deterministic
        tests) or the job queue refuses (shutdown). Caller holds the
        chain lock. Returns the promotion count (0 when deferred)."""
        self.metrics.note_close(
            self.open_size(closed_ledger), apply_ms
        )
        self._sweep_expired(closed_ledger.seq)
        self._lm = lm
        if self.spec_dispatch is not None:
            # the job promotes into THIS open window only: if the job
            # queue backs up past the next close (the overload case),
            # a stale job must not stack a second full promotion pass
            # onto a window the newer job already replenished
            target = lm.current_ledger().seq
            with self._lock:
                self._deferred_jobs += 1
            if self.spec_dispatch(lambda: self._deferred_open_work(target)):
                return 0
            with self._lock:
                self._deferred_jobs -= 1
        return self._replenish_open(lm)

    def _promote_and_feed(self, lm) -> int:
        """Promote into the current open window, then feed the
        (post-promotion) escalated requirement back as the queue fee
        component of load_factor, so server_info/fee/pubServer all see
        the admission price and under-payers are priced consistently.
        Caller holds the chain lock."""
        promoted = self._promote(lm)
        if self.fee_track is not None:
            self.fee_track.set_queue_fee(
                self.metrics.required_level(
                    self.open_size(lm.current_ledger())
                )
            )
        return promoted

    def _replenish_open(self, lm) -> int:
        """The inline open-window replenish (no dispatcher wired).
        Caller holds the chain lock."""
        promoted = self._promote_and_feed(lm)
        if self._pending_spec:
            self._drain_deferred_spec()
        return promoted

    def _deferred_open_work(self, target_seq: int) -> None:
        lm = self._lm
        try:
            if lm is not None:
                with lm._lock:
                    cur = lm.current
                    if cur is None or cur.seq != target_seq:
                        return  # window moved on; the newer job owns it
                    self._promote_and_feed(lm)
                self._drain_deferred_spec()
        finally:
            with self._lock:
                self._deferred_jobs -= 1

    def quiesce(self, timeout: float = 5.0) -> bool:
        """Wait until no deferred open-window work is outstanding
        (promotion jobs + pending speculations) — the bench/smoke
        drivers model the inter-close open window with this."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                if self._deferred_jobs == 0 and not self._pending_spec:
                    return True
            time.sleep(0.002)
        return False

    def _promote(self, lm) -> int:
        """Fill the new open ledger from the queue in fee-level order
        (FIFO within a level), per-account lowest sequence first so
        chains stay ordered. Budget = the soft cap."""
        t0 = time.perf_counter()
        target_seq = lm.current_ledger().seq
        with self._lock:
            self._promoted_window = set()
            heads: list[tuple[int, int, bytes, int]] = []
            for account, chain in self._accounts.items():
                s = min(chain)
                e = chain[s]
                heads.append((-e.fee_level, e.order, account, s))
            heapq.heapify(heads)
        # fill UP TO the soft cap: consensus leftovers (networked close)
        # already re-applied into this window count against it, so a
        # close never carries leftovers + a full promotion pass
        budget = max(
            0,
            self.metrics.txns_expected - self.open_size(lm.current_ledger()),
        )
        applied = attempts = 0
        from ..engine.engine import TxParams

        while heads and applied < budget:
            _neg, order, account, seq = heapq.heappop(heads)
            with self._lock:
                chain = self._accounts.get(account)
                entry = chain.get(seq) if chain else None
            if entry is None or entry.order != order:
                continue  # replaced/evicted since the snapshot
            attempts += 1
            ter, did_apply = lm._open_apply(
                entry.tx, TxParams.OPEN_LEDGER | TxParams.RETRY,
                speculate=False,
            )
            if did_apply or ter == TER.tesSUCCESS:
                with self._lock:
                    self._remove(account, seq)
                    self.stats["promoted"] += 1
                    self._promoted_window.add(entry.tx.txid())
                    self._pending_spec.append((target_seq, entry.tx))
                    self._pending_relay.append(entry.tx)
                    nxt = self._head_of(account)
                applied += 1
                if nxt is not None:
                    heapq.heappush(heads, nxt)
            elif ter == TER.terPRE_SEQ:
                # still a future sequence: the whole chain stays queued
                continue
            elif ter.is_ter or ter == TER.telINSUF_FEE_P:
                # retriable next ledger (expiry bounds the wait)
                continue
            else:
                # tem/tef/tec: never going to land from the queue
                with self._lock:
                    self._remove(account, seq)
                    self.stats["promote_dropped"] += 1
                    self._notify_drop(entry.tx.txid())
                    nxt = self._head_of(account)
                if nxt is not None:
                    heapq.heappush(heads, nxt)
        self.tracer.complete(
            "txq.promote", "close", t0, time.perf_counter(),
            promoted=applied, attempts=attempts, queue=len(self),
        )
        return applied

    def _head_of(self, account: bytes) -> Optional[tuple]:
        chain = self._accounts.get(account)
        if not chain:
            return None
        s = min(chain)
        e = chain[s]
        return (-e.fee_level, e.order, account, s)

    def _sweep_expired(self, closed_seq: int) -> None:
        with self._lock:
            for account in list(self._accounts):
                chain = self._accounts[account]
                for seq in [s for s, e in chain.items()
                            if e.expire_seq < closed_seq]:
                    entry = self._remove(account, seq)
                    self.stats["expired"] += 1
                    if entry is not None:
                        self._notify_drop(entry.tx.txid())

    # -- deferred queue-aware speculation ----------------------------------

    def _drain_deferred_spec(self) -> None:
        """Run the promoted txs' delta-replay speculation in promotion
        order, in small chain-lock batches so submissions interleave.
        Any tx whose open window already moved on is skipped — its close
        simply falls back to the serial apply (counted)."""
        lm = self._lm
        if lm is None:
            return
        ex = getattr(lm, "spec_executor", None)
        # with the parallel executor active, _speculate_open is an O(1)
        # dispatch instead of a full close-mode execution, so a much
        # larger batch fits under one chain-lock hold and the worker
        # pool fills in one burst
        step = 128 if ex is not None and ex.active else 16
        while True:
            with self._lock:
                batch = self._pending_spec[:step]
                del self._pending_spec[:step]
            if not batch:
                return
            with lm._lock:
                cur = lm.current
                for target_seq, tx in batch:
                    if cur is None or cur.seq != target_seq:
                        continue
                    lm._speculate_open(cur, tx, origin="promote")
                    self.stats["deferred_specs"] += 1

    def note_close_classes(self, classes: dict[bytes, str]) -> None:
        """Per-close splice/fallback outcome for the txs THIS queue
        promoted into the just-closed window — the honesty counter for
        the queue-aware-speculation claim (get_counts.txq)."""
        with self._lock:
            window = self._promoted_window
            if not window:
                return
            for txid, cls in classes.items():
                if txid in window:
                    if cls == "spliced":
                        self.stats["promote_spliced"] += 1
                    else:
                        self.stats["promote_fallback"] += 1
            self._promoted_window = set()

    def drain_relay(self) -> list[SerializedTransaction]:
        """Promoted txs whose relay was deferred past the chain lock
        (NetworkOPs.publish_closed_ledger relays them)."""
        with self._lock:
            out = self._pending_relay
            self._pending_relay = []
        return out

    # -- RPC surfaces ------------------------------------------------------

    def account_json(self, account: bytes) -> dict:
        """`account_info` queue block (reference: queue_data)."""
        with self._lock:
            chain = self._accounts.get(account)
            if not chain:
                return {"txn_count": 0}
            seqs = sorted(chain)
            return {
                "txn_count": len(chain),
                "lowest_sequence": seqs[0],
                "highest_sequence": seqs[-1],
                "max_spend_drops_total": str(sum(
                    chain[s].tx.fee.mantissa for s in seqs
                    if chain[s].tx.fee.is_native
                )),
                "transactions": [
                    {
                        "seq": s,
                        "fee_level": str(chain[s].fee_level),
                        "hash": chain[s].tx.txid().hex().upper(),
                    }
                    for s in seqs
                ],
            }

    def fee_json(self, ledger) -> dict:
        """The `fee` RPC body (reference: handlers/Fee1.cpp shape)."""
        with self._lock:
            open_count = self.open_size(ledger)
            required = self.metrics.required_level(open_count)
            base = ledger.base_fee
            return {
                "current_ledger_size": str(open_count),
                "current_queue_size": str(self._size),
                "expected_ledger_size": str(self.metrics.txns_expected),
                "max_queue_size": str(self.max_size),
                "ledger_current_index": ledger.seq,
                "levels": {
                    "reference_level": str(NORMAL_LEVEL),
                    "minimum_level": str(NORMAL_LEVEL),
                    "open_ledger_level": str(required),
                },
                "drops": {
                    "base_fee": str(base),
                    "minimum_fee": str(base),
                    "open_ledger_fee": str(level_to_drops(required, base)),
                },
            }

    def get_json(self) -> dict:
        with self._lock:
            out = {
                "enabled": self.enabled,
                "size": self._size,
                "max_size": self.max_size,
                "accounts": len(self._accounts),
                "pending_spec": len(self._pending_spec),
                **self.stats,
            }
        out["metrics"] = self.metrics.get_json()
        return out


def _account_index(account_id: bytes) -> bytes:
    from ..state import indexes

    return indexes.account_root_index(account_id)
