"""PathPlane: the liquidity read plane.

One object owns the three legs that turn `paths/` from an on-demand
library into production serving:

* the incremental per-close book index (`LiveBookIndex`) — advanced
  once per validated close from the close's own write set, shared by
  the subscription publisher and the RPC door;
* per-subscription staleness + bounded per-close update budget — the
  sharded fanout re-ranks the stalest subscriptions first and SHEDS
  (rather than queues) the rest, so a path-spam client cannot stall
  the close (SEDA stance; charged through the overlay resource plane);
* the device evaluator (`crypto.backend.PathQualityEvaluator`) —
  oversized candidate sets are flattened to Q16.16 rate matrices and
  pre-ranked by K4 (`ops.pathq.path_quality`) on the card, or by the
  host arm, before the expensive trial executions.

Everything is observable under `paths.*` via ``get_json``.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..overlay.resource import FEE_PATH_FIND_UPDATE
from .orderbook import LiveBookIndex, OrderBookDB

__all__ = ["PathPlane"]

# keep this floor above every unit-test-sized candidate set: pre-rank
# pruning must be a no-op until a search is genuinely oversized, so the
# device plane can never change small-search results
DEFAULT_PRUNE_FLOOR = 64
DEFAULT_PRUNE_KEEP = 32
DEFAULT_UPDATE_BUDGET = 256


class PathPlane:
    def __init__(
        self,
        *,
        incremental: bool = True,
        evaluator=None,
        device_prune: bool = True,
        prune_floor: int = DEFAULT_PRUNE_FLOOR,
        prune_keep: int = DEFAULT_PRUNE_KEEP,
        max_updates_per_close: int = DEFAULT_UPDATE_BUDGET,
        resources=None,
        update_charge=None,
    ):
        self.index = LiveBookIndex(incremental=incremental)
        self.evaluator = evaluator
        self.device_prune = bool(device_prune)
        self.prune_floor = max(1, int(prune_floor))
        self.prune_keep = max(1, int(prune_keep))
        self.max_updates_per_close = max(1, int(max_updates_per_close))
        self.resources = resources
        self.update_charge = (FEE_PATH_FIND_UPDATE if update_charge is None
                              else update_charge)
        self._lock = threading.Lock()
        # (sub id, request id) -> last seq this subscription was ranked at
        self._last_ranked: dict[tuple, int] = {}
        # staleness-in-ledgers histogram (small ints; p99 from the dict)
        self._stale_hist: dict[int, int] = {}
        self._budget_left = self.max_updates_per_close
        # `paths.*` counters
        self.closes = 0
        self.reranked = 0
        self.shed_budget = 0
        self.shed_throttled = 0
        self.pruned_candidates = 0
        self.prune_batches = 0
        self.staleness_max = 0

    # -- book index -------------------------------------------------------

    def note_close(self, ledger) -> None:
        """Per-validated-close hook (ops.on_ledger_closed): advance the
        incremental index so continuity never breaks between closes."""
        self.index.advance(ledger)

    def books_for(self, ledger) -> OrderBookDB:
        return self.index.advance(ledger)

    def books_if_current(self, ledger) -> Optional[OrderBookDB]:
        return self.index.books_if_current(ledger)

    # -- device pre-ranking ----------------------------------------------

    def make_pre_rank(self, ledger):
        """A find_paths pre_rank hook, or None when device pruning is
        off. Reorders candidates best-estimated-first and prunes ONLY
        when the set exceeds the floor (small searches byte-unchanged —
        find_paths re-sorts trial results anyway, so pure reordering
        can never alter output). Empty (default) paths always survive:
        they anchor the alternative's source_amount quote."""
        ev = self.evaluator
        if ev is None or not self.device_prune:
            return None

        def pre_rank(les, candidates):
            if len(candidates) <= self.prune_floor:
                return candidates
            import numpy as np

            from .quality import build_rate_matrix

            rates = build_rate_matrix(ledger, candidates)
            composite = ev.evaluate(rates)
            order = np.argsort(composite, kind="stable")
            keep = set(int(i) for i in order[: self.prune_keep])
            keep |= {i for i, (path, _a) in enumerate(candidates)
                     if not path}
            out = [c for i, c in enumerate(candidates) if i in keep]
            with self._lock:
                self.prune_batches += 1
                self.pruned_candidates += len(candidates) - len(out)
            return out

        return pre_rank

    # -- per-close update scheduling --------------------------------------

    def begin_close(self, seq: int) -> None:
        with self._lock:
            self.closes += 1
            self._budget_left = self.max_updates_per_close

    def note_created(self, key: tuple, seq: int) -> None:
        """A subscription was created and answered at `seq`."""
        with self._lock:
            self._last_ranked.setdefault(key, seq)

    def order_keys(self, keys, seq: int):
        """Stalest-first update order (ties: stable by key) — under a
        budget, the subscriptions that waited longest go first, which
        bounds worst-case staleness at budget ratio × reranking period."""
        with self._lock:
            last = self._last_ranked
            return sorted(keys, key=lambda k: (last.get(k, -1), k))

    def claim_update(self, key: tuple, seq: int, endpoint=None) -> bool:
        """One subscription asks to re-rank at `seq`. False = shed this
        close (budget exhausted, or the endpoint is throttled by the
        resource plane); its staleness keeps growing until a later
        close picks it (stalest-first)."""
        rm = self.resources
        if rm is not None and endpoint is not None:
            if rm.is_throttled(endpoint):
                with self._lock:
                    self.shed_throttled += 1
                return False
        with self._lock:
            if self._budget_left <= 0:
                self.shed_budget += 1
                return False
            self._budget_left -= 1
        if rm is not None and endpoint is not None:
            rm.charge(endpoint, self.update_charge)
        return True

    def note_ranked(self, key: tuple, seq: int) -> None:
        with self._lock:
            prev = self._last_ranked.get(key)
            if prev is not None:
                stale = max(0, seq - prev)
                self._stale_hist[stale] = self._stale_hist.get(stale, 0) + 1
                if stale > self.staleness_max:
                    self.staleness_max = stale
            self._last_ranked[key] = seq
            self.reranked += 1

    def sync_live(self, keys) -> None:
        """Drop staleness state for closed subscriptions (the publisher
        passes the live key set each close)."""
        live = set(keys)
        with self._lock:
            for k in [k for k in self._last_ranked if k not in live]:
                del self._last_ranked[k]

    # -- observability ----------------------------------------------------

    def staleness_quantile(self, q: float) -> int:
        with self._lock:
            total = sum(self._stale_hist.values())
            if not total:
                return 0
            want = q * total
            seen = 0
            for stale in sorted(self._stale_hist):
                seen += self._stale_hist[stale]
                if seen >= want:
                    return stale
            return max(self._stale_hist)

    def get_json(self) -> dict:
        with self._lock:
            out = {
                "subs": len(self._last_ranked),
                "closes": self.closes,
                "reranked": self.reranked,
                "shed_budget": self.shed_budget,
                "shed_throttled": self.shed_throttled,
                "max_updates_per_close": self.max_updates_per_close,
                "staleness_max": self.staleness_max,
                "pruned_candidates": self.pruned_candidates,
                "prune_batches": self.prune_batches,
                "device_prune": self.device_prune,
                "prune_floor": self.prune_floor,
                "prune_keep": self.prune_keep,
            }
        out["staleness_p99"] = self.staleness_quantile(0.99)
        out["index"] = self.index.counters()
        if self.evaluator is not None:
            out["evaluator"] = self.evaluator.get_json()
        return out
