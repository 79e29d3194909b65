"""Load-scaled fees + the load/deadlock watchdog.

Role parity with the reference's three-piece load plane:
- LoadFeeTrack (src/ripple_core/functional/LoadFeeTrack.h:51,
  LoadFeeTrackImp.cpp): a fee multiplier in 1/256 units that rises while
  the node is overloaded and decays back to normal, applied to the
  open-ledger required fee (telINSUF_FEE_P when a tx pays less);
- LoadManager (src/ripple_app/main/LoadManager.cpp:81-223):
  a watchdog thread that samples the job queue each second, raising or
  lowering the local fee, plus the deadlock canary — if the heartbeat
  fails to reset it for ``deadlock_timeout`` seconds the node is wedged
  and ``on_deadlock`` fires (the reference aborts after 500s);
- the peer-transaction backlog shed (reference PeerImp.cpp:64-66): relay
  transaction intake is dropped outright while more than
  ``TX_BACKLOG_SHED`` jtTRANSACTION jobs are queued.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["LoadFeeTrack", "LoadManager", "TX_BACKLOG_SHED"]

NORMAL_FEE = 256  # lftNormalFee: multiplier denominator ("no escalation")
MAX_FEE = 256 * 1_000_000  # safety ceiling on escalation
TX_BACKLOG_SHED = 100  # reference: drop peer txs at >100 queued jobs


class LoadFeeTrack:
    """Local + remote load-fee multipliers, 1/256 units.

    raise/lower follow the reference's quarter-step dynamics: each raise
    adds ~25%, each lower removes ~25% of the distance toward normal, so
    sustained overload escalates geometrically and recovery is smooth.
    """

    REMOTE_TTL = 30.0  # a cluster report is stale after this many seconds

    def __init__(self):
        self._lock = threading.Lock()
        self._local = NORMAL_FEE
        # admission-queue component ([txq]): the escalated open-ledger
        # requirement fed back by TxQ.after_close — folded into
        # load_factor so server_info / the `server` stream / fee RPC
        # all see the admission price, but EXCLUDED from network_floor
        # (it is local open-ledger state other nodes do not share)
        self._queue = NORMAL_FEE
        # overlay abuse-pressure component: the resource plane's
        # aggregate peer pressure mapped onto the fee scale
        # (set_network_pressure). Included in network_floor — it is
        # genuine local load, exactly like the job-queue component —
        # so relay gating and payFee both see it
        self._overlay = NORMAL_FEE
        # source -> (fee, report_time, expiry): per-reporter so one
        # healthy cluster member cannot overwrite another's elevated
        # report (reference keeps per-node ClusterNodeStatus entries,
        # each carrying the ORIGINAL reportTime so receivers keep only
        # the newest report and stale relays age out)
        self._remote: dict[bytes, tuple[int, int, float]] = {}
        self.raise_count = 0
        # change hooks (the `server` stream publishes serverStatus on
        # load-factor movement — reference: NetworkOPs::pubServer)
        self.on_change: list = []

    def _fire_change(self) -> None:
        for cb in list(self.on_change):
            try:
                cb()
            except Exception:  # noqa: BLE001 — observers must not break fee tracking
                pass

    def raise_local_fee(self) -> None:
        with self._lock:
            before = self._local
            self._local = min(MAX_FEE, self._local + max(1, self._local // 4))
            self.raise_count += 1
            changed = self._local != before
        if changed:
            self._fire_change()

    def lower_local_fee(self) -> None:
        changed = False
        with self._lock:
            if self._local > NORMAL_FEE:
                before = self._local
                self._local = max(NORMAL_FEE, self._local - max(1, self._local // 4))
                changed = self._local != before
        if changed:
            self._fire_change()

    def set_remote_fee(
        self, fee: int, source: bytes = b"", report_time: int = 0
    ) -> None:
        """From cluster/peer load reports (sfLoadFee in validations),
        keyed by reporter. Reports expire: a peer that stops reporting
        (or whose load subsides) must not ratchet our fee up forever.

        A report that is not NEWER (by the reporter's own report_time)
        than the stored one is dropped, so relayed copies of an entry we
        already hold can neither refresh its TTL nor overwrite a fresher
        direct report — a crashed member's last report ages out
        cluster-wide after REMOTE_TTL even while members keep relaying
        it."""
        with self._lock:
            prev = self._remote.get(source)
            # drop unless strictly newer; a report with NO timing info
            # (report_time 0, e.g. a malformed/legacy wire entry) may
            # never displace or refresh a timestamped one, but two
            # untimestamped direct reports keep the old replace behavior
            if (
                prev is not None
                and max(prev[1], report_time) > 0
                and prev[1] >= report_time
            ):
                return
            self._remote[source] = (
                max(NORMAL_FEE, min(MAX_FEE, int(fee))),
                int(report_time),
                time.monotonic() + self.REMOTE_TTL,
            )

    @property
    def local_fee(self) -> int:
        """Our OWN load fee — what cluster reports must carry (sending
        the max(local, remote) would echo a peer's fee back and ratchet
        the whole cluster permanently)."""
        with self._lock:
            return self._local

    def remote_reports(self) -> list[tuple[bytes, int, int]]:
        """Unexpired (source, fee, report_time) cluster reports — relayed
        onward in TMCluster so every member learns every member's load
        (reference: each ClusterNodeStatus entry carries its ORIGINAL
        reporter AND reportTime, so relaying cannot ratchet: receivers
        key by reporter and keep only the newest report)."""
        now = time.monotonic()
        with self._lock:
            return [
                (src, fee, rtime)
                for src, (fee, rtime, expiry) in self._remote.items()
                if expiry > now and src
            ]

    def _live_remote(self) -> int:
        now = time.monotonic()
        best = NORMAL_FEE
        for source in list(self._remote):
            fee, _rtime, expiry = self._remote[source]
            if now >= expiry:
                del self._remote[source]
            else:
                best = max(best, fee)
        return best

    def set_queue_fee(self, fee: int) -> None:
        """Queue-pressure feedback from the admission plane (TxQ): the
        current escalated open-ledger fee level, 1/256 units."""
        fee = max(NORMAL_FEE, min(MAX_FEE, int(fee)))
        with self._lock:
            changed = fee != self._queue
            self._queue = fee
        if changed:
            self._fire_change()

    @property
    def queue_fee(self) -> int:
        with self._lock:
            return self._queue

    def set_network_pressure(self, fee: int) -> None:
        """Abuse-pressure feedback from the overlay's resource plane:
        the aggregate peer charge pressure expressed on the 1/256 fee
        scale (NORMAL_FEE = no abuse). Rises while the peer set as a
        whole is paying charges, decays back with the balances."""
        fee = max(NORMAL_FEE, min(MAX_FEE, int(fee)))
        with self._lock:
            changed = fee != self._overlay
            self._overlay = fee
        if changed:
            self._fire_change()

    @property
    def overlay_fee(self) -> int:
        with self._lock:
            return self._overlay

    @property
    def network_floor(self) -> int:
        """The fee floor peers would apply (local + remote + overlay
        abuse pressure — never our queue escalation): the relay gate
        for queued txs."""
        with self._lock:
            return max(self._local, self._live_remote(), self._overlay)

    @property
    def load_factor(self) -> int:
        with self._lock:
            return max(
                self._local, self._live_remote(), self._queue, self._overlay
            )

    @property
    def is_loaded(self) -> bool:
        return self.load_factor > NORMAL_FEE

    def get_json(self) -> dict:
        with self._lock:
            remote = self._live_remote()
            return {
                "load_factor": max(
                    self._local, remote, self._queue, self._overlay
                ),
                "load_base": NORMAL_FEE,
                "local_fee": self._local,
                "remote_fee": remote,
                "queue_fee": self._queue,
                "overlay_fee": self._overlay,
            }


class LoadManager:
    """Watchdog thread: job-queue load → fee escalation; deadlock canary.

    The heartbeat (NetworkOPs timer / Node.run loop) must call
    ``reset_deadlock_detector()`` regularly; if it stops for
    ``deadlock_timeout`` seconds, ``on_deadlock`` fires once (reference
    LoadManager.cpp:81-204 aborts the process; embedders decide here).
    """

    def __init__(
        self,
        job_queue,
        fee_track: LoadFeeTrack,
        clock: Optional[Callable[[], float]] = None,
        interval: float = 1.0,
        deadlock_timeout: float = 500.0,
        on_deadlock: Optional[Callable[[], None]] = None,
    ):
        self.jq = job_queue
        self.fee_track = fee_track
        self.clock = clock or time.monotonic
        self.interval = interval
        self.deadlock_timeout = deadlock_timeout
        self.on_deadlock = on_deadlock
        self._armed = False
        self._canary = self.clock()
        self._deadlock_fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- deadlock canary --------------------------------------------------

    def reset_deadlock_detector(self) -> None:
        """Called from the heartbeat (reference: resetDeadlockDetector)."""
        self._canary = self.clock()

    def arm(self) -> None:
        """Start watching for deadlock (reference: activateDeadlockDetector,
        armed only once the application is fully up)."""
        self._canary = self.clock()
        self._armed = True

    # -- periodic work ----------------------------------------------------

    def tick(self) -> None:
        """One watchdog pass — called by the background thread, or directly
        by tests with a fake clock."""
        now = self.clock()
        if (
            self._armed
            and not self._deadlock_fired
            and now - self._canary > self.deadlock_timeout
        ):
            self._deadlock_fired = True
            if self.on_deadlock is not None:
                self.on_deadlock()
        if self.jq is not None and self.jq.is_overloaded():
            self.fee_track.raise_local_fee()
        else:
            self.fee_track.lower_local_fee()

    def start(self) -> "LoadManager":
        self._thread = threading.Thread(
            target=self._run, name="load-manager", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.tick()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def get_json(self) -> dict:
        return {
            "armed": self._armed,
            "deadlock_fired": self._deadlock_fired,
            "seconds_since_heartbeat": round(self.clock() - self._canary, 1),
            **self.fee_track.get_json(),
        }
