"""RPCSub: HTTP-callback subscriptions (reference:
src/ripple_net/rpc/RPCSub.cpp + NetworkOPs' mRpcSubMap).

`subscribe` with a `url` (admin-only) registers a server-side pusher:
every pub/sub event the subscription matches is POSTed to the client's
HTTP listener as a JSON-RPC request `{"method": "event", "params":
[event]}`, with a per-subscription monotonically increasing `seq`
stamped into the event (reference sendThread). Events queue up to 32
deep; on overflow the most recently queued event is dropped (the
reference's "drop the previous event" rule), never the oldest — a slow
listener sees a gap, not a stale stream. One daemon sender drains the
queue.

Delivery failures RETRY with bounded exponential backoff + jitter (the
reference's RPCSub keeps exactly this retry deque; the first cut here
dropped silently on the first error): an event re-enters the queue head
and waits ``backoff_base * 2^attempt`` (jittered ±25%, capped) before
the next POST. Past ``max_retries`` the event is dropped and counted;
``evict_failures`` consecutive dropped events fire ``on_dead`` so the
subscription manager can prune a listener that is gone for good.
"""

from __future__ import annotations

import base64
import json
import logging
import random
import threading
import time
import urllib.request
from collections import deque
from typing import Callable, Optional
from urllib.parse import urlparse

from .infosub import InfoSub

__all__ = ["RpcSub"]

log = logging.getLogger("stellard.rpcsub")

EVENT_QUEUE_MAX = 32  # reference RPCSub eventQueueMax


class RpcSub(InfoSub):
    """An InfoSub whose sink is a remote JSON-RPC listener."""

    # consecutive retry-exhausted drops before on_dead fires (the
    # slow-consumer eviction threshold for the HTTP-push side)
    EVICT_FAILURES = 4

    def __init__(self, url: str, username: str = "", password: str = "",
                 max_retries: int = 5, backoff_base: float = 0.25,
                 backoff_max: float = 10.0):
        parsed = urlparse(url)
        if parsed.scheme not in ("http", "https"):
            raise ValueError("only http and https are supported")
        if not parsed.hostname:
            raise ValueError("url has no host")
        self.url = url
        self.username = username
        self.password = password
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self._q: deque = deque()  # entries: (event, attempts_so_far)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._worker: Optional[threading.Thread] = None
        self._seq = 1
        self._closed = False
        self._rng = random.Random()
        self._drop_run = 0  # consecutive retry-exhausted drops
        self.stats = {"sent": 0, "retries": 0, "failures": 0, "dropped": 0}
        # pruning hook (SubscriptionManager wires _evict here): fired
        # once when EVICT_FAILURES consecutive events exhaust retries
        self.on_dead: Optional[Callable[[], None]] = None
        super().__init__(send=self._enqueue)

    def set_credentials(self, username: str, password: str) -> None:
        with self._lock:
            self.username = username
            self.password = password

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._q.clear()
            self._cv.notify_all()

    # -- sink --------------------------------------------------------------

    def _enqueue(self, obj: dict) -> None:
        with self._lock:
            if self._closed:
                return
            if len(self._q) >= EVENT_QUEUE_MAX:
                # reference: drop the PREVIOUS (most recently queued)
                # event — older queued events keep their slot
                self._q.pop()
                log.warning("rpcsub %s: queue full, dropping an event",
                            self.url)
            ev = dict(obj)
            ev["seq"] = self._seq
            self._seq += 1
            self._q.append((ev, 0))
            self._cv.notify()
            if self._worker is not None and self._worker.is_alive():
                return
            # ONE persistent sender per subscription (steady stream
            # traffic must not churn a thread per event)
            self._worker = threading.Thread(
                target=self._send_loop, name="rpcsub-send", daemon=True
            )
            self._worker.start()

    # -- delivery ----------------------------------------------------------

    def _post(self, ev: dict, user: str, pw: str) -> None:
        body = json.dumps({"method": "event", "params": [ev]}).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"},
        )
        if user or pw:
            tok = base64.b64encode(f"{user}:{pw}".encode()).decode()
            req.add_header("Authorization", f"Basic {tok}")
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()

    def _backoff(self, attempt: int) -> float:
        """Exponential backoff with ±25% jitter, capped — a fleet of
        pushers retrying a flapping listener must decorrelate."""
        delay = min(self.backoff_max, self.backoff_base * (2 ** attempt))
        return delay * (0.75 + 0.5 * self._rng.random())

    def _send_loop(self) -> None:
        dead = False
        while True:
            with self._lock:
                while not self._q and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                ev, attempts = self._q.popleft()
                user, pw = self.username, self.password
            try:
                self._post(ev, user, pw)
            except Exception as exc:  # noqa: BLE001 — retry with backoff
                self.stats["failures"] += 1
                attempts += 1
                if attempts <= self.max_retries:
                    self.stats["retries"] += 1
                    delay = self._backoff(attempts - 1)
                    log.info("rpcsub %s: delivery failed (%s) — retry "
                             "%d/%d in %.2fs", self.url, exc, attempts,
                             self.max_retries, delay)
                    with self._lock:
                        if self._closed:
                            return
                        # head of the queue: per-subscription event order
                        # is preserved across the retry
                        self._q.appendleft((ev, attempts))
                        # interruptible sleep: close() must not wait out
                        # a 10s backoff, but an enqueue notification must
                        # not shortcut it either (the backoff is the
                        # whole point when the listener is down)
                        deadline = time.monotonic() + delay
                        while not self._closed:
                            left = deadline - time.monotonic()
                            if left <= 0:
                                break
                            self._cv.wait(timeout=left)
                        if self._closed:
                            return
                else:
                    self.stats["dropped"] += 1
                    self._drop_run += 1
                    log.warning("rpcsub %s: event dropped after %d "
                                "attempts: %s", self.url, attempts, exc)
                    if (self._drop_run >= self.EVICT_FAILURES
                            and self.on_dead is not None and not dead):
                        dead = True  # fire once; the manager prunes us
                        try:
                            self.on_dead()
                        except Exception:  # noqa: BLE001 — pruning must
                            pass           # not kill the sender thread
                continue
            self.stats["sent"] += 1
            self._drop_run = 0
            dead = False
