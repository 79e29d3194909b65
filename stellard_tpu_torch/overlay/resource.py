"""Resource consumption accounting — per-endpoint DoS defense.

Role parity with the reference's Resource::Manager / Consumer / Charge
plane (src/ripple/resource/api/Consumer.h:63,
impl/Logic.h:422-509, impl/Fees.cpp, impl/Tuning.h): every abusive or
costly action by a remote endpoint charges a fee against an exponentially
decaying balance; crossing `WARNING_THRESHOLD` flags the endpoint,
crossing `DROP_THRESHOLD` tells the overlay to disconnect (and keep
rejecting reconnects until the balance decays back under the line).

The decay here is an explicit exponential-moving-average over elapsed
seconds rather than the reference's power-of-two DecayingSample bucket
trick — same observable behavior (halving roughly every
``DECAY_WINDOW_SECONDS``), simpler math for a host runtime that is not
counting cycles.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = [
    "Charge",
    "Disposition",
    "ResourceManager",
    "FEE_INVALID_REQUEST",
    "FEE_REQUEST_NO_REPLY",
    "FEE_INVALID_SIGNATURE",
    "FEE_UNWANTED_DATA",
    "FEE_BAD_DATA",
    "FEE_GARBAGE_SEGMENT",
    "FEE_INVALID_RPC",
    "FEE_REFERENCE_RPC",
    "FEE_EXCEPTION_RPC",
    "FEE_LIGHT_RPC",
    "FEE_LOW_BURDEN_RPC",
    "FEE_MEDIUM_BURDEN_RPC",
    "FEE_HIGH_BURDEN_RPC",
    "FEE_PATH_FIND",
    "FEE_PATH_FIND_UPDATE",
    "FEE_NEW_VALID_TX",
    "FEE_SATISFIED_REQUEST",
    "WARNING_THRESHOLD",
    "DROP_THRESHOLD",
]


@dataclass(frozen=True)
class Charge:
    cost: int
    label: str

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return f"{self.label}({self.cost})"


# Fee schedule (same costs as the reference's Fees.cpp so operator
# intuition transfers).
FEE_INVALID_REQUEST = Charge(10, "malformed request")
FEE_REQUEST_NO_REPLY = Charge(1, "unsatisfiable request")
FEE_INVALID_SIGNATURE = Charge(100, "invalid signature")
FEE_UNWANTED_DATA = Charge(5, "useless data")
FEE_BAD_DATA = Charge(20, "invalid data")
FEE_INVALID_RPC = Charge(10, "malformed RPC")
FEE_REFERENCE_RPC = Charge(2, "reference RPC")
FEE_EXCEPTION_RPC = Charge(10, "exceptioned RPC")
FEE_LIGHT_RPC = Charge(5, "light RPC")
FEE_LOW_BURDEN_RPC = Charge(20, "low RPC")
FEE_MEDIUM_BURDEN_RPC = Charge(40, "medium RPC")
FEE_HIGH_BURDEN_RPC = Charge(300, "heavy RPC")
# the pathfinding surfaces get their own class ABOVE heavy RPC: one
# path_find is a full candidate search + trial execution, the reference's
# notorious validator-killer — two back-to-back requests put a
# non-admin endpoint over the WARNING line
FEE_PATH_FIND = Charge(400, "path find")
FEE_PATH_FIND_UPDATE = Charge(100, "path update")
FEE_NEW_VALID_TX = Charge(10, "valid tx")
FEE_SATISFIED_REQUEST = Charge(10, "needed data")
# FEE_BAD_DATA-class condemnation for a peer that served a garbage
# segment transfer (SegmentCatchup's per-peer fallback): one condemned
# transfer lands the endpoint PAST the warning line — relay/catch-up
# demotion — and a second pushes it over the DROP line, so the catch-up
# scorer and the overlay's drop gate act on ONE unified balance
FEE_GARBAGE_SEGMENT = Charge(800, "garbage segment transfer")

WARNING_THRESHOLD = 500
DROP_THRESHOLD = 1500
DECAY_WINDOW_SECONDS = 32.0
SECONDS_UNTIL_EXPIRATION = 300.0


class Disposition:
    OK = "ok"
    WARN = "warn"
    DROP = "drop"


class _Entry:
    __slots__ = ("balance", "stamp", "warned")

    def __init__(self, now: float):
        self.balance = 0.0
        self.stamp = now
        self.warned = False

    def decayed(self, now: float) -> float:
        dt = max(0.0, now - self.stamp)
        if dt:
            self.balance *= math.exp(-dt * (math.log(2.0) / DECAY_WINDOW_SECONDS))
            self.stamp = now
        return self.balance


class ResourceManager:
    """Tracks one decaying charge balance per endpoint key.

    ``key_fn`` maps a (host, port) remote address to the accounting key —
    by default the host only, matching the reference's by-IP inbound
    accounting; tests on loopback can inject host:port granularity.
    """

    def __init__(
        self,
        key_fn: Optional[Callable[[tuple], str]] = None,
        clock: Optional[Callable[[], float]] = None,
        admin: Optional[set[str]] = None,
    ):
        self._key_fn = key_fn or (lambda addr: addr[0])
        self._clock = clock or time.monotonic
        self._entries: dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self.admin = admin or set()
        self.dropped = 0      # charges that crossed the DROP line
        self.charged = 0
        self.warned = 0       # charges that crossed the WARN line
        self.refused = 0      # admissions refused (note_refused)
        self.throttled = 0    # inbound messages shed at WARN (note_throttled)
        self.disconnects = 0  # sessions torn down on DROP (note_disconnect)

    def key(self, addr: tuple) -> str:
        return self._key_fn(addr)

    def charge(self, addr: tuple, fee: Charge) -> str:
        """Charge the endpoint; returns a Disposition."""
        k = self.key(addr)
        if k in self.admin:
            return Disposition.OK
        now = self._clock()
        with self._lock:
            e = self._entries.get(k)
            if e is None:
                e = self._entries[k] = _Entry(now)
            bal = e.decayed(now) + fee.cost
            e.balance = bal
            self.charged += 1
            if bal >= DROP_THRESHOLD:
                self.dropped += 1
                return Disposition.DROP
            if bal >= WARNING_THRESHOLD:
                if not e.warned:  # count CROSSINGS, not charges-at-WARN
                    e.warned = True
                    self.warned += 1
                return Disposition.WARN
            e.warned = False  # decayed under the line: re-arm the crossing
            return Disposition.OK

    def balance(self, addr: tuple) -> float:
        with self._lock:
            e = self._entries.get(self.key(addr))
            return e.decayed(self._clock()) if e else 0.0

    def status(self, addr: tuple) -> str:
        """Current Disposition from the decayed balance, charging nothing."""
        if self.key(addr) in self.admin:
            return Disposition.OK
        bal = self.balance(addr)
        if bal >= DROP_THRESHOLD:
            return Disposition.DROP
        if bal >= WARNING_THRESHOLD:
            return Disposition.WARN
        return Disposition.OK

    def is_throttled(self, addr: tuple) -> bool:
        """WARN-or-worse: the overlay sheds this endpoint's non-essential
        inbound (tx gossip, endpoint gossip, bulk serving) until the
        balance decays back under the warning line."""
        return (
            self.key(addr) not in self.admin
            and self.balance(addr) >= WARNING_THRESHOLD
        )

    def should_admit(self, addr: tuple) -> bool:
        """Admission gate for new inbound connections: a dropped endpoint
        stays rejected until its balance decays under the drop line."""
        return (
            self.key(addr) in self.admin
            or self.balance(addr) < DROP_THRESHOLD
        )

    def note_refused(self, addr: tuple) -> None:
        self.refused += 1

    def note_throttled(self, n: int = 1) -> None:
        self.throttled += n

    def note_disconnect(self) -> None:
        self.disconnects += 1

    def aggregate_pressure(self) -> float:
        """Network-wide abuse pressure: the sum of all decayed balances
        relative to the warning threshold. ~0 on a healthy net; >= 1.0
        means the combined charge inflow equals one endpoint pinned at
        WARN. The overlay maps this onto LoadFeeTrack so local fees rise
        while the whole peer set misbehaves (reference: Logic::periodic
        feeding the load fee from importers)."""
        now = self._clock()
        with self._lock:
            total = sum(e.decayed(now) for e in self._entries.values())
        return total / float(WARNING_THRESHOLD)

    def sweep(self) -> None:
        """Expire idle entries (reference secondsUntilExpiration)."""
        now = self._clock()
        with self._lock:
            dead = [
                k
                for k, e in self._entries.items()
                if now - e.stamp > SECONDS_UNTIL_EXPIRATION or e.decayed(now) < 1.0
            ]
            for k in dead:
                del self._entries[k]

    def get_json(self) -> dict:
        now = self._clock()
        with self._lock:
            # bound the reported table: at 1000-peer fan-in the full
            # entry dict would dominate every get_counts payload
            items = sorted(
                ((k, e.decayed(now)) for k, e in self._entries.items()),
                key=lambda kv: -kv[1],
            )
            return {
                "entries": {k: round(bal, 1) for k, bal in items[:64]},
                "entry_count": len(items),
                "charged": self.charged,
                "warned": self.warned,
                "dropped": self.dropped,
                "refused": self.refused,
                "throttled": self.throttled,
                "disconnects": self.disconnects,
            }
