"""PeerFinder: endpoint discovery, ranking, and connect policy.

Role parity with the reference's PeerFinder subsystem
(src/ripple/peerfinder/impl/{PeerSlotLogic.h,Bootcache.h,
Livecache.h,Tuning.h}): the overlay should grow from one seed address to
a full mesh without manual configuration.

Three coordinated pieces:

- **Bootcache** — long-lived store of endpoints that ever accepted a
  connection, ranked by "valence" (net connect successes, clamped).
  Persisted as JSON lines under the node's data dir (the reference uses
  a sqlite table; the dataset is tiny — hundreds of rows — so a flat
  file keeps the dependency surface down and loads in one read).
- **Livecache** — endpoints heard via ENDPOINTS gossip recently, with a
  hop count; entries expire after ``LIVECACHE_TTL`` seconds. Fresh,
  low-hop entries are the preferred dial targets.
- **PeerFinder** — the connect policy: keeps ``out_desired`` outbound
  slots filled (fixed seeds first, then livecache by hops, then
  bootcache by valence), caps total peers, records outcomes, and
  assembles the periodic gossip sample (own endpoint at hop 0 plus a
  bounded re-share of fresh entries at hop+1, reference
  Tuning::numberOfEndpoints).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Iterable, Optional

__all__ = ["Bootcache", "Livecache", "PeerFinder"]

MAX_HOPS = 6
GOSSIP_MAX = 12  # numberOfEndpoints = 2 * maxHops
LIVECACHE_TTL = 30.0
GOSSIP_INTERVAL = 5.0  # reference secondsPerMessage
VALENCE_MAX = 10
# reconnect hygiene: first failure backs a target off REDIAL_BACKOFF
# seconds, consecutive failures double it up to REDIAL_BACKOFF_MAX, and
# a deterministic per-(address, failure-count) jitter of up to 25%
# decorrelates a fleet restarting against one dead seed. on_success
# resets the ladder. (reference: connection attempts ride timer ticks;
# the explicit ladder guarantees no tight redial spin against a
# refusing/dead address regardless of timer rate.)
REDIAL_BACKOFF = 15.0
REDIAL_BACKOFF_MAX = 300.0


class Bootcache:
    """Valence-ranked persistent endpoint store (Bootcache.h role)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._valence: dict[tuple[str, int], int] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    for line in f:
                        rec = json.loads(line)
                        self._valence[(rec["host"], int(rec["port"]))] = int(
                            rec["valence"]
                        )
            except (OSError, ValueError, KeyError):
                self._valence = {}

    def insert(self, addr: tuple[str, int]) -> None:
        with self._lock:
            self._valence.setdefault(addr, 0)

    def on_success(self, addr: tuple[str, int]) -> None:
        with self._lock:
            v = self._valence.get(addr, 0)
            self._valence[addr] = min(VALENCE_MAX, v + 1 if v >= 0 else 1)

    def on_failure(self, addr: tuple[str, int]) -> None:
        with self._lock:
            v = self._valence.get(addr, 0)
            self._valence[addr] = max(-VALENCE_MAX, v - 1 if v <= 0 else -1)

    def ranked(self) -> list[tuple[str, int]]:
        """Addresses best-first (highest valence)."""
        with self._lock:
            return [
                a
                for a, _v in sorted(
                    self._valence.items(), key=lambda kv: -kv[1]
                )
            ]

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            items = list(self._valence.items())
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for (host, port), valence in items:
                f.write(json.dumps({"host": host, "port": port, "valence": valence}))
                f.write("\n")
        os.replace(tmp, self.path)

    def __len__(self) -> int:
        with self._lock:
            return len(self._valence)


class Livecache:
    """Hop-counted, expiring gossip endpoint cache (Livecache.h role)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        # addr -> (hops, heard_at)
        self._entries: dict[tuple[str, int], tuple[int, float]] = {}

    def insert(self, addr: tuple[str, int], hops: int) -> None:
        if hops > MAX_HOPS:
            return
        now = self._clock()
        with self._lock:
            cur = self._entries.get(addr)
            # keep the lowest-hop, freshest sighting
            if cur is None or hops <= cur[0]:
                self._entries[addr] = (hops, now)

    def expire(self) -> None:
        now = self._clock()
        with self._lock:
            dead = [
                a for a, (_h, t) in self._entries.items() if now - t > LIVECACHE_TTL
            ]
            for a in dead:
                del self._entries[a]

    def sample(self, limit: int = GOSSIP_MAX) -> list[tuple[str, int, int]]:
        """(host, port, hops) entries, lowest-hop first."""
        self.expire()
        with self._lock:
            items = sorted(self._entries.items(), key=lambda kv: kv[1][0])
        return [(a[0], a[1], h) for a, (h, _t) in items[:limit]]

    def addrs(self) -> list[tuple[str, int]]:
        self.expire()
        with self._lock:
            return [
                a
                for a, (_h, _t) in sorted(
                    self._entries.items(), key=lambda kv: kv[1][0]
                )
            ]

    def __len__(self) -> int:
        self.expire()
        with self._lock:
            return len(self._entries)


class PeerFinder:
    """Connect policy + gossip assembly (PeerSlotLogic role)."""

    def __init__(
        self,
        fixed: Iterable[tuple[str, int]],
        out_desired: int = 4,
        max_peers: int = 21,  # reference defaultMaxPeers
        bootcache_path: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self._clock = clock or time.monotonic
        self.fixed = list(fixed)
        self.out_desired = out_desired
        self.max_peers = max_peers
        self.bootcache = Bootcache(bootcache_path)
        self.livecache = Livecache(clock=self._clock)
        self._lock = threading.Lock()
        self._last_fail: dict[tuple[str, int], float] = {}
        self._fail_count: dict[tuple[str, int], int] = {}
        self.backoff_base = REDIAL_BACKOFF
        self.backoff_max = REDIAL_BACKOFF_MAX
        for a in self.fixed:
            self.bootcache.insert(a)

    # -- outcomes ---------------------------------------------------------

    def on_success(self, addr: tuple[str, int]) -> None:
        self.bootcache.on_success(addr)
        with self._lock:
            self._last_fail.pop(addr, None)
            self._fail_count.pop(addr, None)

    def on_failure(self, addr: tuple[str, int]) -> None:
        self.bootcache.on_failure(addr)
        with self._lock:
            self._last_fail[addr] = self._clock()
            self._fail_count[addr] = self._fail_count.get(addr, 0) + 1

    def backoff_delay(self, addr: tuple[str, int]) -> float:
        """Current redial delay for an address: exponential in its
        consecutive-failure count, capped, with deterministic jitter
        (pure function of address and count — testable, yet two nodes
        dialing one dead seed still spread out)."""
        import zlib

        with self._lock:
            n = self._fail_count.get(addr, 0)
        if n == 0:
            return 0.0
        delay = min(self.backoff_max, self.backoff_base * (2 ** (n - 1)))
        seed = zlib.crc32(f"{addr[0]}:{addr[1]}:{n}".encode())
        return delay * (1.0 + 0.25 * (seed % 1000) / 1000.0)

    # -- gossip -----------------------------------------------------------

    def on_endpoints(
        self, endpoints, sender: Optional[tuple] = None
    ) -> int:
        """Learn from a received ENDPOINTS message; returns #accepted,
        or -1 when the message itself is abusive (oversized).

        Only the first GOSSIP_MAX entries are processed — a well-behaved
        peer never sends more (reference Tuning::numberOfEndpointsMax),
        and an unbounded message must not flood the caches. Entries above
        MAX_HOPS are discarded (loop guard); hop-0 entries are rewritten
        to the sender's observed host, preventing a peer from advertising
        an arbitrary third-party address as itself (reference
        PeerSlotLogic endpoint checking)."""
        endpoints = list(endpoints)
        oversized = len(endpoints) > GOSSIP_MAX
        n = 0
        for host, port, hops in endpoints[:GOSSIP_MAX]:
            if hops > MAX_HOPS or not (0 < port < 65536):
                continue
            if hops == 0 and sender is not None:
                host = sender[0]
            addr = (str(host), int(port))
            self.livecache.insert(addr, int(hops))
            self.bootcache.insert(addr)
            n += 1
        return -1 if oversized else n

    def gossip_sample(
        self, own: Optional[tuple[str, int]]
    ) -> list[tuple[str, int, int]]:
        """Our periodic ENDPOINTS payload: self at hop 0 + fresh re-shares
        at hop+1."""
        out: list[tuple[str, int, int]] = []
        if own is not None:
            out.append((own[0], own[1], 0))
        for host, port, hops in self.livecache.sample(GOSSIP_MAX - len(out)):
            out.append((host, port, hops + 1))
        return out

    # -- connect policy ---------------------------------------------------

    def dial_targets(
        self,
        connected: set[tuple[str, int]],
        dialing: set[tuple[str, int]],
        out_count: int,
        total_count: int,
    ) -> list[tuple[str, int]]:
        """Addresses to dial now. Fixed seeds are always kept connected;
        discovered addresses fill the remaining outbound slots
        (livecache by hops, then bootcache by valence), observing the
        per-address failure backoff and the total peer cap."""
        now = self._clock()
        targets: list[tuple[str, int]] = []

        def eligible(a: tuple[str, int]) -> bool:
            if a in connected or a in dialing or a in targets:
                return False
            last = self._last_fail.get(a)
            return last is None or now - last >= self.backoff_delay(a)

        for a in self.fixed:
            if eligible(a):
                targets.append(a)
        want = self.out_desired - out_count - len(targets)
        if total_count + len(targets) >= self.max_peers:
            want = 0
        if want > 0:
            for a in self.livecache.addrs():
                if want <= 0:
                    break
                if eligible(a):
                    targets.append(a)
                    want -= 1
            for a in self.bootcache.ranked():
                if want <= 0:
                    break
                if eligible(a):
                    targets.append(a)
                    want -= 1
        return targets

    # -- slot accounting (reference: peerfinder/impl/Counts.h, Fixed.h) ----

    @property
    def max_in(self) -> int:
        """Inbound slot cap: whatever the total cap leaves after the
        outbound allotment (reference Counts::onConfig — maxPeers split
        into outDesired outbound + the rest inbound)."""
        return max(0, self.max_peers - self.out_desired)

    def can_accept_inbound(
        self, in_count: int, is_fixed_or_cluster: bool = False
    ) -> bool:
        """Admission check for a completed inbound handshake. Fixed and
        cluster peers have RESERVED slots and are always admitted
        (reference: Fixed.h fixed slots / cluster slots bypass the
        inbound cap); everyone else competes for max_in."""
        if is_fixed_or_cluster:
            return True
        return in_count < self.max_in

    def handout(
        self,
        exclude: set[tuple[str, int]],
        limit: int = GOSSIP_MAX,
    ) -> list[tuple[str, int]]:
        """Utility-ranked addresses to hand a peer we are refusing for
        lack of slots (reference ConnectHandouts.cpp: a full node
        REDIRECTS the connector to better targets instead of silently
        dropping it). Ranking: fresh low-hop livecache entries first,
        then bootcache by valence."""
        out: list[tuple[str, int]] = []
        for a in self.livecache.addrs():
            if len(out) >= limit:
                return out
            if a not in exclude and a not in out:
                out.append(a)
        for a in self.bootcache.ranked():
            if len(out) >= limit:
                break
            if a not in exclude and a not in out:
                out.append(a)
        return out

    def get_json(self) -> dict:
        return {
            "fixed": len(self.fixed),
            "bootcache": len(self.bootcache),
            "livecache": len(self.livecache),
            "max_in": self.max_in,
            "out_desired": self.out_desired,
            "max_peers": self.max_peers,
        }
