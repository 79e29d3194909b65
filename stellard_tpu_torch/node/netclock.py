"""SNTP-disciplined network clock.

Role parity with the reference's src/ripple_net/basics/SNTPClient.cpp
(wired at Application.cpp:698-699, consumed as getNetworkTimeNC): the
node queries configured SNTP servers over UDP, keeps a smoothed offset
between the local clock and network time, and the consensus plane reads
close times through it. Close-time agreement must not depend on every
host's wall clock being right.

The client speaks standard SNTPv4 (RFC 4330) so it works against real
NTP servers; tests drive it against an in-process UDP responder.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional

__all__ = ["SntpClient", "NTP_EPOCH_DELTA"]

NTP_EPOCH_DELTA = 2208988800  # 1900-01-01 -> 1970-01-01
MAX_PLAUSIBLE_OFFSET = 600.0  # ignore insane replies (reference sanity)


class SntpClient:
    """Polls SNTP servers; exposes a smoothed offset and network_time()."""

    def __init__(
        self,
        servers: list[tuple[str, int]],
        poll_interval: float = 64.0,
        timeout: float = 2.0,
    ):
        self.servers = list(servers)
        self.poll_interval = poll_interval
        self.timeout = timeout
        self._offset = 0.0  # network - local, seconds
        self._have_sample = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.queries = 0
        self.replies = 0

    # -- wire --------------------------------------------------------------

    @staticmethod
    def _build_request() -> bytes:
        # LI=0 VN=4 Mode=3 (client); transmit timestamp = local now
        pkt = bytearray(48)
        pkt[0] = (4 << 3) | 3
        tx = time.time() + NTP_EPOCH_DELTA
        sec = int(tx)
        frac = int((tx - sec) * (1 << 32))
        struct.pack_into(">II", pkt, 40, sec, frac)
        return bytes(pkt)

    @staticmethod
    def _parse_reply(data: bytes) -> Optional[float]:
        """-> server transmit time (unix seconds) or None."""
        if len(data) < 48:
            return None
        mode = data[0] & 0x7
        if mode != 4:  # server reply
            return None
        sec, frac = struct.unpack_from(">II", data, 40)
        if sec == 0:
            return None
        return sec - NTP_EPOCH_DELTA + frac / (1 << 32)

    def query_once(self) -> bool:
        """One round against all servers; keeps the best (first) reply."""
        for host, port in self.servers:
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.settimeout(self.timeout)
            try:
                t0 = time.time()
                sock.sendto(self._build_request(), (host, port))
                self.queries += 1
                data, _addr = sock.recvfrom(512)
                t1 = time.time()
            except OSError:
                continue
            finally:
                sock.close()
            server_time = self._parse_reply(data)
            if server_time is None:
                continue
            # midpoint correction: assume symmetric path delay
            local_mid = (t0 + t1) / 2.0
            offset = server_time - local_mid
            if abs(offset) > MAX_PLAUSIBLE_OFFSET:
                continue
            with self._lock:
                self.replies += 1
                if not self._have_sample:
                    self._offset = offset
                    self._have_sample = True
                else:
                    # smooth: clock discipline without step jumps
                    self._offset += 0.25 * (offset - self._offset)
            return True
        return False

    # -- service -----------------------------------------------------------

    def start(self) -> "SntpClient":
        self._thread = threading.Thread(
            target=self._run, name="sntp", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        self.query_once()
        while not self._stop.wait(self.poll_interval):
            self.query_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- readings ----------------------------------------------------------

    @property
    def offset(self) -> float:
        with self._lock:
            return self._offset

    @property
    def synced(self) -> bool:
        with self._lock:
            return self._have_sample

    def network_unix_time(self) -> float:
        """Local clock corrected by the disciplined offset
        (reference getNetworkTimeNC semantics)."""
        return time.time() + self.offset

    def get_json(self) -> dict:
        with self._lock:
            return {
                "synced": self._have_sample,
                "offset_s": round(self._offset, 6),
                "queries": self.queries,
                "replies": self.replies,
            }
