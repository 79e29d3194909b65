"""Real-process TCP+TLS transport helpers: a private net of validator
processes.

The net-lab helpers (config template, launcher, RPC client, a hostile
peer) that the multi-process tests and ``chip_smoke.py`` share. Each
validator is a ``python -m stellard_tpu_torch --conf <ini> --start``
process; ``validator_config`` writes the private-net INI the reference's
example config documents.

The scenario runner over this transport (``run_tcp``) needs the scenario
plane (``testkit/scenario.py``), which this package does not have yet.
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
import time
import urllib.request

from ..protocol.keys import KeyPair

__all__ = [
    "free_ports", "rpc", "wait_until", "validator_config",
    "spawn_validator", "hostile_flood", "REPO", "SPEED",
]

REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
SPEED = 5.0  # virtual seconds per real second (clock_speed knob)


def free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def rpc(port: int, method: str, params: dict | None = None, timeout=5.0):
    body = json.dumps({"method": method, "params": [params or {}]}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=body,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)["result"]


def wait_until(pred, timeout: float, interval: float = 0.5):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            last = pred()
            if last:
                return last
        except Exception:
            pass
        time.sleep(interval)
    return last


def validator_config(i: int, keys, peer_ports, rpc_port, ws_port=None,
                     quorum=3, speed=SPEED, backend="cpu") -> str:
    """One validator's INI (the shape the reference's private-net
    example config documents: UNL of the OTHER validators, fixed peer
    list, quorum). ``backend`` is both crypto sections' ``type=``:
    ``cpu`` verifies and hashes on the host, ``cuda`` on the card."""
    n = len(keys)
    others_keys = "\n".join(
        keys[j].human_node_public for j in range(n) if j != i
    )
    others_addrs = "\n".join(
        f"127.0.0.1 {peer_ports[j]}" for j in range(n) if j != i
    )
    ws = f"\n[websocket_port]\n{ws_port}\n" if ws_port is not None else ""
    return f"""
[standalone]
0

[node_db]
type=memory

[signature_backend]
type={backend}

[hash_backend]
type={backend}

[validation_seed]
{keys[i].human_seed}

[validators]
{others_keys}

[validation_quorum]
{quorum}

[peer_port]
{peer_ports[i]}

[peer_ssl]
require

[ips]
{others_addrs}

[clock_speed]
{speed}

[rpc_port]
{rpc_port}
{ws}"""


def spawn_validator(cfg_path: str, stdout=subprocess.DEVNULL):
    """Launch one validator process from its config."""
    return subprocess.Popen(
        [sys.executable, "-m", "stellard_tpu_torch", "--conf", cfg_path,
         "--start"],
        cwd=REPO, stdout=stdout, stderr=subprocess.STDOUT,
    )


def hostile_flood(
    peer_port: int,
    frames: int = 200,
    mode: str = "junk_tx",
    host: str = "127.0.0.1",
    passphrase: str = "tcp-flooder",
    reconnects: int = 3,
) -> dict:
    """The byzantine matrix promoted onto the REAL TCP net: a hostile
    client that completes a genuine
    nonce+signed-hello handshake with a throwaway key, then floods the
    victim with hostile frames until the victim's resource plane drops
    it. Modes:

        junk_tx    TxMessage frames with unparseable blobs
                   (FEE_BAD_DATA per frame at the victim)
        garbage    out-of-schema message types (kills the session per
                   frame — exercised via `reconnects` handshake loops)

    Returns {"sent", "disconnected", "reconnect_refused"} — the caller
    asserts the victim disconnected the flooder AND refuses its
    readmission (the `resource.*` drop gate), while staying healthy.
    Works against any plaintext [peer_port] (in-process TcpOverlay or
    a spawned validator)."""
    from ..overlay.tcp import HP_SESSION, PROTO_VERSION
    from ..overlay.wire import FrameReader, Hello, TxMessage, frame
    from ..utils.hashes import prefix_hash

    key = KeyPair.from_passphrase(passphrase)
    rng = random.Random(0x7C9F)
    stats = {"sent": 0, "disconnected": False, "reconnect_refused": False}

    def handshake(sock) -> bool:
        sock.settimeout(5.0)
        nonce = os.urandom(32)
        while nonce[0] == 0x16:  # never look like a TLS ClientHello
            nonce = os.urandom(32)
        sock.sendall(nonce)
        theirs = b""
        while len(theirs) < 32:
            chunk = sock.recv(32 - len(theirs))
            if not chunk:
                return False
            theirs += chunk
        session_hash = prefix_hash(
            HP_SESSION, min(nonce, theirs) + max(nonce, theirs)
        )
        hello = Hello(
            PROTO_VERSION, 35_000_000, key.public,
            key.sign(session_hash), 1, b"\x00" * 32, 0,
        )
        sock.sendall(frame(hello))
        reader = FrameReader()
        while True:
            data = sock.recv(65536)
            if not data:
                return False
            if reader.feed(data):
                return True

    def closed(sock, timeout=10.0) -> bool:
        sock.settimeout(timeout)
        try:
            while True:
                if sock.recv(65536) == b"":
                    return True
        except (ConnectionResetError, BrokenPipeError):
            return True
        except OSError:
            return False

    for _episode in range(max(1, reconnects)):
        try:
            sock = socket.create_connection((host, peer_port), timeout=5.0)
        except OSError:
            stats["reconnect_refused"] = True
            return stats
        try:
            if not handshake(sock):
                # refused before/at hello: the admission gate is shut
                stats["reconnect_refused"] = stats["disconnected"]
                return stats
            for _ in range(frames):
                if mode == "garbage":
                    data = (
                        (3).to_bytes(4, "big") + (99).to_bytes(2, "big")
                        + b"\x00\x01\x02"
                    )
                else:
                    blob = bytes(rng.randrange(256) for _ in range(24))
                    data = frame(TxMessage(blob))
                try:
                    sock.sendall(data)
                except OSError:
                    stats["disconnected"] = True
                    break
                stats["sent"] += 1
            if not stats["disconnected"]:
                stats["disconnected"] = closed(sock)
        except OSError:
            stats["disconnected"] = True
        finally:
            try:
                sock.close()
            except OSError:
                pass
        if stats["disconnected"]:
            # probe readmission: a dropped endpoint must be refused at
            # accept (closed without a nonce) until its balance decays
            try:
                probe = socket.create_connection(
                    (host, peer_port), timeout=5.0
                )
            except OSError:
                stats["reconnect_refused"] = True
                return stats
            try:
                probe.settimeout(5.0)
                got = b""
                try:
                    got = probe.recv(32)
                except (socket.timeout, OSError):
                    got = b""
                stats["reconnect_refused"] = got == b""
            finally:
                probe.close()
            return stats
    return stats
