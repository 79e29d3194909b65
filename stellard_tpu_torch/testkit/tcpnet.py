"""Real-process TCP+TLS transport for the scenario plane: a private net
of validator processes.

The net-lab helpers (config template, launcher, RPC client, a hostile
peer) that the multi-process tests, the scenario runner and
``chip_smoke.py`` share. Each validator is a ``python -m
stellard_tpu_torch --conf <ini> --start`` process; ``validator_config``
writes the private-net INI the reference's example config documents.

``run_tcp`` drives the SAME ``Scenario`` definitions as
``scenario.run_simnet`` — fault schedule (the kill/revive subset a
process net can express: a kill is a real SIGTERM/SIGKILL, a revive a
respawn that must catch up over genuine sockets), workload (the
identical pre-signed tx stream, submitted as tx_blob over the RPC
door), convergence tail, scorecard. Wall-clock and scheduler noise make
the TCP scorecard non-deterministic; its value is that the same
scenario shape survives real processes, not replayability.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Optional

from ..protocol.keys import KeyPair
from .schedule import FaultSchedule
from .workloads import TxFactory, build_spec_workload

__all__ = [
    "free_ports", "rpc", "wait_until", "validator_config",
    "spawn_validator", "run_tcp", "hostile_flood", "REPO", "SPEED",
    "TCP_EVENT_KINDS",
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


TCP_EVENT_KINDS = {"kill", "revive"}


def run_tcp(scn, step_seconds: float = 1.0, mesh_timeout: float = 120.0,
            backend: str = "cuda", log_dir: Optional[str] = None,
            timeline: Optional[dict] = None) -> dict:
    """Execute a Scenario's kill/revive + workload shape on a real
    process net; returns a (non-deterministic) scorecard with the same
    field names as the simnet one where they apply.

    ``backend`` is every validator's ``[signature_backend]`` and
    ``[hash_backend] type=``: ``cuda`` (each validator, and each revived
    one, builds its CUDA context and verifies and hashes on the card;
    without a card this raises before any process starts) or ``cpu``.
    ``log_dir`` keeps each validator's output (``v<i>.log``, a revived
    process appending to its slot's file); without it the output is
    dropped. ``timeline``, when given, is filled with the run's walls:
    ``boot_s`` (spawn to a full mesh), ``revive_door_s`` (each revive's
    seconds until its RPC door answers), ``steps_s``, ``tail_s`` and
    ``kernels`` (each validator's ``get_counts`` kernel launches at the
    end, the processes alive then)."""
    if backend == "cuda":
        from ..utils.device import resolve_device

        resolve_device("cuda")  # no card: raise before any process starts
    # same data-form + builder merge as run_simnet: matrix scenarios
    # carry schedule=/workload= DATA rather than closures, and the TCP
    # runner must consume both forms or a migrated scenario runs with
    # no faults and no traffic (a vacuous soak that greenwashes)
    sched = FaultSchedule(scn.seed)
    if scn.schedule is not None:
        sched.extend(scn.schedule.events)
    if scn.build_schedule is not None:
        scn.build_schedule(sched, scn)
    unsupported = {
        e.kind for e in sched.events if e.kind not in TCP_EVENT_KINDS
    }
    if unsupported:
        raise ValueError(
            f"scenario {scn.name!r} uses fault kinds the TCP transport "
            f"cannot express: {sorted(unsupported)}"
        )

    fac = TxFactory(seed=scn.seed)
    wl_rng = random.Random(0x301C ^ scn.seed)
    build_workload = scn.build_workload
    if build_workload is None and scn.workload is not None:
        build_workload = build_spec_workload(scn.workload)
    workload = (
        build_workload(fac, wl_rng, scn)
        if build_workload is not None else []
    )
    by_step: dict[int, list] = {}
    for at, nid, tx in workload:
        by_step.setdefault(at, []).append((nid, tx))

    n = scn.n_validators
    tmp = tempfile.mkdtemp(prefix="scn-tcp-")
    ports = free_ports(2 * n)
    peer_ports, rpc_ports = ports[:n], ports[n:]
    keys = [KeyPair.from_passphrase(f"chaos-val-{i}") for i in range(n)]
    cfg_paths = []
    for i in range(n):
        p = os.path.join(tmp, f"v{i}.cfg")
        with open(p, "w") as f:
            f.write(validator_config(
                i, keys, peer_ports, rpc_ports[i], quorum=scn.quorum,
                backend=backend,
            ))
        cfg_paths.append(p)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)

    procs: list = [None] * n
    down: set[int] = set()
    stats = {"submitted": 0, "errors": 0, "kills": 0}
    walls: dict = {"revive_door_s": [], "kernels": {}}
    door_watchers: list = []

    def respawn(i):
        if log_dir is None:
            procs[i] = spawn_validator(cfg_paths[i])
            return
        with open(os.path.join(log_dir, f"v{i}.log"), "ab") as out:
            procs[i] = spawn_validator(cfg_paths[i], stdout=out)

    def revive(i):
        t0 = time.monotonic()
        respawn(i)
        down.discard(i)
        if timeline is None:
            return
        entry = {"validator": i, "door_s": None}
        walls["revive_door_s"].append(entry)

        def watch():
            if wait_until(lambda: rpc(rpc_ports[i], "ping", timeout=2) is not None,
                          mesh_timeout, 0.25):
                entry["door_s"] = time.monotonic() - t0

        w = threading.Thread(target=watch, name=f"door-{i}", daemon=True)
        w.start()
        door_watchers.append(w)

    def terminate(i):
        p = procs[i]
        if p is None:
            return
        p.terminate()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()

    t_boot = time.monotonic()
    for i in range(n):
        respawn(i)

    try:
        def meshed():
            try:
                return all(
                    rpc(p, "server_info")["info"]["peers"] == n - 1
                    for p in rpc_ports
                )
            except Exception:
                return False

        if not wait_until(meshed, mesh_timeout, 2.0):
            raise RuntimeError("net never meshed")
        walls["boot_s"] = time.monotonic() - t_boot

        def submit(nid, tx):
            order = [nid] + [i for i in range(n) if i != nid]
            for i in order:
                if i in down:
                    continue
                try:
                    rpc(rpc_ports[i], "submit",
                        {"tx_blob": tx.serialize().hex()}, timeout=15)
                    stats["submitted"] += 1
                    return
                except Exception:
                    continue
            stats["errors"] += 1

        t_steps = time.monotonic()
        for step in range(scn.steps):
            t0 = time.monotonic()
            for ev in sched.events_at(step):
                if ev.kind == "kill":
                    terminate(ev.args[0])
                    down.add(ev.args[0])
                    stats["kills"] += 1
                elif ev.kind == "revive":
                    revive(ev.args[0])
            for nid, tx in by_step.get(step, ()):
                submit(nid, tx)
            left = step_seconds - (time.monotonic() - t0)
            if left > 0:
                time.sleep(left)
        for ev in sorted(
            (e for e in sched.events if e.at >= scn.steps),
            key=lambda e: (e.at, e.order),
        ):
            if ev.kind == "revive":
                revive(ev.args[0])
        walls["steps_s"] = time.monotonic() - t_steps

        def seqs():
            out = []
            for p in rpc_ports:
                try:
                    out.append(
                        rpc(p, "server_info")["info"]["validated_ledger"]["seq"]
                    )
                except Exception:
                    out.append(-1)
            return out

        t_tail = time.monotonic()
        target = max(seqs()) + scn.converge_extra
        budget = max(120.0, scn.max_tail_steps * step_seconds)
        deadline = time.monotonic() + budget
        last = seqs()
        while min(last) < target and time.monotonic() < deadline:
            time.sleep(3)
            last = seqs()
        converged = min(last) >= target
        common = min(last)
        walls["tail_s"] = time.monotonic() - t_tail
        hashes = set()
        single = False
        if converged:
            try:
                hashes = {
                    rpc(p, "ledger", {"ledger_index": common})
                    ["ledger"]["hash"]
                    for p in rpc_ports
                }
                single = len(hashes) == 1
            except Exception:
                single = False
        if timeline is not None:
            for i, p in enumerate(rpc_ports):
                try:
                    walls["kernels"][str(i)] = rpc(p, "get_counts").get("kernels")
                except Exception:
                    walls["kernels"][str(i)] = None
        return {
            "scenario": scn.name,
            "seed": scn.seed,
            "transport": "tcp",
            "steps": scn.steps,
            "converged": converged,
            "final_seq": common,
            "final_hash": next(iter(hashes)) if single else None,
            "single_hash": single,
            "validated_seqs": last,
            "submitted": stats["submitted"],
            "errors": stats["errors"],
            "kills": stats["kills"],
            "fault_digest": sched.digest(),
        }
    finally:
        for i in range(n):
            terminate(i)
        for w in door_watchers:
            w.join(timeout=mesh_timeout)
        shutil.rmtree(tmp, ignore_errors=True)
        if timeline is not None:
            timeline.update(walls)
