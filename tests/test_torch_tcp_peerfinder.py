"""The port's peer discovery and peer-level DoS defense
(overlay/peerfinder.py, overlay/resource.py on overlay/tcp.py) against
the JAX package's.

Every test of tests/test_peerfinder.py runs twice, as it is and on its
port twin, through test_torch_tcp's twin runner (records equal, zero
tolerance), but one: ``TestAbuse.test_garbage_flooder_is_dropped_and_
rejected`` floods from one thread with a 2 ms pause between frames
against a 60 s deadline, and asserts the mesh whole the instant the
flooder is refused; on a loaded host it fails when the flooder is not
charged faster than its balance decays, or when a legitimate session,
which shares the flooder's address, is still reconnecting. Its
behaviour is held on the port below by a flood that keeps ahead of the
decay on a busy host, and waits for the mesh.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

import pytest

import test_peerfinder as tpf
from test_torch_consensus import cases
from test_torch_tcp import net_deadline, tcp_recorder, tcp_twin, tcp_twin_runs  # noqa: F401

UNSTEADY = ("TestAbuse.test_garbage_flooder_is_dropped_and_rejected",)


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(tpf, skip=UNSTEADY))
def test_peerfinder_case_equal_to_jax(cname, mname, kwargs, tcp_recorder,  # noqa: F811
                                      tmp_path):
    tcp_twin_runs("test_peerfinder", cname, mname, kwargs, tcp_recorder, tmp_path)


def test_twin_runs_cover_the_file():
    assert len(cases(tpf, skip=UNSTEADY)) == 13


def flood_once(port: int) -> bool:
    """One hostile connection: nonce, then malformed frames (an unknown
    message type), each connection costing a malformed-request charge.
    True once the victim refuses us at admission."""
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
    except OSError:
        return False
    try:
        s.settimeout(5.0)
        if not s.recv(32):
            return True  # refused before the handshake: the gate is up
        s.sendall(os.urandom(32))
        junk = struct.pack(">IH", 10, 999) + os.urandom(10)
        for _ in range(50):
            s.sendall(junk)
        return False
    except OSError:
        return False  # charged and closed: reconnect and repeat
    finally:
        s.close()


def test_garbage_flooder_is_dropped_and_rejected_on_the_port(tmp_path):
    """The port's victim charges a garbage flooder per connection until
    its endpoint passes the drop line, then refuses it at admission; the
    legitimate mesh survives and keeps closing. Two flooding threads,
    with no pause between frames, keep the charge rate above the
    balance's decay on a loaded host."""
    twin = tcp_twin("test_peerfinder")
    fixture = twin.seeded_net.__wrapped__(tmp_path)
    overlays, ports = next(fixture)
    try:
        victim = overlays[0]
        assert twin.wait_until(lambda: victim.peer_count() == 3, 60)
        refused = threading.Event()
        deadline = time.monotonic() + 150

        def flood():
            while not refused.is_set() and time.monotonic() < deadline:
                if flood_once(ports[0]):
                    refused.set()

        threads = [threading.Thread(target=flood) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert refused.is_set(), victim.resources.get_json()
        # the endpoint is above the drop threshold: reconnects are
        # refused at accept time (the admission gate)
        assert not victim.resources.should_admit(("127.0.0.1", 55555))
        assert victim.resources.get_json()["dropped"] >= 1
        # the legitimate mesh survived the flood and keeps closing
        assert twin.wait_until(lambda: victim.peer_count() == 3, 30)
        seq = victim.node.lm.closed_ledger().seq
        assert twin.wait_until(
            lambda: all(ov.node.lm.closed_ledger().seq > seq for ov in overlays), 60)
    finally:
        next(fixture, None)
