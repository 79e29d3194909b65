"""The port's TCP overlay (overlay/tcp.py), with its TLS (peertls.py)
and peer discovery (peerfinder.py), against the JAX package's.

Every test of tests/test_tcp_overlay.py runs twice: once as it is, and
once on its port twin (the module's source with ``stellard_tpu.`` read
as ``stellard_tpu_torch.``, ``Config`` the port's on host crypto planes,
and the JAX test modules it imports replaced by their twins). Each run's
assertions must hold, and each run's record must equal the other's
(tolerance zero: bytes and counts). A record holds:

- for the socket-free objects (``Bootcache``, ``Livecache``,
  ``PeerFinder``, ``ResourceManager``, ``SntpClient``, a peer session's
  send queue, ``SegmentCatchup``): every answer of their policy calls,
  in order, and their end state;
- for a run that opens ``TcpOverlay``s: each overlay's identity and
  configuration (node key, UNL, quorum, squelch, sendq cap, TLS mode)
  and whether the overlays agree on the hash of every validated ledger
  they share. Ports, wall-clock close times and so every ledger hash of
  a TCP net differ between two runs, so the policy calls of such a run
  (whose answers name its ports) are not compared across the packages;
- for each ``Node`` a run makes: its UNL (keys and comments).

tests/test_torch_tcp_peerfinder.py, test_torch_tcp_defense.py,
test_torch_tcp_mixed.py and test_torch_tcp_multiproc.py reuse this
file's twin runner.
"""

from __future__ import annotations

import contextlib
import importlib
import signal
import sys
import threading
import types
from pathlib import Path

import pytest

import stellard_tpu.node.inbound as jax_inbound
import stellard_tpu.node.netclock as jax_netclock
import stellard_tpu.node.node as jax_node
import stellard_tpu.overlay.peerfinder as jax_peerfinder
import stellard_tpu.overlay.resource as jax_resource
import stellard_tpu.overlay.tcp as jax_tcp
import stellard_tpu_torch.node.inbound as port_inbound
import stellard_tpu_torch.node.netclock as port_netclock
import stellard_tpu_torch.node.node as port_node
import stellard_tpu_torch.overlay.peerfinder as port_peerfinder
import stellard_tpu_torch.overlay.resource as port_resource
import stellard_tpu_torch.overlay.tcp as port_tcp
from test_torch_consensus import cases, plain_value
from test_torch_txq import CpuConfig, run_method

TESTS = Path(__file__).resolve().parent

# each net test's own deadline, seconds: a wedged socket fails its test
# instead of holding the suite (both packages' runs of a twin together)
NET_DEADLINE = 240

# the JAX test modules a TCP test imports inside itself: its twin
# imports their twins
TWIN_IMPORTS = ("test_peerfinder",)

PACKAGES = {
    "jax": types.SimpleNamespace(
        tcp=jax_tcp, peerfinder=jax_peerfinder, resource=jax_resource,
        netclock=jax_netclock, node=jax_node, inbound=jax_inbound),
    "port": types.SimpleNamespace(
        tcp=port_tcp, peerfinder=port_peerfinder, resource=port_resource,
        netclock=port_netclock, node=port_node, inbound=port_inbound),
}
# the policy calls whose answers a run records, per class
CALLS = {
    ("peerfinder", "PeerFinder"): ("dial_targets", "gossip_sample", "backoff_delay",
                                   "on_endpoints", "handout", "can_accept_inbound"),
    ("peerfinder", "Bootcache"): ("ranked",),
    ("peerfinder", "Livecache"): ("sample", "addrs"),
    ("resource", "ResourceManager"): ("charge", "should_admit", "is_throttled"),
    ("netclock", "SntpClient"): ("query_once",),
}
WATCHED = (("tcp", "TcpOverlay"), ("peerfinder", "PeerFinder"), ("peerfinder", "Bootcache"),
           ("peerfinder", "Livecache"), ("resource", "ResourceManager"),
           ("netclock", "SntpClient"), ("node", "Node"), ("tcp", "_Peer"),
           ("inbound", "SegmentCatchup"))


def tcp_twin(name: str) -> types.ModuleType:
    """tests/<name>.py with every name of the JAX package the port's, the
    port's ``Config`` on host crypto planes (the JAX Config's default),
    and each JAX test module it imports replaced by its twin."""
    twin_name = f"{name}__tcpport"
    if twin_name in sys.modules:
        return sys.modules[twin_name]
    path = TESTS / f"{name}.py"
    src = path.read_text()
    src = src.replace("stellard_tpu.", "stellard_tpu_torch.").replace(
        "from stellard_tpu import", "from stellard_tpu_torch import")
    for dep in TWIN_IMPORTS:
        if f"from {dep} import" in src:
            tcp_twin(dep)
            src = src.replace(f"from {dep} import", f"from {dep}__tcpport import")
    mod = types.ModuleType(twin_name)
    mod.__file__ = str(path)
    sys.modules[twin_name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    if "Config" in vars(mod):
        mod.Config = CpuConfig
    return mod


def agree(overlays) -> bool:
    """Whether the overlays hold the same hash at every seq that each
    of them has validated."""
    validated = [ov.node.lm.validated for ov in overlays]
    tops = [v.seq for v in validated if v is not None]
    if len(tops) < 2:
        return True
    top = min(tops)
    for seq in range(1, top + 1):
        hashes = {ov.node.lm.ledger_history.get(seq) for ov in overlays
                  if ov.node.lm.validated is not None}
        if len(hashes - {None}) > 1:
            return False
    return True


def overlay_identity(ov) -> dict:
    tls = ov.peer_tls
    return {"key": ov.key.public.hex(), "unl": sorted(k.hex() for k in ov.node.unl),
            "quorum": ov.node.lm.min_validations, "squelch": ov.squelch.get_json(),
            "sendq_cap": ov.sendq_cap, "tls": None if tls is None else bool(tls.required)}


def end_state(kind: str, obj):
    if kind == "PeerFinder":
        return obj.get_json()
    if kind in ("Bootcache", "Livecache"):
        return len(obj)
    if kind == "ResourceManager":
        return {k: v for k, v in obj.get_json().items() if k != "entries"}
    if kind == "SntpClient":
        return obj.synced
    if kind == "Node":
        return sorted((e["pubkey_validator"], e["comment"]) for e in obj.unl.get_json())
    if kind == "_Peer":
        if isinstance(obj._writer, threading.Thread):
            # a live writer drains at the kernel's pace: only the outcome
            return {"alive": obj.alive}
        return {"dropped": obj.sendq_dropped, "evicted": obj.evicted, "alive": obj.alive,
                "queued": obj.sendq.qsize(), "streak": obj._consec_drops}
    if kind == "SegmentCatchup":
        return obj.counters.snapshot()
    return None


@contextlib.contextmanager
def deadline(seconds: int):
    """Raise TimeoutError in the test's (main) thread once ``seconds``
    have passed, wherever it waits."""
    def expired(_signum, _frame):
        raise TimeoutError(f"the test passed its {seconds} s deadline")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def net_deadline():
    with deadline(NET_DEADLINE):
        yield


class Recorder:
    """Records every watched object a run makes and the policy calls it
    answers; ``take`` returns the run's record."""

    def __init__(self):
        self.mp = pytest.MonkeyPatch()
        self.made: list = []
        self.calls: list = []

    def watch(self, pkg: str) -> None:
        ns = PACKAGES[pkg]
        for modname, cname in WATCHED:
            cls = getattr(getattr(ns, modname), cname)
            init = cls.__init__

            def wrapped(obj, *a, _init=init, _kind=cname, **kw):
                _init(obj, *a, **kw)
                if not any(o is obj for _k, o in self.made):
                    self.made.append((_kind, obj))

            self.mp.setattr(cls, "__init__", wrapped)
        for (modname, cname), methods in CALLS.items():
            cls = getattr(getattr(ns, modname), cname)
            for meth in methods:
                fn = getattr(cls, meth)

                def logged(obj, *a, _fn=fn, _tag=(cname, meth), **kw):
                    out = _fn(obj, *a, **kw)
                    self.calls.append((*_tag, plain_value(out)))
                    return out

                self.mp.setattr(cls, meth, logged)

    def take(self) -> list:
        self.mp.undo()
        overlays = [o for k, o in self.made if k == "TcpOverlay"]
        if overlays:
            out = [("overlay", overlay_identity(o)) for o in overlays]
            out.append(("agree", agree(overlays)))
            out += [("node", end_state("Node", o)) for k, o in self.made if k == "Node"]
        else:
            out = [(k, end_state(k, o)) for k, o in self.made]
            out.append(("calls", list(self.calls)))
        self.made, self.calls = [], []
        return out


@pytest.fixture
def tcp_recorder():
    r = Recorder()
    yield r
    r.mp.undo()


def tcp_twin_runs(name: str, cname: str, mname: str, kwargs: dict, recorder,
                  tmp_path) -> None:
    """The test run as it is and on its TCP twin; both must pass, and
    the two records must be equal."""
    logs = {}
    for pkg, mod in (("jax", importlib.import_module(name)), ("port", tcp_twin(name))):
        recorder.watch(pkg)
        path = tmp_path / pkg
        path.mkdir()
        try:
            run_method(mod, getattr(mod, cname), mname, tmp_path=path, kwargs=kwargs)
        finally:
            logs[pkg] = recorder.take()
    assert logs["port"] == logs["jax"]


import test_tcp_overlay as tto  # noqa: E402


@pytest.mark.parametrize(("cname", "mname", "kwargs"), cases(tto))
def test_tcp_overlay_case_equal_to_jax(cname, mname, kwargs, tcp_recorder, tmp_path):
    tcp_twin_runs("test_tcp_overlay", cname, mname, kwargs, tcp_recorder, tmp_path)


def test_twin_runs_cover_the_file():
    assert len(cases(tto)) == 13
