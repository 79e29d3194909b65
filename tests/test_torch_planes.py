"""The port's load plane and routing hasher against the JAX package's.

- **The load plane** (node/loadmgr.py: LoadFeeTrack, LoadManager, the
  backlog shed and the deadlock canary, with the node's scaled fee):
  every test of tests/test_loadmgr.py runs twice, once as it is and once
  with the port's names in its module's place, and the two runs' load
  factors (every value a LoadFeeTrack reports) must be equal.
- **The routing hasher** (crypto/backend.py: `_HashCostModel`,
  `WatchdogHasher`, `make_watched_hasher`), on a CudaHasher on the CPU
  (K2/K3's plain versions): the cost model makes the JAX model's choices
  on the same observations; device routing sends every batch at or over
  the floor to the inner hasher and hashes exactly what the host would;
  a deadline overrun alone falls back (sticky, and an abandoned tree
  call stamps nothing), while an error the device call raises
  propagates; the watchdog's helper thread carries its caller's role,
  so K2/K3 launches are counted by the thread that asked for them.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import stellard_tpu.node.loadmgr as jax_loadmgr
import stellard_tpu.state.ledger as jax_ledger
import test_loadmgr as tl
from stellard_tpu.crypto.backend import _HashCostModel as JaxCostModel
from stellard_tpu_torch.crypto.backend import (
    CpuHasher,
    CudaHasher,
    WatchdogHasher,
    _HashCostModel,
    make_watched_hasher,
)
from stellard_tpu_torch.node import loadmgr as port_loadmgr
from stellard_tpu_torch.node.jobqueue import JobQueue, JobType
from stellard_tpu_torch.node.node import Node
from stellard_tpu_torch.protocol import sfields as port_sfields
from stellard_tpu_torch.protocol.formats import TxType
from stellard_tpu_torch.protocol.keys import KeyPair
from stellard_tpu_torch.protocol.stamount import STAmount
from stellard_tpu_torch.protocol.sttx import SerializedTransaction
from stellard_tpu_torch.protocol.ter import TER
from stellard_tpu_torch.state.ledger import Ledger as PortLedger
from stellard_tpu_torch.state.shamap import SHAMap, SHAMapItem, TNType, compute_hashes
from stellard_tpu_torch.utils import devicewatch
from test_torch_txq import CpuConfig, cases, run_method

PORT_NAMES = {
    "Config": CpuConfig, "JobQueue": JobQueue, "JobType": JobType,
    "LoadFeeTrack": port_loadmgr.LoadFeeTrack, "LoadManager": port_loadmgr.LoadManager,
    "NORMAL_FEE": port_loadmgr.NORMAL_FEE, "TX_BACKLOG_SHED": port_loadmgr.TX_BACKLOG_SHED,
    "Node": Node, "TxType": TxType, "KeyPair": KeyPair, "sfAmount": port_sfields.sfAmount,
    "sfDestination": port_sfields.sfDestination, "STAmount": STAmount,
    "SerializedTransaction": SerializedTransaction, "TER": TER,
}
# names a test body imports from the JAX package inside itself
PORT_INLINE = [(jax_ledger, "Ledger", PortLedger),
               (jax_loadmgr, "MAX_FEE", port_loadmgr.MAX_FEE)]


def recording(track_cls, log: list):
    """``track_cls`` logging every load factor it reports."""
    class Logged(track_cls):
        @property
        def load_factor(self):
            value = super().load_factor
            log.append(value)
            return value

    return Logged


@pytest.mark.parametrize(("cls", "name"), cases(tl))
def test_loadmgr_case_equal_to_jax(cls, name):
    logs = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "LoadFeeTrack", recording(tl.LoadFeeTrack, logs["jax"]))
        run_method(tl, cls, name)
    with pytest.MonkeyPatch.context() as mp:
        for attr, obj in PORT_NAMES.items():
            mp.setattr(tl, attr, obj)
        for mod, attr, obj in PORT_INLINE:
            mp.setattr(mod, attr, obj)
        mp.setattr(tl, "LoadFeeTrack", recording(port_loadmgr.LoadFeeTrack, logs["port"]))
        run_method(tl, cls, name)
    if "Concurrency" not in cls.__name__:  # threads interleave their reads
        assert logs["port"] == logs["jax"]


# -- the routing hasher ---------------------------------------------------------


@pytest.fixture(autouse=True)
def healthy_device():
    """A wedge marks the process-wide device verdict dead: restore it."""
    devicewatch.HEALTH.reset()
    yield
    devicewatch.HEALTH.reset()


def tree(n: int, seed: int) -> SHAMap:
    rng = np.random.default_rng(seed)
    m = SHAMap(TNType.ACCOUNT_STATE)
    m.bulk_update([SHAMapItem(rng.bytes(32), rng.bytes(int(rng.integers(60, 140))))
                   for _ in range(n)])
    return m


def test_cost_model_chooses_as_the_jax_model():
    """The same observations through both packages' models give the same
    arm for every batch size, and the same snapshot."""
    rng = np.random.default_rng(5)
    port, jax = _HashCostModel(reexplore_every=4, min_device_nodes=16), JaxCostModel(
        reexplore_every=4, min_device_nodes=16)
    choices = {"port": [], "jax": []}
    for _ in range(400):
        n = int(rng.integers(1, 5000))
        for name, model in (("port", port), ("jax", jax)):
            arm = model.choose(n)
            choices[name].append(arm)
            ms = n * (0.002 if arm == "host" else 0.0004) + (0.0 if arm == "host" else 0.3)
            model.observe(arm, n, ms)
    assert choices["port"] == choices["jax"]
    assert {"host", "device"} <= set(choices["port"])
    assert port.get_json() == jax.get_json()


def test_device_routing_hashes_as_the_host():
    wd = make_watched_hasher("cuda", min_device_nodes=8, routing="device", device="cpu")
    assert isinstance(wd, WatchdogHasher) and isinstance(wd.inner, CudaHasher)
    assert isinstance(make_watched_hasher("cpu"), CpuHasher)
    inner = wd.inner
    host = CpuHasher()
    rng = np.random.default_rng(2)
    for n in (3, 8, 40):
        prefixes = [int(x) for x in rng.integers(0, 1 << 32, n)]
        payloads = [rng.bytes(int(k)) for k in rng.integers(1, 300, n)]
        assert wd.prefix_hash_batch(prefixes, payloads) == host.prefix_hash_batch(
            prefixes, payloads)
    # under the floor to the fallback, at or over it to the inner hasher
    assert wd.fallback.host_nodes == 3 and inner.device_nodes == 48
    a, b = tree(600, 1), tree(600, 1)
    assert wd.hash_tree(a.root) > 0
    compute_hashes(b.root, CpuHasher())  # the twin tree, on the host alone
    assert a.get_hash() == b.get_hash()
    assert inner.tree_calls == 1 and inner.tree_transfers.readbacks == 1
    j = wd.get_json()
    assert j["wedged"] is False
    assert j["transfers"]["readbacks"] == inner.transfers.readbacks + 1  # flat + one tree
    assert j["mesh"]["device"] == "cpu" and j["mesh"]["kernels"] == "plain"
    # the JAX wrapper's surface: meters through `inner`, sums of nodes
    assert wd.device_nodes == inner.device_nodes
    assert wd.host_nodes == inner.host_nodes + wd.fallback.host_nodes


def test_a_kernel_error_propagates_and_a_wedge_raises_for_good():
    """A failed launch propagates unchanged and wedges nothing; a device
    call past its deadline raises, leaves the tree untouched, and every
    later call raises too: nothing is hashed on the host instead."""

    class Slow(CudaHasher):
        def hash_tree(self, root, cancelled=None, cancel_lock=None):
            time.sleep(0.6)
            return super().hash_tree(root, cancelled=cancelled, cancel_lock=cancel_lock)

    class Broken(CudaHasher):
        def hash_packed(self, buf, offsets):
            raise RuntimeError("K2 launch failed")

    broken = WatchdogHasher(Broken(device="cpu"), CpuHasher(), routing="device",
                            first_timeout=30)
    with pytest.raises(RuntimeError, match="K2 launch failed"):
        broken.hash_packed(b"\x00" * 40, [0, 20, 40])
    assert not broken.device_wedged

    slow_inner = Slow(device="cpu")
    slow = WatchdogHasher(slow_inner, CpuHasher(), routing="device", first_timeout=0.1)
    m = tree(300, 3)
    with pytest.raises(devicewatch.DeviceWedged):
        slow.hash_tree(m.root)
    assert slow.device_wedged and slow.get_json()["wedged"]
    time.sleep(1.0)  # the abandoned call finishes and stamps nothing
    assert slow_inner.device_nodes == 0 and m.root._hash is None
    assert slow.fallback.host_nodes == 0
    # sticky, whatever the routing would choose: the next calls raise
    devicewatch.HEALTH.reset()
    with pytest.raises(devicewatch.DeviceWedged):
        slow.hash_packed(b"\x00" * 40, [0, 20, 40])
    with pytest.raises(devicewatch.DeviceWedged):
        slow.hash_tree(tree(10, 4).root)
    assert slow.fallback.host_nodes == 0
    # one plane's wedge is every plane's: a fresh hasher raises too
    devicewatch.HEALTH.mark_dead("test")
    fresh = WatchdogHasher(CudaHasher(device="cpu"), CpuHasher(), routing="cost")
    with pytest.raises(devicewatch.DeviceWedged):
        fresh.hash_packed(b"\x00" * 40, [0, 20, 40])
    assert fresh.device_wedged


def test_watchdog_thread_carries_the_callers_role():
    roles, stats0 = [], dict(devicewatch.call_stats)

    def probe():
        th = threading.current_thread()
        roles.append((th.name, getattr(th, "role", None)))

    t = threading.Thread(target=lambda: devicewatch.call_with_deadline(
        probe, 30, label="hash-device"), name="seal-drain")
    t.start()
    t.join()
    devicewatch.call_with_deadline(probe, 30, label="hash-device")
    assert roles == [("hash-device-call", "seal-drain"),
                     ("hash-device-call", threading.current_thread().name)]
    assert devicewatch.call_stats["calls"] == stats0["calls"] + 2
    assert devicewatch.call_stats["start_ms"] >= stats0["start_ms"]


def test_launches_are_counted_by_the_callers_role(monkeypatch):
    """ops.treehash counts a launch under the role the watchdog's thread
    carries, not under that thread's own name."""
    from stellard_tpu_torch.ops import treehash

    treehash.reset_launches()
    t = threading.Thread(target=lambda: devicewatch.call_with_deadline(
        lambda: treehash._count("sha512_masked"), 30, label="hash-device"),
        name="seal-hash-state")
    t.start()
    t.join()
    assert treehash.launches_by_thread == {
        "seal-hash-state": {"sha512_masked": 1, "tree_inner_level": 0}}
    treehash.reset_launches()
