"""chip_smoke.py's consensus workload (BASELINE config #4: 4 validators,
all on the UNL, quorum 3) through both packages' SimNet.

- At a small size, the JAX package verifies on the host and the port on
  a ``VerifyPlane("cuda", routing="device")`` and a
  ``CudaHasher(device="cpu")``: K1, K2 and K3 take their plain versions
  here. Every validated hash, the closed results, the validators' rounds
  and defense counters, net_stats, the digest of every frame sent, the
  planted burst's and forgeries' verdicts and the bad copies' answers
  are equal; the port makes no host signature check (the dispute
  re-check of LedgerConsensus.accept, the reference's own, found none to
  make) and every signature goes to the plane.
- At the smoke's size, the port's SimNet (host verify) gives the
  constants chip_smoke.py holds the card's run to; the slow test
  recomputes them from the JAX package and prints them:

      JAX_PLATFORMS=cpu python -m pytest tests/test_torch_consensus_workload.py -m slow -q -s
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
from stellard_tpu.consensus.consensus import LedgerConsensus as JaxLedgerConsensus
from stellard_tpu.consensus.validation import STValidation as JaxSTValidation
from stellard_tpu.node.hashrouter import SF_BAD as JAX_SF_BAD
from stellard_tpu.node.hashrouter import SF_SIGGOOD as JAX_SF_SIGGOOD
from stellard_tpu.overlay import wire as jax_wire
from stellard_tpu.overlay.simnet import SimNet as JaxSimNet
from stellard_tpu.protocol.sfields import sfSignature as jax_sfSignature
from stellard_tpu.protocol.sttx import SerializedTransaction as JaxSTTx
from stellard_tpu.protocol.ter import TER as JaxTER
from stellard_tpu_torch.crypto.backend import CudaHasher
from stellard_tpu_torch.node.verifyplane import VerifyPlane
from stellard_tpu_torch.protocol import keys as tkeys
from stellard_tpu_torch.protocol.ter import TER

# one measured round of two payments (one with a bad copy), a burst of 3:
# the plain K1 takes ~1.5 s a call here, and the phase makes ~90 of them
SMALL = dict(n_rounds=1, per_round=2, n_burst=3, bad_share=0.5, seed=37)


def jax_consensus_names() -> SimpleNamespace:
    return SimpleNamespace(
        SimNet=JaxSimNet, LedgerConsensus=JaxLedgerConsensus, STValidation=JaxSTValidation,
        wire=jax_wire, sfSignature=jax_sfSignature, SerializedTransaction=JaxSTTx,
        TER=JaxTER, SF_BAD=JAX_SF_BAD, SF_SIGGOOD=JAX_SF_SIGGOOD)


def comparable(out: dict) -> dict:
    """What both packages must give alike (wall times and the net
    itself aside)."""
    return {k: v for k, v in out.items() if k not in ("net", "round_ms", "submit_ms")}


@pytest.fixture(scope="module")
def small_runs():
    wl = cs.consensus_workload(**SMALL)
    jax = cs.run_consensus(jax_consensus_names(), wl)
    plane = VerifyPlane(backend="cuda", routing="device", min_device_batch=1,
                        device_first_timeout=900, device_warm_timeout=900,
                        backend_opts={"device": "cpu"})
    hasher = CudaHasher(device="cpu")
    batches = []

    def verify_many(reqs):
        out = plane.verify_many(reqs)
        batches.append((len(reqs), [bool(x) for x in out]))
        return out

    host0 = tkeys.host_verifies
    try:
        port = cs.run_consensus(cs.port_consensus_names(), wl, verify_many=verify_many,
                                hasher=hasher)
    finally:
        plane.stop()
    return {"wl": wl, "jax": jax, "port": port, "plane": plane.get_json(),
            "hasher": hasher, "batches": batches, "host": tkeys.host_verifies - host0}


def test_small_workload_equal_to_jax(small_runs):
    jax, port, wl = small_runs["jax"], small_runs["port"], small_runs["wl"]
    assert comparable(port) == comparable(jax)
    assert len(port["hashes"]) >= 3 and port["base"] >= 2
    # the bad copies refused at validator 0; the burst's bad lane, the
    # forged validation and the forged proposal rejected
    n_bad = sum(bad is not None for entries in wl["rounds"] for _g, bad in entries)
    assert n_bad >= 1 and port["bad_copy_ters"] == [int(TER.temINVALID)] * n_bad
    want = ["bad" if i == wl["bad_lane"] else "good" for i in range(len(wl["burst"]))]
    assert port["burst_verdicts"] == [want] * 4
    assert port["counters"]["defense"][0] == {"bad_proposal_sig": 1, "bad_validation_sig": 1}
    assert port["counters"]["defense"][1:] == [{}, {}, {}]
    assert port["counters"]["rounds_completed"] == [3, 3, 3, 3]


def test_small_workload_runs_the_port_planes(small_runs):
    """Every signature on the plane's device arm (K1's plain version
    here), none on the host; the relay burst verified in one batch on
    each validator; the trees through the CudaHasher, one readback a
    tree."""
    plane, batches, hasher = small_runs["plane"], small_runs["batches"], small_runs["hasher"]
    assert small_runs["host"] == 0
    assert plane["device_share"] == 1.0 and plane["cpu_sigs"] == 0
    n_burst = SMALL["n_burst"]
    assert sum(n == n_burst for n, _ in batches) == 4
    assert {n for n, _ in batches} == {1, n_burst}
    assert hasher.device_nodes > 0
    assert hasher.tree_calls > 0 and hasher.tree_transfers.readbacks == hasher.tree_calls
    # every batch-1 verdict the phase got, and the bad ones among them
    verdicts = [v for _n, vs in batches for v in vs]
    assert verdicts.count(False) == 4 + 2 + 1  # burst lanes, forgeries, bad copy


def test_a_verify_plane_error_propagates():
    """A failed verify on the plane fails the delivery: SimNet's relay
    burst does not swallow it (no per-tx path verifies in its place)."""
    wl = cs.consensus_workload(**SMALL)
    calls = []

    def broken(reqs):
        calls.append(len(reqs))
        if len(reqs) > 1:
            raise RuntimeError("K1 launch failed")
        return np.ones(len(reqs), bool)

    with pytest.raises(RuntimeError, match="K1 launch failed"):
        cs.run_consensus(cs.port_consensus_names(), wl, verify_many=broken)
    assert calls[-1] == SMALL["n_burst"]


def test_full_size_port_gives_the_smoke_constants():
    """The port's SimNet on the smoke's workload (host verify) gives what
    the JAX package gave: the constants chip_smoke.py holds the card to."""
    out = cs.run_consensus(cs.port_consensus_names(),
                           cs.consensus_workload(**cs.CONSENSUS_SIZES))
    assert out["hashes"] == cs.CONSENSUS_HASHES
    assert out["results"] == cs.CONSENSUS_RESULTS
    assert out["counters"] == cs.CONSENSUS_COUNTERS


@pytest.mark.slow
def test_jax_full_size_constants():
    """The JAX package's SimNet on the smoke's workload: print the
    constants chip_smoke.py holds (CONSENSUS_HASHES, CONSENSUS_RESULTS,
    CONSENSUS_COUNTERS) and check them."""
    wl = cs.consensus_workload(**cs.CONSENSUS_SIZES)
    out = cs.run_consensus(jax_consensus_names(), wl)
    print(f"CONSENSUS_HASHES = {out['hashes']!r}")
    print(f"CONSENSUS_RESULTS = {out['results']!r}")
    print(f"CONSENSUS_COUNTERS = {out['counters']!r}")
    n_bad = sum(bad is not None for entries in wl["rounds"] for _g, bad in entries)
    assert out["bad_copy_ters"] == [int(JaxTER.temINVALID)] * n_bad
    assert out["counters"]["dispute_rechecks"] == 0
    assert out["hashes"] == cs.CONSENSUS_HASHES
    assert out["results"] == cs.CONSENSUS_RESULTS
    assert out["counters"] == cs.CONSENSUS_COUNTERS
