"""The port's crypto backend seam and verify plane, run on the CPU
(device="cpu": every kernel wrapper takes its plain version), against
the JAX package's TpuVerifier and entry point. Verdicts must be equal.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from stellard_tpu.crypto.backend import TpuVerifier
from stellard_tpu.crypto.backend import VerifyRequest as JaxVerifyRequest
from stellard_tpu_torch.crypto.backend import (
    CpuVerifier,
    CudaHasher,
    CudaVerifier,
    VerifyRequest,
    make_hasher,
    make_verifier,
)
from stellard_tpu_torch.node.verifyplane import VerifyPlane
from stellard_tpu_torch.ops import ed25519_ref as tref
from stellard_tpu_torch.ops.ed25519_cases import adversarial_cases
from stellard_tpu_torch.utils import devicewatch


def _cases(n_random: int = 26):
    return adversarial_cases(seed=23, n_random=n_random)


def _oracle(cases) -> np.ndarray:
    return np.array([len(m) == 32 and tref.verify(p, m, s) for _, p, m, s in cases])


def test_registry_seam():
    assert make_verifier("cpu").name == "cpu"
    assert make_verifier("cuda", device="cpu", max_batch=8).max_batch == 8
    assert make_hasher("cuda", device="cpu").name == "cuda"
    with pytest.raises(KeyError):
        make_verifier("tpu")
    with pytest.raises(KeyError):
        make_hasher("gpu")
    with pytest.raises(ValueError, match="does not accept"):
        make_verifier("cuda", device="cpu", min_batch=32)
    with pytest.raises(ValueError, match="does not accept"):
        make_hasher("cpu", mesh="1")
    # the width axis: any width over CPU shards; garbage raises at build
    v = make_verifier("cuda", device="cpu", mesh="4", devices=["cpu"] * 4)
    assert v.n_devices == 4
    with pytest.raises(ValueError, match="mesh="):
        make_verifier("cuda", device="cpu", mesh="wide")


@pytest.mark.parametrize("make", [
    lambda: CudaVerifier(device="cuda"),
    lambda: CudaHasher(device="cuda"),
    lambda: VerifyPlane(backend="cuda"),
    lambda: VerifyPlane(),
])
def test_cuda_without_a_card_raises(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        make()


def test_chunked_cuda_verifier_matches_tpu_verifier():
    cases = _cases()
    reqs = [VerifyRequest(p, m, s) for _, p, m, s in cases]
    v = CudaVerifier(max_batch=16, device="cpu")  # 40 -> chunks 16, 16, 8
    got = v.verify_batch(reqs)
    jreqs = [JaxVerifyRequest(p, m, s) for _, p, m, s in cases]
    want = TpuVerifier(min_batch=32, max_batch=32).verify_batch(jreqs)
    # the port rejects a key whose y encoding is >= p, which the JAX
    # kernel reduces mod p (tests/test_torch_native_host.py)
    canonical = np.array([tref.key_is_canonical(p) for _, p, _, _ in cases])
    assert np.array_equal(got, want & canonical) and int((want & ~canonical).sum()) == 1
    assert np.array_equal(got, _oracle(cases))
    assert v.transfers.uploads == v.transfers.readbacks == 3
    assert np.array_equal(CpuVerifier().verify_batch(reqs), got)


def test_verify_plane_many_and_submit_agree():
    cases = _cases()
    want = _oracle(cases)
    reqs = [VerifyRequest(p, m, s) for _, p, m, s in cases]
    plane = VerifyPlane(backend="cuda", routing="device", max_batch=32,
                        min_device_batch=8,
                        backend_opts={"device": "cpu", "max_batch": 16})
    try:
        assert np.array_equal(plane.verify_many(reqs), want)
        futs = [plane.submit(r) for r in reqs]
        assert [f.result(timeout=120) for f in futs] == want.tolist()
        j = plane.get_json()
        assert j["device_share"] == 1.0
        assert not j["device_wedged"]
        assert j["verified"] == 2 * len(reqs)
        assert j["transfers"]["readbacks"] == j["transfers"]["uploads"]
    finally:
        plane.stop()
    assert not plane._flusher.is_alive()


def test_verify_plane_cost_routing_and_wedge_fallback():
    cases = _cases(6)
    want = _oracle(cases)
    reqs = [VerifyRequest(p, m, s) for _, p, m, s in cases]
    plane = VerifyPlane(backend="cuda", min_device_batch=8,
                        backend_opts={"device": "cpu"})
    try:
        # cost routing: the first eligible batch explores the device
        assert np.array_equal(plane.verify_many(reqs), want)
        assert plane.device_batches == 1
        # a small batch stays on the host
        assert np.array_equal(plane.verify_many(reqs[:4]), want[:4])
        assert plane.cpu_batches == 1

        class Hung:
            def verify_batch(self, batch):
                time.sleep(2)

        # a device call past its deadline fails the batch, and every
        # later batch, small ones included: none is verified on the host
        plane.verifier = Hung()
        plane._warm_arms.add("device")
        plane._t_warm = 0.2
        cpu_sigs = plane.cpu_sigs
        try:
            with pytest.raises(devicewatch.DeviceWedged):
                plane.verify_many(reqs)
        finally:
            devicewatch.HEALTH.reset()  # the wedge verdict is process-wide
        assert plane.device_wedged and plane.get_json()["device_wedged"]
        for batch in (reqs, reqs[:4]):
            with pytest.raises(devicewatch.DeviceWedged):
                plane.verify_many(batch)
        assert plane.cpu_sigs == cpu_sigs
    finally:
        plane.stop()


def test_entry_matches_graft_entry():
    import __graft_entry__ as graft

    from stellard_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    got = fn(*args)
    jfn, jargs = graft.entry()
    # the JAX example is 16 signatures; run its kernel at the one shape
    # the suite compiles (32) by zero-padding, then compare the 16
    padded = [np.concatenate([np.asarray(a), np.zeros_like(np.asarray(a))])
              for a in jargs]
    want = np.asarray(jfn(*padded))[:16]
    assert got.shape == (16,)
    assert np.array_equal(got.numpy(), want)
    assert want.all()
    for mine, theirs in zip(args, jargs):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
