"""``verify_and_count`` and the multichip dry run of the port, held to the
JAX package's (tests/test_mesh_integration.py, ``__graft_entry__.
dryrun_multichip``).

The port's ``parallel.mesh.verify_and_count`` runs K1 (its plain
version here) with its count epilogue on each of N CPU shards and sums
the shards' counts on the first device; the JAX one runs its sharded
kernel over ``jax.devices()[:N]`` and ``psum``s. On the same inputs, at
widths 1/2/4/8, the flags and totals are equal, with failures local to
single shards and an uneven batch padded with zero rows. Then the port's
``entry.dryrun_multichip`` on CPU shards, and the mesh's uneven cuts.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from stellard_tpu.ops.ed25519_jax import prepare_batch as jax_prepare
from stellard_tpu.parallel.mesh import make_mesh as jax_mesh
from stellard_tpu.parallel.mesh import verify_and_count as jax_verify_and_count
from stellard_tpu_torch.entry import dryrun_multichip
from stellard_tpu_torch.ops import ed25519_ref as ref
from stellard_tpu_torch.ops.ed25519 import prepare_batch, to_tensors
from stellard_tpu_torch.parallel import make_mesh, sharded_verify_kernel, verify_and_count

N = 128


def planted(n: int, pad: int = 0):
    """graft's signed batch with R/S/A corruptions in shard-local
    positions (the first rows of shards 0, 3 and 7 of 8, and the last
    row), then ``pad`` zero rows: (pubs, msgs, sigs, oracle)."""
    pubs, msgs, sigs = graft._raw_batch(n)
    per = n // 8
    for i, what in ((0, "r"), (1, "s"), (3 * per, "a"), (7 * per + 1, "r"), (n - 1, "s")):
        if what == "a":
            p = bytearray(pubs[i]); p[3] ^= 0x80; pubs[i] = bytes(p)
        else:
            s = bytearray(sigs[i]); s[5 if what == "r" else 32] ^= 0x41; sigs[i] = bytes(s)
    pubs, msgs, sigs = (pubs + [b"\x00" * 32] * pad, msgs + [b""] * pad,
                        sigs + [b"\x00" * 64] * pad)
    want = np.array([ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)])
    return pubs, msgs, sigs, want


@functools.lru_cache(maxsize=None)
def jax_counter(width: int):
    """The JAX verify_and_count over the first ``width`` devices, built
    once a module: each build is a new jit, whose XLA compile dominates
    these tests' time, and the uneven batch reuses width 8's shapes."""
    return jax_verify_and_count(jax_mesh(jax.devices()[:width]))


def run_jax(width: int, pubs, msgs, sigs):
    inp = jax_prepare(pubs, msgs, sigs)
    flags, total = jax_counter(width)(
        inp["a_words"], inp["r_words"], inp["s_windows"], inp["h_digits"], inp["s_canonical"])
    return np.asarray(flags), int(total)


def run_port(width: int, pubs, msgs, sigs):
    flags, total = verify_and_count(make_mesh(["cpu"] * width))(
        **to_tensors(prepare_batch(pubs, msgs, sigs), "cpu"))
    assert flags.dtype == torch.bool and total.dtype == torch.int32 and total.dim() == 0
    return flags.numpy(), int(total)


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_verify_and_count_equals_jax_with_shard_local_failures(width):
    pubs, msgs, sigs, want = planted(N)
    assert len(jax.devices()) >= width
    got, total = run_port(width, pubs, msgs, sigs)
    got_jax, total_jax = run_jax(width, pubs, msgs, sigs)
    assert got.tobytes() == got_jax.tobytes()
    assert total == total_jax == int(want.sum()) == N - 5
    assert np.array_equal(got, want)


def test_verify_and_count_uneven_batch_padded_with_zero_rows():
    """123 signatures padded to 128 (8 shards of 16) with zero rows, as
    the JAX dry run pads a ragged batch: K1 rejects the pad rows itself
    (S = 0 is canonical; the curve equation fails)."""
    pubs, msgs, sigs, want = planted(123, pad=N - 123)
    got, total = run_port(8, pubs, msgs, sigs)
    got_jax, total_jax = run_jax(8, pubs, msgs, sigs)
    assert got.tobytes() == got_jax.tobytes()
    assert total == total_jax == int(want.sum()) == 118
    assert not got[123:].any()


def test_uneven_cut_needs_no_padding():
    """The port's mesh cuts a batch that does not divide by the width
    into shards one row apart (the JAX mesh needs a divisible batch):
    the flags and the total are those of width 1."""
    pubs, msgs, sigs, want = planted(64)
    pubs, msgs, sigs, want = pubs[:61], msgs[:61], sigs[:61], want[:61]
    mesh = make_mesh(["cpu"] * 4)
    assert [hi - lo for _d, lo, hi in mesh.shards(61)] == [16, 15, 15, 15]
    assert [hi - lo for _d, lo, hi in mesh.shards(2)] == [1, 1, 0, 0]
    got, total = run_port(4, pubs, msgs, sigs)
    assert np.array_equal(got, want) and total == int(want.sum())
    t = to_tensors(prepare_batch(pubs[:2], msgs[:2], sigs[:2]), "cpu")
    assert np.array_equal(sharded_verify_kernel(mesh)(**t).numpy(), want[:2])
    empty = {k: v[:0] for k, v in t.items()}
    flags, total = verify_and_count(mesh)(**empty)
    assert flags.shape == (0,) and int(total) == 0


@pytest.mark.parametrize("width", [2, 4])
def test_dryrun_multichip_on_cpu_shards(width):
    """The port's dry run makes the JAX one's three checks on CPU
    shards: planted R/S/A corruptions in every second shard with the
    total exact, a ragged batch padded with zero rows, 64 mesh-hashed
    payloads equal to hashlib. Its flags at width 2 and 4 are the same
    batch's, so they agree."""
    out = dryrun_multichip(width, device="cpu", batch=64)
    planted_rows = 3 * ((width + 1) // 2)
    assert (out["batch"], out["planted"], out["total"]) == (64, planted_rows, 64 - planted_rows)
    assert out["devices"] == ["cpu"] * width and out["digests"] == 64
    per = 64 // width
    bad = np.zeros(64, bool)
    for d in range(0, width, 2):
        bad[d * per : d * per + 3] = True
    assert np.array_equal(out["flags"], ~bad)
    with pytest.raises(ValueError):
        dryrun_multichip(width, device=["cpu"] * (width + 1))
