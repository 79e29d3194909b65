"""Entry points of the port's flagship computation: the batched Ed25519
verify kernel (K1) on one card, with the same 16-signature example as
the JAX package's ``__graft_entry__.entry``; and ``dryrun_multichip``,
the JAX package's check of the same step sharded over a mesh."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=4)
def _signed(batch: int):
    from .ops import ed25519_ref as ref

    rng = np.random.default_rng(0)
    seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(8)]
    pubs8 = [ref.derive_public(s) for s in seeds]
    msgs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(batch)]
    sigs = [ref.sign(seeds[i % 8], pubs8[i % 8], msgs[i]) for i in range(batch)]
    pubs = [pubs8[i % 8] for i in range(batch)]
    return tuple(pubs), tuple(msgs), tuple(sigs)


def _raw_batch(batch: int):
    """(pubs, msgs, sigs) lists: 8 keys from seed 0, signing 32-byte
    messages in turn — byte for byte the JAX package's example (signed
    once a size; the caller may change its lists)."""
    return tuple(list(x) for x in _signed(batch))


def entry(device="cuda"):
    """-> (fn, example_args): fn(*example_args) is a [16] bool verdict
    tensor, computed by K1 on a CUDA device (its plain version on the
    CPU)."""
    from .ops.ed25519 import prepare_batch, to_tensors
    from .ops.ed25519_cuda import verify
    from .utils.device import resolve_device

    t = to_tensors(prepare_batch(*_raw_batch(16)), resolve_device(device))
    args = (t["a_words"], t["r_words"], t["s_bytes"], t["h_bytes"], t["s_canonical"])
    return verify, args


def dryrun_multichip(n_devices: int, device="cuda", batch: int = 4096) -> dict:
    """Run the verify and hash step sharded over an ``n_devices`` mesh
    once, with the JAX package's three checks
    (``__graft_entry__.dryrun_multichip``); raise AssertionError if one
    fails, else return what was checked.

    ``device``: ``"cuda"`` for the first ``n_devices`` cards (raises if
    fewer are visible), ``"cpu"`` for ``n_devices`` CPU shards (the plain
    versions), or an explicit list of ``n_devices`` devices (the same
    card may repeat: shards on one card). ``batch``: the signatures of
    the first check, at least 8 a shard, rounded up to a multiple of the
    width.

    1. ``verify_and_count``: R, S and A corrupted before host prep in the
       first shard of every two, so that the device must find them; the
       flags and the device-side total exact.
    2. A ragged batch padded with zero rows (S = 0 is canonical: K1
       rejects them by the curve equation), its flags and total exact.
    3. 64 payloads of 33-599 bytes hashed by ``sharded_masked_sha512``,
       equal to hashlib.
    """
    import hashlib

    import torch

    from .ops.ed25519 import prepare_batch, to_tensors
    from .ops.sha512 import padded_block_count
    from .ops.treehash import pad_leaf_batch
    from .parallel.mesh import make_mesh, sharded_masked_sha512, verify_and_count
    from .utils.device import resolve_device

    if isinstance(device, (list, tuple)):
        devices = list(device)
    elif resolve_device(device).type == "cpu":
        devices = ["cpu"] * n_devices
    else:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise ValueError(f"{n_devices} cards asked for, {have} visible")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for a mesh of {n_devices}")
    mesh = make_mesh(devices)
    step = verify_and_count(mesh)

    def run(pubs, msgs, sigs):
        flags, total = step(**to_tensors(prepare_batch(pubs, msgs, sigs), mesh.first))
        return flags.cpu().numpy(), int(total.item())

    # 1. cryptographically corrupted bytes in every second shard
    batch = max(batch, 8 * n_devices)
    batch = (batch + n_devices - 1) // n_devices * n_devices
    pubs, msgs, sigs = _raw_batch(batch)
    per_shard = batch // n_devices
    bad = np.zeros(batch, dtype=bool)
    for d in range(0, n_devices, 2):
        lo = d * per_shard
        s = bytearray(sigs[lo]); s[5] ^= 0x40; sigs[lo] = bytes(s)  # R
        s = bytearray(sigs[lo + 1]); s[32] ^= 0x01; sigs[lo + 1] = bytes(s)  # S, < l
        p = bytearray(pubs[lo + 2]); p[3] ^= 0x80; pubs[lo + 2] = bytes(p)  # A
        bad[lo : lo + 3] = True
    flags, total = run(pubs, msgs, sigs)
    assert total == batch - int(bad.sum()), (total, batch - int(bad.sum()))
    assert np.array_equal(flags, ~bad), "per-shard verdicts wrong"

    # 2. a ragged batch, padded to the width with zero rows
    ragged = batch - per_shard // 2 - 1
    pad = batch - ragged
    r_flags, r_total = run(pubs[:ragged] + [b"\x00" * 32] * pad,
                           msgs[:ragged] + [b""] * pad,
                           sigs[:ragged] + [b"\x00" * 64] * pad)
    assert np.array_equal(r_flags[:ragged], ~bad[:ragged]), "ragged verdicts wrong"
    assert not r_flags[ragged:].any(), "a zero pad row was accepted"
    assert r_total == ragged - int(bad[:ragged].sum())

    # 3. mesh-hashed payloads against hashlib
    rng = np.random.default_rng(7)
    payloads = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
                for n in rng.integers(33, 600, 64)]
    ladder = max(padded_block_count(len(p)) for p in payloads)
    blocks, nblocks = pad_leaf_batch(payloads, ladder)
    state = sharded_masked_sha512(mesh)(
        torch.from_numpy(blocks).to(mesh.first), torch.from_numpy(nblocks).to(mesh.first))
    rows = state.cpu().numpy()
    for i, p in enumerate(payloads):
        assert rows[i].astype(">u4").tobytes() == hashlib.sha512(p).digest(), \
            f"mesh-hashed digest {i} wrong"
    return {"devices": [str(d) for d in mesh.devices], "batch": batch, "total": total,
            "planted": int(bad.sum()), "ragged": ragged, "ragged_total": r_total,
            "digests": len(payloads), "flags": flags}
