"""Entry point of the port's flagship computation: the batched Ed25519
verify kernel (K1) on one card, with the same 16-signature example as
the JAX package's ``__graft_entry__.entry``."""

from __future__ import annotations

import numpy as np


def _raw_batch(batch: int):
    """(pubs, msgs, sigs): 8 keys from seed 0, signing 32-byte messages
    in turn — byte for byte the JAX package's example."""
    from .ops import ed25519_ref as ref

    rng = np.random.default_rng(0)
    seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(8)]
    pubs8 = [ref.derive_public(s) for s in seeds]
    msgs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(batch)]
    sigs = [ref.sign(seeds[i % 8], pubs8[i % 8], msgs[i]) for i in range(batch)]
    pubs = [pubs8[i % 8] for i in range(batch)]
    return pubs, msgs, sigs


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
