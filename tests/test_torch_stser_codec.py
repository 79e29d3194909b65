"""The port's STObject codec against the JAX package's on the fuzz corpus.

tools/stser_fuzz.py mutates valid serialized objects (a signed
transaction, a trust line, a directory node, transaction metadata):
bit flips, truncations, length-field lies and splices. Every mutant goes
through both packages' ``STObject.from_bytes``; each must accept or
reject it alike, and an accepted object must serialize to the same bytes
in both. Each package parses with its own native ``_stser`` extension
where that loads; one chunk runs again with the port's switched off
(``STELLARD_NATIVE_STSER=0``: its Python loops). Replay and the close parse every
stored or submitted transaction through this codec, so one disagreement
forks a node. Tolerance: zero (these are bytes).
"""

from __future__ import annotations

import os
import random
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import stser_fuzz  # noqa: E402
import stellard_tpu_torch.protocol.stobject as port_stobject  # noqa: E402
from stellard_tpu.protocol.stobject import STObject as JaxSTObject  # noqa: E402
from stellard_tpu_torch.native import load_stser  # noqa: E402
from stellard_tpu_torch.protocol.stobject import STObject  # noqa: E402

CASES = 100_000
SEED = 20260803
CHUNKS = 4


def outcome(cls, blob: bytes):
    try:
        return True, cls.from_bytes(blob).serialize()
    except Exception:  # noqa: BLE001 — rejection is an outcome
        return False, None


@pytest.fixture(scope="module")
def corpus() -> list[bytes]:
    rng = random.Random(SEED)
    seeds = stser_fuzz.seed_blobs()
    return [stser_fuzz.mutate(rng, rng.choice(seeds)) for _ in range(CASES)]


def test_seeds_round_trip_in_both():
    for blob in stser_fuzz.seed_blobs():
        assert STObject.from_bytes(blob).serialize() == blob
        assert outcome(STObject, blob) == outcome(JaxSTObject, blob)


def same_verdict_and_bytes(corpus, chunk):
    size = CASES // CHUNKS
    disagree, accepted = [], 0
    for i in range(chunk * size, (chunk + 1) * size):
        blob = corpus[i]
        port, jax = outcome(STObject, blob), outcome(JaxSTObject, blob)
        accepted += jax[0]
        if port != jax:
            disagree.append((i, blob.hex(), jax[0], port[0]))
    assert disagree == []
    # the mutations reach past the envelope: both branches are taken
    assert 0 < accepted < size


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_mutants_same_verdict_and_bytes(corpus, chunk):
    # the port's native codec is on wherever it builds
    assert (port_stobject._get_stser() is not None) == (load_stser() is not None)
    same_verdict_and_bytes(corpus, chunk)


def test_mutants_same_verdict_and_bytes_with_the_native_codec_off(corpus, monkeypatch):
    """Chunk 0 again, the port's switch read anew in this process: its
    Python loops against the JAX package's codec."""
    monkeypatch.setenv("STELLARD_NATIVE_STSER", "0")
    port_stobject._reset_stser()
    try:
        assert port_stobject._get_stser() is None
        same_verdict_and_bytes(corpus, 0)
    finally:
        monkeypatch.delenv("STELLARD_NATIVE_STSER")
        port_stobject._reset_stser()
        assert (port_stobject._get_stser() is not None) == (load_stser() is not None)
