"""The port's Ed25519 host prep and plain verify (stellard_tpu_torch.ops.
ed25519, the reference K1 is held against) against the JAX package.

Exact equality everywhere: host-prep arrays, digit expansions, the comb
table, and verdicts. One batch shape of 32 is used for the JAX kernel
(the shape test_crypto_plane already compiles). The port differs from
the JAX kernel and oracle on one rule only: it rejects a key whose y
encoding is >= p (``ed25519_ref.key_is_canonical``), as the C++ host
verifier of both packages does, where they reduce y mod p; the
comparisons below apply that rule to the JAX side.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stellard_tpu.ops import ed25519_jax as J
from stellard_tpu.ops import ed25519_ref as jref
from stellard_tpu_torch.interop import batch_from_numpy
from stellard_tpu_torch.ops import ed25519 as E
from stellard_tpu_torch.ops import ed25519_cuda as K1
from stellard_tpu_torch.ops import ed25519_ref as tref
from stellard_tpu_torch.ops.ed25519_cases import adversarial_cases

BATCH = 32
CSRC = Path(__file__).resolve().parent.parent / "stellard_tpu_torch" / "csrc"


def _check_modes_corpus():
    """The corpus of tests/test_verify_check_modes.py, padded to 32 with
    valid signatures: bit flips, non-canonical R (y = 1 + p), x = 0 with
    the sign bit, the A = R = identity / S = 0 forgery (accepted), an
    off-curve R and a non-canonical S."""
    rng = np.random.default_rng(5)
    seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(4)]
    keys = [(s, tref.derive_public(s)) for s in seeds]
    pubs, msgs, sigs = [], [], []
    for i in range(27):
        sk, pk = keys[i % 4]
        m = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        s = bytearray(tref.sign(sk, pk, m))
        if i % 5 == 1:
            s[rng.integers(0, 64)] ^= 1 << rng.integers(0, 8)
        pubs.append(pk)
        msgs.append(m)
        sigs.append(bytes(s))
    ident = (1).to_bytes(32, "little")
    zero_s = bytes(32)
    m = b"\x42" * 32
    x0s1 = bytearray(ident)
    x0s1[31] |= 0x80
    for pk, sig in [
        (ident, (1 + tref.P).to_bytes(32, "little") + zero_s),
        (ident, bytes(x0s1) + zero_s),
        (ident, ident + zero_s),
        (keys[0][1], b"\x17" * 32 + zero_s),
    ]:
        pubs.append(pk)
        msgs.append(m)
        sigs.append(sig)
    sk, pk = keys[1]
    mm = b"\x55" * 32
    good = tref.sign(sk, pk, mm)
    s_nc = int.from_bytes(good[32:], "little") + tref.L
    pubs.append(pk)
    msgs.append(mm)
    sigs.append(good[:32] + s_nc.to_bytes(32, "little"))
    assert len(pubs) == BATCH
    return pubs, msgs, sigs


def _adversarial_corpus():
    cases = adversarial_cases(seed=11, n_random=BATCH - 14)
    assert len(cases) == BATCH
    _, pubs, msgs, sigs = (list(t) for t in zip(*cases))
    return pubs, msgs, sigs


CORPORA = {"adversarial": _adversarial_corpus, "check_modes": _check_modes_corpus}


def _key_canonical(pubs) -> np.ndarray:
    return np.array([len(p) == 32 and tref.key_is_canonical(p) for p in pubs])


def test_oracle_copy_is_the_reference():
    pubs, msgs, sigs = _adversarial_corpus()
    differ = 0
    for p, m, s in zip(pubs, msgs, sigs):
        assert tref.verify(p, m, s) == (jref.verify(p, m, s) and tref.key_is_canonical(p))
        differ += tref.verify(p, m, s) != jref.verify(p, m, s)
    assert differ == 1  # the forgery on a key whose y is p + 1
    seed = bytes(range(32))
    assert tref.derive_public(seed) == jref.derive_public(seed)
    assert tref.sign(seed, tref.derive_public(seed), b"m") == \
        jref.sign(seed, jref.derive_public(seed), b"m")


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_prepare_batch_matches_jax(corpus):
    pubs, msgs, sigs = CORPORA[corpus]()
    want = J.prepare_batch(pubs, msgs, sigs, device_put=False)
    got = E.prepare_batch(pubs, msgs, sigs)
    assert np.array_equal(got["a_words"], want["a_words"])
    assert np.array_equal(got["r_words"], want["r_words"])
    assert np.array_equal(got["s_bytes"], want["s_windows"])  # raw wire
    assert np.array_equal(got["h_bytes"], want["h_digits"])
    assert np.array_equal(got["s_canonical"], want["s_canonical"] & _key_canonical(pubs))
    t = batch_from_numpy({**want, "s_canonical": got["s_canonical"]}, device="cpu")
    for k, v in E.to_tensors(got, "cpu").items():
        assert torch.equal(t[k], v), k


def test_comb_table_and_digit_expansion_match_jax():
    assert np.array_equal(E._comb_table_np(), J._comb_table_np())
    rng = np.random.default_rng(5)
    b = rng.integers(0, 256, (256, 32), dtype=np.uint8)
    b[:, 31] &= 0x1F  # the < 2^253 recode contract
    b[0, :] = 0x77  # long carry-propagate runs
    b[1, :16] = 0x78
    b[2, :] = 0
    assert np.array_equal(E._nibbles_le(b), J._nibbles_le(b))
    assert np.array_equal(E._signed_digits_le(b), J._signed_digits_le(b))
    tb = torch.from_numpy(b)
    assert np.array_equal(E.expand_s_windows(tb).numpy(),
                          np.asarray(J.expand_s_windows(jnp.asarray(b))))
    assert np.array_equal(E.expand_h_digits(tb).numpy(),
                          np.asarray(J.expand_h_digits(jnp.asarray(b))))
    assert np.array_equal(E.expand_h_digits(tb).numpy(),
                          E._signed_digits_le(b).astype(np.int32))


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_plain_verify_matches_jax_kernel_and_oracle(corpus):
    pubs, msgs, sigs = CORPORA[corpus]()
    canonical = _key_canonical(pubs)
    want_oracle = np.array([jref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]) & canonical
    jax_in = J.prepare_batch(pubs, msgs, sigs)
    want_jax = np.asarray(J.verify_kernel(**jax_in)) & canonical
    got = K1.verify(**E.to_tensors(E.prepare_batch(pubs, msgs, sigs), "cpu"))
    assert got.dtype == torch.bool and got.shape == (BATCH,)
    assert np.array_equal(got.numpy(), want_jax)
    assert np.array_equal(got.numpy(), want_oracle)
    assert want_oracle.any() and not want_oracle.all()


def test_edge_case_verdicts():
    """The cases a verifier may not get wrong, by name: ref10 accepts
    the small-order forgery, and rejects everything else below; the
    port rejects it through a non-canonical-y key too (the JAX kernel
    accepts it there)."""
    cases = adversarial_cases(seed=11, n_random=0)
    kinds, pubs, msgs, sigs = (list(t) for t in zip(*cases))
    got = K1.verify(**E.to_tensors(E.prepare_batch(pubs, msgs, sigs), "cpu")).numpy()
    verdict = dict(zip(kinds, got.tolist()))
    assert verdict.pop("valid") and verdict.pop("small_order_forgery")
    assert not any(verdict.values()), verdict


def test_wrapper_rejects_bad_inputs():
    t = E.to_tensors(E.prepare_batch(*_adversarial_corpus()), "cpu")
    with pytest.raises(TypeError):
        K1.verify(**{**t, "a_words": t["a_words"].view(torch.int32)})
    with pytest.raises(ValueError):
        K1.verify(**{**t, "s_bytes": t["s_bytes"][:, :31].contiguous()})
    with pytest.raises(ValueError):
        K1.verify(**{**t, "r_words": t["r_words"].t().contiguous().t()})
    empty = {k: v[:0] for k, v in t.items()}
    assert K1.verify(**empty).shape == (0,)


def test_kernel_constants_match_the_curve():
    """The radix-2^51 constants written into the CUDA source, and the
    base-point table the wrapper uploads, against the oracle's values."""
    src = (CSRC / "ed25519_verify.cu").read_text()

    def limbs(name):
        body = re.search(name + r"\[5\] = \{([^}]*)\}", src).group(1)
        vals = [int(v.strip().rstrip("ULL")) for v in body.split(",")]
        return sum(v << (51 * i) for i, v in enumerate(vals))

    assert limbs("C_D") == tref.D
    assert limbs("C_D2") == 2 * tref.D % tref.P
    assert limbs("C_SQRTM1") == tref.SQRT_M1
    tab = K1.base_table_np().astype(object)
    acc = tref.IDENTITY
    for k in range(15):
        acc = tref.pt_add(acc, tref.BASE)
        x, y, z, _ = acc
        zi = pow(z, tref.P - 2, tref.P)
        xa, ya = x * zi % tref.P, y * zi % tref.P
        got = [sum(int(v) << (51 * i) for i, v in enumerate(tab[k, c])) for c in range(4)]
        assert got == [(ya + xa) % tref.P, (ya - xa) % tref.P,
                       2 * tref.D * xa * ya % tref.P, 2]


@pytest.mark.slow  # the Pallas kernel in interpret mode: ~2 min
def test_plain_verify_matches_pallas_kernel():
    from stellard_tpu.ops.ed25519_pallas import verify_kernel_pallas

    pubs, msgs, sigs = _check_modes_corpus()
    want = np.asarray(verify_kernel_pallas(**J.prepare_batch(pubs, msgs, sigs)))
    got = K1.verify(**E.to_tensors(E.prepare_batch(pubs, msgs, sigs), "cpu"))
    assert np.array_equal(got.numpy(), want)
