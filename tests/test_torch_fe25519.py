"""The port's plain field arithmetic (stellard_tpu_torch.ops.fe25519)
against the JAX package's fe25519, limb for limb.

Both packages keep the limb-major [20, B] 13-bit layout, so every op's
output must be array-equal (exact: integer arithmetic) on the same
inputs, including 0, p-1 and redundant encodings of values >= p.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stellard_tpu.ops import fe25519 as JF
from stellard_tpu_torch.ops import fe25519 as TF

N = 64


def _elements():
    rng = np.random.default_rng(20)
    vals = [0, 1, JF.P - 1, JF.P, JF.P + 1, 2**255 - 1, JF.P - 19]
    vals += [int.from_bytes(rng.bytes(32), "little") % JF.P
             for _ in range(N - len(vals))]
    limbs = np.stack([JF.int_to_limbs_np(v) for v in vals], axis=1)
    # non-canonical limbs: some lanes carry limb 0 above 2^13, still
    # within the ops' 9500 input bound
    red = limbs.copy()
    red[0, 40:] += 1000
    return limbs, red


def _pair():
    a, ra = _elements()
    rng = np.random.default_rng(21)
    b = a[:, rng.permutation(N)]
    return ra, b


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _tn(x) -> np.ndarray:
    return x.numpy().astype(np.int64)


@pytest.mark.parametrize("op", ["fe_mul", "fe_add", "fe_sub"])
def test_binary_ops_limb_equal(op):
    a, b = _pair()
    want = jax.jit(getattr(JF, op))(jnp.asarray(a), jnp.asarray(b))
    got = getattr(TF, op)(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(_np(want), _tn(got))


@pytest.mark.parametrize(
    "op", ["fe_square", "fe_reduce_full", "fe_invert", "fe_pow_p58", "fe_neg"]
)
def test_unary_ops_limb_equal(op):
    a, _ = _pair()
    want = jax.jit(getattr(JF, op))(jnp.asarray(a))
    got = getattr(TF, op)(torch.from_numpy(a))
    assert np.array_equal(_np(want), _tn(got))


def test_canonical_values_and_lt_p():
    a, _ = _elements()
    red = TF.fe_reduce_full(torch.from_numpy(a))
    for i in range(N):
        assert TF.limbs_to_int(red[:, i].numpy()) == TF.limbs_to_int(a[:, i]) % TF.P
    lt_j = np.asarray(JF.limbs_lt_p(jnp.asarray(a)))
    lt_t = TF.limbs_lt_p(torch.from_numpy(a)).numpy()
    assert np.array_equal(lt_j, lt_t)
    assert not lt_t[3] and lt_t[2]  # p is not < p; p-1 is


def test_word_conversions_match():
    rng = np.random.default_rng(22)
    words = rng.integers(0, 2**32, (8, N), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(JF.limbs_from_words_le(jnp.asarray(words)))
    got = TF.limbs_from_words_le(torch.from_numpy(words.astype(np.int64)))
    assert np.array_equal(want.astype(np.int64), _tn(got))
    canon = np.asarray(JF.fe_reduce_full(jnp.asarray(want)))
    back_j = np.asarray(JF.limbs_to_words_le(jnp.asarray(canon)))
    back_t = TF.limbs_to_words_le(torch.from_numpy(canon.copy()))
    assert np.array_equal(back_j.astype(np.int64), _tn(back_t))
