"""The path-quality fold's three arms in the port (``ops.pathq``: the
NumPy host arm, the plain PyTorch version, the wrapper) against the JAX
package's ``path_quality_host`` and ``path_quality_kernel`` (run on the
CPU), and the port's evaluator (``crypto.backend.PathQualityEvaluator``).

The limb form the JAX package and the plain versions use must equal the
one-product form K4 uses, ``min((a*b) >> 16, 2^32 - 1)``: shown here on
the edge values and on random pairs (hypothesis). Tolerance: zero.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from stellard_tpu.ops import pathq_jax
from stellard_tpu_torch.crypto.backend import PathQualityEvaluator, make_path_evaluator
from stellard_tpu_torch.ops import pathq
from stellard_tpu_torch.ops.pathq import (
    Q16_MAX, Q16_ONE, path_quality, path_quality_host, path_quality_ref)

EDGES = [0, 1, 2, 0xFFFF, 0x10000, 0x10001, 0x1FFFF, 0x7FFFFFFF, 0x80000000,
         0xFFFF0000, 0xFFFFFFFE, 0xFFFFFFFF]
HOPS = 8


def one_product(a: int, b: int) -> int:
    return min((a * b) >> 16, Q16_MAX)


def limb_ref(a: int, b: int) -> int:
    """The plain PyTorch version's limb multiply on one pair."""
    t = torch.tensor([[a, b]], dtype=torch.int64).to(torch.int32).view(torch.uint32)
    # acc = 1.0, then * a, then * b; compare against qmul(1.0, a) first
    return int(path_quality_ref(t).view(torch.int32).to(torch.int64)[0]) & 0xFFFFFFFF


def _np_qmul(a: int, b: int) -> int:
    one = lambda v: np.array([v], np.uint32)  # noqa: E731 — arrays wrap silently
    return int(pathq._qmul(np, one(a), one(b), lambda x: x)[0])


def test_limb_form_equals_one_product_at_the_edges():
    for a in EDGES + [Q16_ONE]:
        for b in EDGES + [Q16_ONE]:
            assert _np_qmul(a, b) == one_product(a, b), (a, b)
            jax_v = int(pathq_jax._qmul(np, np.array([a], np.uint32),
                                        np.array([b], np.uint32))[0])
            assert jax_v == one_product(a, b), (a, b)
            assert limb_ref(a, b) == one_product(one_product(Q16_ONE, a), b), (a, b)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, Q16_MAX), st.integers(0, Q16_MAX))
def test_limb_form_equals_one_product_random(a, b):
    assert _np_qmul(a, b) == one_product(a, b)


def _matrix(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 2**32, (n, HOPS), dtype=np.uint64).astype(np.uint32)
    r[: n // 8] = Q16_ONE  # identity rows
    r[n // 8 : n // 4] = Q16_MAX  # saturating rows
    r[n // 4 : n // 2] = rng.integers(Q16_ONE - 4000, Q16_ONE + 4000, (n // 2 - n // 4, HOPS))
    return r


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 1), (64, 2), (513, 3)])
def test_arms_equal_jax(n, seed):
    rates = _matrix(n, seed)
    want = np.asarray(pathq_jax.path_quality_host(rates))
    jax_dev = np.asarray(pathq_jax.path_quality_kernel(rates)) if n else want
    got_host = path_quality_host(rates)
    got_ref = path_quality_ref(torch.from_numpy(rates)).numpy()
    got_wrap = path_quality(torch.from_numpy(rates)).numpy()
    for got in (jax_dev, got_host, got_ref, got_wrap):
        assert got.dtype == np.uint32 and got.shape == (n,)
        np.testing.assert_array_equal(got, want)
    if n >= 64:
        assert (want[: n // 8] == Q16_ONE).all() and (want[n // 8 : n // 4] == Q16_MAX).all()


@settings(max_examples=40, deadline=None)
@given(st.lists(st.lists(st.integers(0, Q16_MAX), min_size=HOPS, max_size=HOPS),
                min_size=1, max_size=20))
def test_arms_equal_jax_random_rows(rows):
    rates = np.array(rows, dtype=np.uint32)
    want = np.asarray(pathq_jax.path_quality_host(rates))
    np.testing.assert_array_equal(path_quality_host(rates), want)
    np.testing.assert_array_equal(path_quality_ref(torch.from_numpy(rates)).numpy(), want)


def test_fold_order_is_kept():
    """The truncating shift makes the fold order-dependent; every arm
    folds the columns left to right as the JAX package does."""
    # 1 * 0.5 truncates to 0 before the * 2.0; the other way round it is 1
    row = np.array([[1, 0x8000, 0x20000] + [Q16_ONE] * 5], dtype=np.uint32)
    rev = row[:, ::-1].copy()
    fwd = path_quality_host(row)
    assert fwd[0] != path_quality_host(rev)[0]
    np.testing.assert_array_equal(fwd, pathq_jax.path_quality_host(row))
    np.testing.assert_array_equal(path_quality_ref(torch.from_numpy(row)).numpy(), fwd)


def test_wrapper_contract():
    """CPU tensors take the plain version and count no launch; a wrong
    dtype, shape or layout raises."""
    rates = torch.from_numpy(_matrix(16, 5))
    before = pathq.launches
    path_quality(rates)
    assert pathq.launches == before
    with pytest.raises(TypeError):
        path_quality(rates.view(torch.int32))
    with pytest.raises(ValueError):
        path_quality(rates[0])
    with pytest.raises(ValueError):
        path_quality(rates.t())


def test_evaluator_arms_and_counters():
    rates = _matrix(100, 6)
    want = pathq_jax.path_quality_host(rates)
    dev = make_path_evaluator(routing="device", device="cpu")
    host = make_path_evaluator(routing="host")
    for ev in (dev, host):
        np.testing.assert_array_equal(ev.evaluate(rates), want)
        assert ev.evaluate(rates[:0]).shape == (0,)
    assert dev.get_json()["device_batches"] == 1 and dev.get_json()["host_batches"] == 0
    assert host.get_json()["host_batches"] == 1 and host.get_json()["device_batches"] == 0
    assert dev.get_json()["rows_evaluated"] == 100
    np.testing.assert_array_equal(dev.evaluate_host(rates), want)


def test_evaluator_refuses_what_is_not_ported():
    # cost routing is ported: batches under the floor go to the host
    # arm, the first batch at or over it explores the device arm
    rates = _matrix(100, 6)
    want = pathq_jax.path_quality_host(rates)
    cost = PathQualityEvaluator(routing="cost", device="cpu", min_device_batch=64)
    np.testing.assert_array_equal(cost.evaluate(rates[:10]), want[:10])
    np.testing.assert_array_equal(cost.evaluate(rates), want)
    assert (cost.get_json()["host_batches"], cost.get_json()["device_batches"]) == (1, 1)
    with pytest.raises(ValueError, match="mesh="):
        PathQualityEvaluator(mesh="wide", device="cpu")
    with pytest.raises(ValueError):
        PathQualityEvaluator(routing="bogus")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_path_evaluator()  # device defaults to "cuda"
