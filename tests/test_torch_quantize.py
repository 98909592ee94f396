"""The port's int8 leaves against the JAX package: ``quantize``,
``dequantize``, ``rerank(_many)``, the host ``ExactTier`` and the plain
int8 gather-distance.

Inputs are made with numpy from a seed and handed to both packages. Codes,
scales, dequantized rows and ids must be equal bit for bit; the exact tier
is numpy in both packages, so its distances must be equal too. Distances
that torch and XLA sum in another order are compared at rtol 1e-5 /
atol 1e-5 (the tolerance of ``tests/test_torch_kernels.py``), with +inf at
exactly the same places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jdist
from repro.core import quantize as jq
from repro.kernels import ref as jref
from repro.kernels.gather_distance import (
    quantized_gather_distance_batch_pallas, quantized_gather_distance_pallas)
from repro.storage.columnar import ExactTier as JExactTier
from repro_torch.core import distances as tdist
from repro_torch.core import quantize as tq
from repro_torch.kernels import ops, ref
from repro_torch.storage.columnar import ExactTier

METRICS = ["l2", "cos", "dot"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _rows(n, d, seed):
    """Random rows at several magnitudes, one all-zero row (scale 1) and two
    rows whose codes fall on exact .5 ties (scale 1 and scale 2)."""
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d))
         * rng.choice([1e-3, 1.0, 40.0], size=(n, 1))).astype(np.float32)
    X[1] = 0.0
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5],
                    np.float32)
    X[2] = np.resize(ties, d)
    X[3] = 2.0 * X[2]
    return X


def _check(got: np.ndarray, want: np.ndarray):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("n,d", [(50, 8), (300, 32), (64, 33)])
def test_quantize_is_bitwise_the_reference(n, d):
    X = _rows(n, d, seed=n + d)
    got = tq.quantize(torch.from_numpy(X))
    want = jq.quantize(jnp.asarray(X))
    assert got.codes.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale[1] == 1.0 and int(got.codes[1].abs().sum()) == 0
    # the .5 ties round half to even
    assert got.codes[2, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126][:d]
    np.testing.assert_array_equal(
        tq.dequantize(got).numpy(), np.asarray(jq.dequantize(want)))
    assert got.n == n and tuple(got.shape) == (n, d)
    assert got.nbytes() == np.asarray(want.codes).size + 4 * n == want.nbytes()
    assert got.device == torch.device("cpu")
    assert got.to(torch.device("cpu")).codes.data_ptr() == got.codes.data_ptr()


def _rerank_inputs(metric):
    rng = np.random.default_rng(METRICS.index(metric))
    X = rng.normal(size=(20, 8)).astype(np.float32)
    if metric == "cos":
        X /= np.linalg.norm(X, axis=1, keepdims=True)
    Q = rng.normal(size=(3, 8)).astype(np.float32)
    ids = np.array([[3, 3, -1, 7, 7, 7, -1, 2],        # the reference test's
                    [-1, -1, -1, -1, -1, -1, -1, -1],  # a lane with no ids
                    [19, 0, 5, 5, 11, 12, 0, 25]],     # an id >= n
                   np.int32)
    return X, Q, ids


@pytest.mark.parametrize("store", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_rerank_matches_reference(metric, store):
    X, Q, ids = _rerank_inputs(metric)
    jv = jq.quantize(jnp.asarray(X)) if store else jnp.asarray(X)
    tv = tq.quantize(torch.from_numpy(X)) if store else torch.from_numpy(X)
    for k in (1, 6, 8):
        dm, im = tq.rerank_many(torch.from_numpy(Q), tv, torch.from_numpy(ids),
                                k, metric)
        jd, ji = jq.rerank_many(jnp.asarray(Q), jv, jnp.asarray(ids), k,
                                metric)
        np.testing.assert_array_equal(im.numpy(), np.asarray(ji))
        _check(dm.numpy(), np.asarray(jd))
        for lane in range(len(Q)):
            d1, i1 = tq.rerank(torch.from_numpy(Q[lane]), tv,
                               torch.from_numpy(ids[lane]), k, metric)
            assert torch.equal(i1, im[lane]) and torch.equal(d1, dm[lane])
            jd1, ji1 = jq.rerank(jnp.asarray(Q[lane]), jv,
                                 jnp.asarray(ids[lane]), k, metric)
            np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    # padding never surfaces and duplicates count once
    d, out = tq.rerank(torch.from_numpy(Q[0]), tv, torch.from_numpy(ids[0]),
                       6, metric)
    assert sorted(out[out >= 0].tolist()) == [2, 3, 7]
    assert torch.isinf(d[3:]).all() and (out[3:] == -1).all()


def test_rerank_refuses_k_above_the_beam():
    X, Q, ids = _rerank_inputs("l2")
    with pytest.raises(ValueError, match="exceeds"):
        tq.rerank(torch.from_numpy(Q[0]), torch.from_numpy(X),
                  torch.from_numpy(ids[0]), 9, "l2")


@pytest.mark.parametrize("mmap", [False, True], ids=["memory", "mmap"])
@pytest.mark.parametrize("metric", METRICS)
def test_exact_tier_matches_reference(metric, mmap, tmp_path):
    X, Q, ids = _rerank_inputs(metric)
    path = (lambda name: tmp_path / name) if mmap else (lambda name: None)
    tier = ExactTier.build(X, metric, mmap_path=path("port.f32"))
    jtier = JExactTier.build(X, metric, mmap_path=path("ref.f32"))
    assert tier.is_mmapped == jtier.is_mmapped == mmap
    assert (tier.n, tier.dim, tier.nbytes()) == (jtier.n, jtier.dim,
                                                 jtier.nbytes())
    ids = np.where(ids >= X.shape[0], X.shape[0] - 1, ids)   # valid rows
    for k in (1, 5, 8, 11):                                   # 11 > w pads
        d, i = tier.rerank_many(Q, ids, k)
        jd, ji = jtier.rerank_many(Q, ids, k)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(d, jd)
        assert i.shape == (len(Q), k) and i.dtype == np.int32
        d1, i1 = tier.rerank(Q[2], ids[2], k)
        np.testing.assert_array_equal(i1, i[2])
        np.testing.assert_array_equal(d1, d[2])


def _gather_case(b, n, d, k):
    X = _rows(n, d, seed=b + n + d + k)
    store = jq.quantize(jnp.asarray(X))
    codes, scale = np.asarray(store.codes), np.asarray(store.scale)
    rng = np.random.default_rng(b * n + d * k)
    Q = rng.normal(size=(b, d)).astype(np.float32)
    ids = rng.integers(-1, n + 3, size=(b, k)).astype(np.int32)
    ids[0] = -1                                  # a fully retired lane
    ids[1, 0] = 1                                # the all-zero row
    return Q, codes, scale, ids


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,n,d,k", [(4, 64, 128, 7), (8, 128, 32, 16),
                                     (3, 100, 33, 5)])
def test_plain_int8_matches_reference_oracle(metric, b, n, d, k):
    Q, codes, scale, ids = _gather_case(b, n, d, k)
    got = ref.quantized_gather_distance_batch(*_t(Q, codes, scale, ids),
                                              metric)
    assert got.dtype == torch.float32 and got.shape == (b, k)
    clipped = jnp.asarray(np.clip(ids, -1, n - 1))
    _check(got.numpy(), np.asarray(jref.quantized_gather_distance_batch(
        jnp.asarray(Q), jnp.asarray(codes), jnp.asarray(scale), clipped,
        metric)))
    one = ref.quantized_gather_distance(*_t(Q[2], codes, scale, ids[2]),
                                        metric)
    assert torch.equal(one, got[2])
    _check(one.numpy(), np.asarray(jref.quantized_gather_distance(
        jnp.asarray(Q[2]), jnp.asarray(codes), jnp.asarray(scale),
        clipped[2], metric)))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,n,d,k", [(4, 64, 128, 7), (2, 100, 256, 5)])
def test_plain_int8_matches_pallas_interpret(metric, b, n, d, k):
    Q, codes, scale, ids = _gather_case(b, n, d, k)
    tQ, tc, ts, ti = _t(Q, codes, scale, ids)
    got = ops.quantized_gather_distance_batch(tQ, tc, ts, ti, metric)
    _check(got.numpy(), np.asarray(quantized_gather_distance_batch_pallas(
        jnp.asarray(Q), jnp.asarray(codes), jnp.asarray(scale),
        jnp.asarray(ids), metric, interpret=True)))
    one = ops.quantized_gather_distance(tQ[1], tc, ts, ti[1], metric)
    _check(one.numpy(), np.asarray(quantized_gather_distance_pallas(
        jnp.asarray(Q[1]), jnp.asarray(codes), jnp.asarray(scale),
        jnp.asarray(ids[1]), metric, interpret=True)))


@pytest.mark.parametrize("metric", METRICS)
def test_gathered_dist_over_a_store_matches_reference(metric):
    """``gather_rows`` dequantizes per gathered row, bit for bit as the
    reference does, and the distances follow."""
    X = _rows(40, 16, seed=11)
    store, jstore = tq.quantize(torch.from_numpy(X)), jq.quantize(
        jnp.asarray(X))
    rng = np.random.default_rng(12)
    ids = rng.integers(-1, 40, size=(3, 9)).astype(np.int32)
    safe = np.maximum(ids, 0)
    np.testing.assert_array_equal(
        tdist.gather_rows(store, torch.from_numpy(safe)).numpy(),
        np.asarray(jdist.gather_rows(jstore, jnp.asarray(safe))))
    Q = rng.normal(size=(3, 16)).astype(np.float32)
    got = tdist.gathered_dist_batch(torch.from_numpy(Q), store,
                                    torch.from_numpy(ids), metric)
    want = np.asarray(jdist.gathered_dist_batch(
        jnp.asarray(Q), jstore, jnp.asarray(ids), metric))
    # these rows reach |x| = 254, so their sums cancel: the two frameworks'
    # summation orders may differ by an ulp of the largest partial sum, so
    # the bound is 1e-5 of the summed |terms|
    rows = np.asarray(jdist.gather_rows(jstore, jnp.asarray(safe)))
    terms = (rows - Q[:, None]) ** 2 if metric == "l2" else rows * Q[:, None]
    mag = np.abs(terms).sum(-1)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    assert (np.abs(got.numpy()[fin] - want[fin]) <= 1e-5 * mag[fin]).all()
    one = tdist.gathered_dist(torch.from_numpy(Q[0]), store,
                              torch.from_numpy(ids[0]), metric)
    assert torch.equal(one, got[0])
