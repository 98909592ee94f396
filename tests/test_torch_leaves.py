"""The port's core leaves against the JAX package: bitset, distances and
heuristics.

Inputs are made with numpy from a seed and handed to both packages. Bitset
words, ids, counts and branch choices must be equal bit for bit; distances
are compared with allclose at rtol 1e-6 (the two frameworks may sum in
another order). Where a sum cancels to near zero a relative bound alone is
meaningless, so signed sums (cos / dot) also get atol 1e-6 and
``dist_matrix`` atol 1e-5 (its l2 form ||q||^2 + ||x||^2 - 2 q.x cancels
for near rows and runs through a matrix product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbitset
from repro.core import distances as jdist
from repro.core import heuristics as jheur
from repro_torch.core import bitset, distances, heuristics

CPU = torch.device("cpu")
RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- bitset -------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 2500])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_pack_layout_matches_reference(n, lead):
    mask = RNG.random(lead + (n,)) < 0.4
    want = np.asarray(jbitset.pack(jnp.asarray(mask)))
    np.testing.assert_array_equal(bitset.pack_np(mask), want)
    np.testing.assert_array_equal(jbitset.pack_np(mask), want)
    words = bitset.pack(_t(mask))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(bitset.to_words(words), want)
    np.testing.assert_array_equal(bitset.unpack(words, n).numpy(), mask)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_full_mask_matches_reference(n):
    np.testing.assert_array_equal(
        bitset.to_words(bitset.full_mask(n, CPU)),
        np.asarray(jbitset.full_mask(n)))
    assert int(bitset.count(bitset.full_mask(n, CPU))) == n
    assert int(bitset.count(bitset.full_mask(n, CPU, value=False))) == 0


def test_test_and_count_match_reference():
    n = 300
    mask = RNG.random((4, n)) < 0.3
    ids = RNG.integers(-1, n, size=(4, 40)).astype(np.int32)
    jw = jbitset.pack(jnp.asarray(mask))
    tw = bitset.pack(_t(mask))
    np.testing.assert_array_equal(
        bitset.test_batch(tw, _t(ids)).numpy(),
        np.asarray(jbitset.test_batch(jw, jnp.asarray(ids))))
    np.testing.assert_array_equal(
        bitset.test(tw[1], _t(ids[1])).numpy(),
        np.asarray(jbitset.test(jw[1], jnp.asarray(ids[1]))))
    np.testing.assert_array_equal(
        bitset.count_members_batch(tw, _t(ids)).numpy(),
        np.asarray(jbitset.count_members_batch(jw, jnp.asarray(ids))))
    assert int(bitset.count_members(tw[2], _t(ids[2]))) == int(
        jbitset.count_members(jw[2], jnp.asarray(ids[2])))
    np.testing.assert_array_equal(bitset.count_batch(tw).numpy(),
                                  np.asarray(jbitset.count_batch(jw)))
    assert int(bitset.count(tw[0])) == int(jbitset.count(jw[0]))
    # bit 31 of a word (the int32 sign bit) tests like any other bit
    top = np.zeros(64, bool)
    top[[31, 63]] = True
    assert bitset.test(bitset.pack(_t(top)),
                       _t(np.array([30, 31, 63], np.int32))).tolist() == [
        False, True, True]


def test_set_bits_duplicate_safe_matches_reference():
    n = 200
    base = RNG.random(n) < 0.2
    ids = np.array([5, 5, 5, 31, 31, -1, 63, 0, 0, 199, 64, 31, -1],
                   np.int32)
    got = bitset.set_bits(bitset.pack(_t(base)), _t(ids))
    want = jbitset.set_bits(jbitset.pack(jnp.asarray(base)), jnp.asarray(ids))
    np.testing.assert_array_equal(bitset.to_words(got), np.asarray(want))
    expect = base.copy()
    expect[ids[ids >= 0]] = True
    np.testing.assert_array_equal(bitset.unpack(got, n).numpy(), expect)


def test_set_bits_batch_in_place_matches_reference():
    n = 150
    base = RNG.random((5, n)) < 0.1
    ids = RNG.integers(-1, n, size=(5, 30)).astype(np.int32)
    ids[:, 1] = ids[:, 0]                      # duplicates in every lane
    words = bitset.pack(_t(base))
    out = bitset.set_bits_batch_(words, _t(ids))
    assert out.data_ptr() == words.data_ptr()
    want = jbitset.set_bits_batch(jbitset.pack(jnp.asarray(base)),
                                  jnp.asarray(ids))
    np.testing.assert_array_equal(bitset.to_words(words), np.asarray(want))


def test_broadcast_lanes():
    w = bitset.full_mask(70, CPU)
    lanes = bitset.broadcast_lanes(w, 4)
    assert lanes.shape == (4, w.shape[0]) and lanes.stride(0) == 0
    stack = bitset.pack(_t(RNG.random((4, 70)) < 0.5))
    assert bitset.broadcast_lanes(stack, 4) is stack
    with pytest.raises(ValueError):
        bitset.broadcast_lanes(stack, 3)


# -- distances ----------------------------------------------------------------

METRICS = ["l2", "cos", "dot"]


@pytest.mark.parametrize("metric", METRICS)
def test_point_and_gathered_dist_match_reference(metric):
    tol = dict(rtol=1e-6, atol=0.0 if metric == "l2" else 1e-6)
    n, d = 64, 32
    X = RNG.normal(size=(n, d)).astype(np.float32)
    Q = RNG.normal(size=(4, d)).astype(np.float32)
    ids = RNG.integers(-1, n, size=(4, 9)).astype(np.int32)
    np.testing.assert_allclose(
        distances.point_dist(_t(Q[0]), _t(X), metric).numpy(),
        np.asarray(jdist.point_dist(jnp.asarray(Q[0]), jnp.asarray(X),
                                    metric)), **tol)
    got = distances.gathered_dist(_t(Q[1]), _t(X), _t(ids[1]), metric).numpy()
    want = np.asarray(jdist.gathered_dist(jnp.asarray(Q[1]), jnp.asarray(X),
                                          jnp.asarray(ids[1]), metric))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, **tol)
    got = distances.gathered_dist_batch(_t(Q), _t(X), _t(ids), metric).numpy()
    want = np.asarray(jdist.gathered_dist_batch(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(ids), metric))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("metric", METRICS)
def test_dist_matrix_and_normalize_match_reference(metric):
    X = RNG.normal(size=(50, 32)).astype(np.float32)
    Q = RNG.normal(size=(6, 32)).astype(np.float32)
    np.testing.assert_allclose(
        distances.dist_matrix(_t(Q), _t(X), metric).numpy(),
        np.asarray(jdist.dist_matrix(jnp.asarray(Q), jnp.asarray(X), metric)),
        rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        distances.normalize(_t(X)).numpy(),
        np.asarray(jdist.normalize(jnp.asarray(X))), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_brute_force_topk_tie_order_matches_reference(masked):
    """Duplicated rows give exact distance ties; both packages must order
    them lower index first (lax.top_k's order, a stable sort in torch)."""
    base = RNG.normal(size=(20, 16)).astype(np.float32)
    X = np.concatenate([base, base, base[:5]])          # every row tied
    Q = RNG.normal(size=(5, 16)).astype(np.float32)
    mask = RNG.random(len(X)) < 0.7 if masked else None
    k = 12
    td, ti = distances.brute_force_topk(
        _t(Q), _t(X), k, "dot", mask=None if mask is None else _t(mask))
    jd, ji = jdist.brute_force_topk(
        jnp.asarray(Q), jnp.asarray(X), k, "dot",
        mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_brute_force_pads_short_selections():
    X = RNG.normal(size=(30, 8)).astype(np.float32)
    mask = np.zeros(30, bool)
    mask[[3, 17]] = True
    d, ids = distances.brute_force_topk(_t(X[:2]), _t(X), 5, "l2",
                                        mask=_t(mask))
    assert ids.dtype == torch.int32
    assert sorted(ids[0, :2].tolist()) == [3, 17]
    assert ids[:, 2:].eq(-1).all() and torch.isinf(d[:, 2:]).all()


def test_validate_metric():
    distances.validate_metric("cos")
    with pytest.raises(ValueError):
        distances.validate_metric("hamming")


# -- heuristics -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["onehop_s", "onehop-a", "directed", "blind",
                                  "adaptive_g", "adaptive_global",
                                  "adaptive_l", "ADAPTIVE_LOCAL", "navix"])
def test_from_name_matches_reference(name):
    assert int(heuristics.Heuristic.from_name(name)) == int(
        jheur.Heuristic.from_name(name))


@pytest.mark.parametrize("m", [8, 16, 64])
def test_adaptive_rule_matches_reference(m):
    # a grid plus the exact boundaries of both decisions
    sigma = np.concatenate([
        np.linspace(0.0, 1.0, 201),
        [0.5, np.nextafter(0.5, 0.0), 3.0 / (m + 1),
         np.nextafter(3.0 / (m + 1), 0.0), 1.0 / m]]).astype(np.float32)
    got = heuristics.adaptive_rule(_t(sigma), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jheur.adaptive_rule(jnp.asarray(sigma), m)))
    assert heuristics.UB_ONEHOP_S == jheur.UB_ONEHOP_S
    assert heuristics.LENIENCY_FACTOR == jheur.LENIENCY_FACTOR
