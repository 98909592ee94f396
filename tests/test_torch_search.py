"""Port search against the JAX package, and the port's two engines
against each other.

The JAX index (``conftest.index``: 2500 x 32, m_u=8, efc=64) is carried
across with ``graph_from_numpy``; both packages get the same queries and
the same packed semimasks. Against the reference, result ids and every
``SearchStats`` field must be equal and dists allclose at rtol 1e-5 (XLA
and torch may sum in another order). Inside the port the batched engine
must equal the single-query search lane for lane, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bitset as jbitset
from repro.core import search_batch as jsb
from repro_torch.core import bitset
from repro_torch.core import search as tsearch
from repro_torch.core import search_batch as tsb
from repro_torch.core.graph import FIELDS, graph_from_numpy
from repro_torch.core.heuristics import Heuristic
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.core.search import SearchParams

HEURISTICS = ["onehop_s", "directed", "blind", "adaptive_g",
              "adaptive_local", "onehop_a"]
SIGMAS = [0.01, 0.1, 0.5, 1.0]
K, EFS = 10, 40


@pytest.fixture(scope="module")
def port_index(index):
    g = graph_from_numpy({f: np.asarray(getattr(index.graph, f))
                          for f in FIELDS}, device="cpu")
    return NavixIndex.from_graph(g, NavixConfig(**index.config._asdict()),
                                 device="cpu")


def _masks(n, sigma, lanes, seed):
    """bool[lanes, n] selections at ``sigma`` (all True at sigma 1.0)."""
    if sigma >= 1.0:
        return np.ones((lanes, n), bool)
    return np.random.default_rng(seed).random((lanes, n)) < sigma


def _words(mask):
    return jbitset.pack_np(mask)


def _params(heuristic):
    return int(Heuristic.from_name(heuristic))


def _assert_matches_reference(port, ref):
    np.testing.assert_array_equal(port.ids.numpy(), np.asarray(ref.ids))
    for f in ref.stats._fields:
        np.testing.assert_array_equal(getattr(port.stats, f).numpy(),
                                      np.asarray(getattr(ref.stats, f)),
                                      err_msg=f"stats.{f}")
    np.testing.assert_allclose(port.dists.numpy(), np.asarray(ref.dists),
                               rtol=1e-5)


@pytest.mark.parametrize("lanes", ["shared", "per_lane"])
@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_search_many_matches_reference(index, port_index, queries, heuristic,
                                       sigma, lanes):
    n, bsz = index.graph.n, len(queries)
    if lanes == "shared":
        words = _words(_masks(n, sigma, 1, seed=3)[0])
        sigma_g = t_sigma = int(jbitset.count(jnp.asarray(words))) / n
    else:
        words = _words(_masks(n, sigma, bsz, seed=4))
        sigma_g = np.asarray(jbitset.count_batch(jnp.asarray(words)),
                             np.float32) / np.float32(n)
        t_sigma = torch.from_numpy(sigma_g)
    h = _params(heuristic)
    ref = jsb.search_many(index.graph, jnp.asarray(queries),
                          jnp.asarray(words),
                          index._params(K, EFS, h), sigma_g=sigma_g)
    port = tsb.search_many(port_index.graph, torch.from_numpy(queries),
                           bitset.from_words(words, torch.device("cpu")),
                           SearchParams(k=K, efs=EFS, heuristic=h),
                           sigma_g=t_sigma)
    _assert_matches_reference(port, ref)


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_batched_equals_single_query_bitwise(port_index, queries, heuristic,
                                             sigma):
    g = port_index.graph
    Q = torch.from_numpy(queries[:6])
    sel = bitset.from_words(_words(_masks(g.n, sigma, len(Q), seed=5)),
                            torch.device("cpu"))
    params = SearchParams(k=K, efs=EFS, heuristic=_params(heuristic))
    many = tsb.search_many(g, Q, sel, params)
    for i in range(len(Q)):
        one = tsearch.search(g, Q[i], sel[i], params)
        assert torch.equal(one.ids, many.ids[i]), f"lane {i} ids"
        assert torch.equal(one.dists, many.dists[i]), f"lane {i} dists"
        for f in one.stats._fields:
            assert torch.equal(getattr(one.stats, f),
                               getattr(many.stats, f)[i]), f"lane {i} {f}"


@pytest.mark.parametrize("sigma", SIGMAS)
def test_navix_index_search_many_matches_reference(index, port_index,
                                                   queries, sigma):
    mask = _masks(index.graph.n, sigma, 1, seed=6)[0]
    ref = index.search_many(queries, k=K, semimask=mask)
    port = port_index.search_many(queries, k=K, semimask=mask)
    _assert_matches_reference(port, ref)
    # a per-lane list of masks takes the per-lane path in both packages
    masks = list(_masks(index.graph.n, sigma, len(queries), seed=7))
    _assert_matches_reference(port_index.search_many(queries, k=K,
                                                     semimask=masks),
                              index.search_many(queries, k=K, semimask=masks))


def test_navix_index_single_search_matches_reference(index, port_index,
                                                     queries):
    mask = _masks(index.graph.n, 0.2, 1, seed=8)[0]
    for q in queries[:3]:
        _assert_matches_reference(port_index.search(q, k=K, semimask=mask),
                                  index.search(q, k=K, semimask=mask))


def test_result_types(port_index, queries):
    res = port_index.search_many(queries[:2], k=K)
    assert res.ids.dtype == torch.int32 and res.dists.dtype == torch.float32
    assert res.ids.shape == (2, K)
    for f in res.stats._fields:
        assert getattr(res.stats, f).dtype == torch.int32, f
    # the recall oracle agrees with itself
    _, true_ids = port_index.brute_force(queries[:2], k=K)
    assert port_index.recall(true_ids, true_ids) == 1.0
