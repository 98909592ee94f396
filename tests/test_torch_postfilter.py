"""The port's postfilter baseline (paper Section 5.7) against the JAX
package's, and the port's engine selection: the vmap oracle against the
batched-frontier engine.

The JAX index (``conftest.index``: 2500 x 32) is carried across with
``graph_from_numpy``; both packages get the same queries and masks.
Postfilter ids and every ``PostfilterStats`` field must be equal, dists
allclose at rtol 1e-5 (XLA and torch may sum in another order). Inside the
port, ``engine="vmap"`` (one single-query search a lane) must equal
``engine="batched"`` lane for lane, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import postfilter as jpf
from repro.core import search_batch as jsb
from repro_torch.core import bitset
from repro_torch.core import postfilter as tpf
from repro_torch.core import search as tsearch
from repro_torch.core import search_batch as tsb
from repro_torch.core.graph import FIELDS, graph_from_numpy
from repro_torch.core.heuristics import Heuristic
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.core.search import SearchParams

CPU = torch.device("cpu")
HEURISTICS = ["onehop_s", "directed", "blind", "adaptive_g",
              "adaptive_local", "onehop_a"]


@pytest.fixture(scope="module")
def port_index(index):
    g = graph_from_numpy({f: np.asarray(getattr(index.graph, f))
                          for f in FIELDS}, device="cpu")
    return NavixIndex.from_graph(g, NavixConfig(**index.config._asdict()),
                                 device="cpu")


def _assert_postfilter_equal(port, ref):
    (pd, pi, ps), (rd, ri, rs) = port, ref
    np.testing.assert_array_equal(pi, np.asarray(ri))
    assert pi.dtype == np.asarray(ri).dtype
    np.testing.assert_allclose(pd, np.asarray(rd), rtol=1e-5)
    assert type(ps).__name__ == type(rs).__name__
    assert ps._fields == rs._fields
    assert tuple(ps) == tuple(int(x) for x in rs), (ps, rs)


@pytest.mark.parametrize("sigma", [0.9, 0.5, 0.2, 0.05])
@pytest.mark.parametrize("qi", [0, 5])
def test_search_postfilter_matches_reference(index, port_index, queries,
                                             sigma, qi):
    mask = np.random.default_rng(11 + qi).random(index.graph.n) < sigma
    port = port_index.search_postfilter(queries[qi], k=10, semimask=mask)
    ref = index.search_postfilter(queries[qi], k=10, semimask=mask)
    _assert_postfilter_equal(port, ref)
    ids = port[1]
    assert mask[ids[ids >= 0]].all()          # every survivor is in S
    if sigma >= 0.2:
        assert (ids >= 0).sum() == 10


@pytest.mark.parametrize("n_selected", [0, 3])
def test_postfilter_reaching_max_efs_matches_reference(index, port_index,
                                                       queries, n_selected):
    """Fewer than k reachable survivors: the stream runs to ``max_efs``
    and the result is -1 padded, in both packages."""
    mask = np.zeros(index.graph.n, bool)
    mask[np.random.default_rng(3).choice(index.graph.n, n_selected,
                                         replace=False)] = True
    words = bitset.pack_np(mask)
    port = tpf.postfilter_search(port_index.graph,
                                 torch.from_numpy(queries[1]),
                                 bitset.from_words(words, CPU), k=10,
                                 max_efs=256)
    ref = jpf.postfilter_search(index.graph, jnp.asarray(queries[1]),
                                jnp.asarray(words), k=10, max_efs=256)
    _assert_postfilter_equal(port, ref)
    assert port[2].final_efs == 256 and port[2].restarts == 3
    assert (port[1] < 0).sum() >= 10 - n_selected


def test_postfilter_degrades_with_selectivity(port_index, queries):
    """Section 5.7: lower selectivity => more streamed tuples verified."""
    rng = np.random.default_rng(6)
    n = port_index.graph.n
    v_hi = v_lo = 0
    for q in queries[:4]:
        v_hi += port_index.search_postfilter(
            q, k=10, semimask=rng.random(n) < 0.8)[2].verifications
        v_lo += port_index.search_postfilter(
            q, k=10, semimask=rng.random(n) < 0.05)[2].verifications
    assert v_lo > 2 * v_hi, (v_lo, v_hi)


def _masks(n, sigma, lanes, seed):
    return np.random.default_rng(seed).random((lanes, n)) < sigma


def _assert_lanes_equal(a, b):
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.dists, b.dists)
    for f in a.stats._fields:
        x, y = getattr(a.stats, f), getattr(b.stats, f)
        assert x.dtype == y.dtype == torch.int32, f
        assert x.shape == y.shape, f
        assert torch.equal(x, y), f


@pytest.mark.parametrize("lanes", ["shared", "per_lane"])
@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_vmap_engine_equals_batched_engine(port_index, queries, heuristic,
                                           lanes):
    n = port_index.graph.n
    masks = _masks(n, 0.15, 6, seed=4)
    semimask = masks[0] if lanes == "shared" else list(masks)
    kw = dict(k=10, efs=40, semimask=semimask, heuristic=heuristic)
    vmap = port_index.search_many(queries[:6], engine="vmap", **kw)
    batched = port_index.search_many(queries[:6], engine="batched", **kw)
    _assert_lanes_equal(vmap, batched)
    assert vmap.ids.shape == (6, 10) and vmap.stats.picks.shape == (6, 3)


@pytest.mark.parametrize("sigma_g", ["scalar", "per_lane"])
def test_vmap_oracle_takes_scalar_and_per_lane_sigma(port_index, queries,
                                                     sigma_g):
    """ADAPTIVE_GLOBAL reads sigma_g: a scalar for every lane or one per
    lane, alike in both engines."""
    g = port_index.graph
    Q = torch.from_numpy(queries[:5])
    sel = bitset.from_words(bitset.pack_np(_masks(g.n, 0.3, 5, seed=9)), CPU)
    sig = (0.004 if sigma_g == "scalar"
           else torch.tensor([0.9, 0.004, 0.2, 0.05, 0.6]))
    params = SearchParams(k=10, efs=40,
                          heuristic=int(Heuristic.ADAPTIVE_GLOBAL))
    vmap = tsearch.search_batch(g, Q, sel, params, sigma_g=sig)
    _assert_lanes_equal(vmap, tsb.search_many(g, Q, sel, params,
                                              sigma_g=sig))
    for i in range(len(Q)):
        one = tsearch.search(g, Q[i], sel[i], params,
                             sigma_g=sig if sigma_g == "scalar" else sig[i])
        assert torch.equal(one.ids, vmap.ids[i])


def test_quantized_engines_agree(port_index, queries):
    masks = list(_masks(port_index.graph.n, 0.3, 4, seed=8))
    kw = dict(k=10, efs=40, semimask=masks)
    _assert_lanes_equal(
        port_index.search_quantized_many(queries[:4], engine="vmap", **kw),
        port_index.search_quantized_many(queries[:4], engine="batched",
                                         **kw))


def test_engine_registry_matches_reference():
    assert tuple(tsb.BATCH_ENGINES) == tuple(jsb.BATCH_ENGINES)
    assert tsb.resolve_engine("batched") is tsb.search_many
    assert tsb.resolve_engine("vmap") is tsearch.search_batch
    with pytest.raises(ValueError) as ref:
        jsb.resolve_engine("bacthed")
    with pytest.raises(ValueError) as port:
        tsb.resolve_engine("bacthed")
    assert str(port.value) == str(ref.value)


def test_navix_index_rejects_unknown_engine(port_index, queries):
    for fn in (port_index.search_many, port_index.search_quantized_many):
        with pytest.raises(ValueError, match="unknown engine"):
            fn(queries[:2], k=5, engine="jit")
