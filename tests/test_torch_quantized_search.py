"""The port's int8-resident search against the JAX package, and its two
engines against each other.

The JAX index (``conftest.index``: 2500 x 32, m_u=8, efc=64) is carried
across with ``graph_from_numpy(..., device="cpu")`` and made int8-resident
with the port's own ``quantize_resident()``; both packages get the same
queries and semimasks. Against the reference, result ids and every
``SearchStats`` field must be equal and dists allclose at rtol 1e-5. Inside
the port the batched engine must equal the single-query search lane for
lane, bit for bit. The residency checks mirror
``tests/test_quantized_resident.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.quantize import QuantizedStore as JQuantizedStore
from repro_torch.core import navix as tnavix
from repro_torch.core import quantize as tq
from repro_torch.core.graph import FIELDS, graph_from_numpy
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.core.quantize import QuantizedStore
from repro_torch.kernels import gather_distance, quantized_gather_distance
from repro_torch.storage.columnar import ExactTier

HEURISTICS = ["onehop_s", "directed", "blind", "adaptive_g",
              "adaptive_local", "onehop_a"]
SIGMAS = [0.01, 0.1, 0.5, 1.0]
K, EFS = 10, 40
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def port_index(index):
    g = graph_from_numpy({f: np.asarray(getattr(index.graph, f))
                          for f in FIELDS}, device="cpu")
    return NavixIndex.from_graph(g, NavixConfig(**index.config._asdict()),
                                 device="cpu")


@pytest.fixture(scope="module")
def port_q(port_index):
    return port_index.quantize_resident()


def _masks(n, sigma, lanes, seed):
    """bool[lanes, n] selections at ``sigma`` (all True at sigma 1.0)."""
    if sigma >= 1.0:
        return np.ones((lanes, n), bool)
    return np.random.default_rng(seed).random((lanes, n)) < sigma


def _assert_matches_reference(port, ref):
    np.testing.assert_array_equal(port.ids.numpy(), np.asarray(ref.ids))
    for f in ref.stats._fields:
        np.testing.assert_array_equal(getattr(port.stats, f).numpy(),
                                      np.asarray(getattr(ref.stats, f)),
                                      err_msg=f"stats.{f}")
    np.testing.assert_allclose(port.dists.numpy(), np.asarray(ref.dists),
                               rtol=1e-5)


def _assert_same(one, many, i):
    assert torch.equal(one.ids, many.ids[i]), f"lane {i} ids"
    assert torch.equal(one.dists, many.dists[i]), f"lane {i} dists"
    for f in one.stats._fields:
        assert torch.equal(getattr(one.stats, f),
                           getattr(many.stats, f)[i]), f"lane {i} {f}"


@pytest.mark.parametrize("lanes", ["shared", "per_lane"])
@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_search_quantized_many_matches_reference(index, port_q, queries,
                                                 heuristic, sigma, lanes):
    n = index.graph.n
    if lanes == "shared":
        mask = _masks(n, sigma, 1, seed=3)[0]
    else:
        mask = list(_masks(n, sigma, len(queries), seed=4))
    ref = index.search_quantized_many(queries, k=K, efs=EFS, semimask=mask,
                                      heuristic=heuristic)
    port = port_q.search_quantized_many(queries, k=K, efs=EFS, semimask=mask,
                                        heuristic=heuristic)
    _assert_matches_reference(port, ref)


@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_search_quantized_matches_reference(index, port_index, queries,
                                            heuristic):
    """The single-query form, here through the f32 index's cached int8
    sibling (as the reference's ``_quantized_view``)."""
    mask = _masks(index.graph.n, 0.2, 1, seed=8)[0]
    for q in queries[:2]:
        _assert_matches_reference(
            port_index.search_quantized(q, k=K, efs=EFS, semimask=mask,
                                        heuristic=heuristic),
            index.search_quantized(q, k=K, efs=EFS, semimask=mask,
                                   heuristic=heuristic))
    assert port_index._quantized_view() is port_index._quantized_view()


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_batched_equals_single_query_bitwise(port_q, queries, heuristic,
                                             sigma):
    masks = list(_masks(port_q.graph.n, sigma, 6, seed=5))
    many = port_q.search_quantized_many(queries[:6], k=K, efs=EFS,
                                        semimask=masks, heuristic=heuristic)
    for i in range(6):
        one = port_q.search_quantized(queries[i], k=K, efs=EFS,
                                      semimask=masks[i], heuristic=heuristic)
        _assert_same(one, many, i)


# -- residency ------------------------------------------------------------

def test_quantize_resident_residency(port_index, port_q):
    assert not port_index.is_quantized and port_q.is_quantized
    assert port_q.quantize_resident() is port_q
    store = port_q.graph.vectors
    assert isinstance(store, QuantizedStore)
    assert store.codes.dtype == torch.int8 and store.codes.device == CPU
    assert (port_q.graph.n, port_q.graph.dim) == (port_index.graph.n,
                                                  port_index.graph.dim)
    assert port_q.device == CPU and port_q.graph.device == CPU
    assert isinstance(port_q.exact, ExactTier) and not port_q.exact.is_mmapped
    np.testing.assert_array_equal(port_q.exact.vectors,
                                  port_index.graph.vectors.numpy())
    # int8 codes + f32 scales: (d + 4) bytes per row against 4d
    n, d = port_index.graph.n, port_index.graph.dim
    f32_bytes = port_index.graph.vector_nbytes()
    q_bytes = port_q.graph.vector_nbytes()
    assert f32_bytes == 4 * n * d and q_bytes == n * d + 4 * n
    assert q_bytes / f32_bytes == pytest.approx((d + 4) / (4 * d))
    assert (port_index.graph.nbytes() - port_q.graph.nbytes()
            == f32_bytes - q_bytes)
    moved = port_q.graph.to(CPU)
    assert isinstance(moved.vectors, QuantizedStore)
    assert torch.equal(moved.vectors.codes, store.codes)


def test_quantized_store_carries_across_from_the_reference(index, port_q):
    """A reference int8-resident graph carries over with its codes and
    scales as a pair, and equals the port's own quantization."""
    jq = index.quantize_resident()
    assert isinstance(jq.graph.vectors, JQuantizedStore)
    arrays = {f: np.asarray(getattr(jq.graph, f)) for f in FIELDS
              if f != "vectors"}
    arrays["vectors"] = {"codes": np.asarray(jq.graph.vectors.codes),
                         "scale": np.asarray(jq.graph.vectors.scale)}
    g = graph_from_numpy(arrays, device="cpu")
    assert isinstance(g.vectors, QuantizedStore)
    assert torch.equal(g.vectors.codes, port_q.graph.vectors.codes)
    assert torch.equal(g.vectors.scale, port_q.graph.vectors.scale)
    assert g.vector_nbytes() == jq.graph.vector_nbytes()
    assert g.nbytes() == jq.graph.nbytes()
    # without an exact tier the brute-force oracle dequantizes the codes
    bare = NavixIndex.from_graph(g, port_q.config, device="cpu")
    assert bare.is_quantized and bare.exact is None
    _, ids = bare.brute_force(np.zeros((1, g.dim), np.float32), k=3)
    assert ids.shape == (1, 3)


def test_no_dequantize_anywhere_in_search(monkeypatch, port_index, queries):
    """Quantized search never dequantizes the whole store: the beam loop
    gathers codes + scales per candidate."""
    calls = []
    orig = tq.dequantize

    def spy(store):
        calls.append(store)
        return orig(store)

    monkeypatch.setattr(tq, "dequantize", spy)
    monkeypatch.setattr(tnavix, "dequantize", spy)
    idx = NavixIndex.from_graph(port_index.graph, port_index.config,
                                device="cpu")
    f32_before = gather_distance.LAUNCHES + gather_distance.ONE_LANE_LAUNCHES
    int8_before = (quantized_gather_distance.LAUNCHES
                   + quantized_gather_distance.ONE_LANE_LAUNCHES)
    idx.search_quantized(queries[0], k=10, efs=40)
    idx.search_quantized(queries[1], k=10, efs=40)
    idx.search_quantized_many(queries[:4], k=10, efs=40)
    idx.search_quantized_many(queries[:4], k=10, efs=40)
    assert calls == []
    # CPU tensors run the plain versions: no kernel launches at all
    assert (gather_distance.LAUNCHES + gather_distance.ONE_LANE_LAUNCHES
            == f32_before)
    assert (quantized_gather_distance.LAUNCHES
            + quantized_gather_distance.ONE_LANE_LAUNCHES == int8_before)


def test_quantized_recall_within_rerank_floor(port_index, port_q, queries):
    """After the exact re-rank, int8 recall@k sits within 0.02 of the f32
    engine at the same efs (paper Section 5.8)."""
    k, efs = 10, 80
    _, true_ids = port_index.brute_force(queries, k=k)
    f32 = port_index.search_many(queries, k=k, efs=efs)
    q8 = port_q.search_quantized_many(queries, k=k, efs=efs)
    r_f32 = port_index.recall(f32.ids, true_ids)
    r_q8 = port_index.recall(q8.ids, true_ids)
    assert r_q8 >= r_f32 - 0.02, (r_q8, r_f32)


def test_search_on_quantized_resident_index(index, port_index, port_q,
                                            queries):
    """search()/search_many() run directly on an int8-resident index, as in
    the reference; without the re-rank some recall is lost."""
    mask = _masks(index.graph.n, 0.5, 1, seed=9)[0]
    jq = index.quantize_resident()
    _assert_matches_reference(
        port_q.search_many(queries, k=10, efs=80, semimask=mask),
        jq.search_many(queries, k=10, efs=80, semimask=mask))
    _assert_matches_reference(
        port_q.search(queries[0], k=10, efs=80, semimask=mask),
        jq.search(queries[0], k=10, efs=80, semimask=mask))
    _, true_ids = port_index.brute_force(queries, k=10)
    rec = port_index.recall(port_q.search_many(queries, k=10, efs=80).ids,
                            true_ids)
    rec_f32 = port_index.recall(
        port_index.search_many(queries, k=10, efs=80).ids, true_ids)
    assert rec >= rec_f32 - 0.10


def test_brute_force_on_quantized_index_uses_exact_tier(port_index, port_q,
                                                        queries):
    d0, i0 = port_index.brute_force(queries[:4], k=7)
    d1, i1 = port_q.brute_force(queries[:4], k=7)
    assert torch.equal(i0, i1)
    assert torch.equal(d0, d1)


def test_memmap_tier_matches_in_memory(port_index, queries, tmp_path):
    q_mem = port_index.quantize_resident()
    q_disk = port_index.quantize_resident(mmap_path=tmp_path / "vectors.f32")
    assert q_disk.exact.is_mmapped and not q_mem.exact.is_mmapped
    rm = q_mem.search_quantized_many(queries, k=8, efs=48)
    rd = q_disk.search_quantized_many(queries, k=8, efs=48)
    assert torch.equal(rm.ids, rd.ids) and torch.equal(rm.dists, rd.dists)
    _, i_disk = q_disk.brute_force(queries[:2], k=5)
    assert torch.equal(i_disk, port_index.brute_force(queries[:2], k=5)[1])


def test_result_types(port_q, queries):
    res = port_q.search_quantized_many(queries[:2], k=K)
    assert res.ids.dtype == torch.int32 and res.dists.dtype == torch.float32
    assert res.ids.shape == (2, K) and res.ids.device == CPU
    for f in res.stats._fields:
        assert getattr(res.stats, f).dtype == torch.int32, f
