"""Tests of the port that need a CUDA device.

Each takes the ``cuda`` fixture, which skips the test on a host without
one; on the card run ``PYTHONPATH=src python -m pytest
tests/test_torch_cuda.py``. This file imports nothing of JAX, so it also
runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import search as tsearch
from repro_torch.core import search_batch as tsb
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.core.quantize import QuantizedStore, quantize
from repro_torch.core.search import SearchParams
from repro_torch.data.synthetic import gaussian_mixture
from repro_torch.kernels import (gather_distance, ops,
                                 quantized_gather_distance, ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
@pytest.mark.parametrize("d", [960, 33])
# K of the main path's launches: entry/seed distances (1), the upper
# descent (32), beam iterations (64), the build's edge merges (40, 72; 72
# spans a second, partial tile of 64 candidates)
@pytest.mark.parametrize("k", [1, 32, 40, 64, 72])
def test_kernel_matches_plain_version(cuda, metric, d, k):
    gen = torch.Generator(device=cuda).manual_seed(0)
    X = torch.randn((5000, d), generator=gen, device=cuda)
    Q = torch.randn((64, d), generator=gen, device=cuda)
    ids = torch.randint(-1, 5010, (64, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    before = gather_distance.LAUNCHES
    got = ops.gather_distance_batch(Q, X, ids, metric)
    assert gather_distance.LAUNCHES == before + 1
    want = ref.gather_distance_batch(Q, X, ids, metric)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    # a different f32 summation order than the plain version
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


def test_kernel_wrapper_checks_its_inputs(cuda):
    X = torch.randn((10, 8), device=cuda)
    Q = torch.randn((2, 8), device=cuda)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        gather_distance.gather_distance_batch(Q, X, ids.long(), "l2")
    with pytest.raises(ValueError, match="contiguous"):
        gather_distance.gather_distance_batch(Q, X.t().contiguous().t(), ids,
                                              "l2")
    with pytest.raises(ValueError, match="shape"):
        gather_distance.gather_distance_batch(Q[:1], X, ids, "l2")


def test_index_defaults_to_the_card_and_engines_agree(cuda):
    X, _, centers = gaussian_mixture(3000, 32, 10, seed=0)
    idx, _ = NavixIndex.create(X, NavixConfig(m_u=8, ef_construction=64))
    assert idx.device.type == "cuda"
    rng = np.random.default_rng(1)
    Q = torch.from_numpy((centers[rng.integers(0, 10, 8)]
                          + 0.3 * rng.normal(size=(8, 32))).astype(np.float32))
    sel = idx.pack_semimask(np.random.default_rng(2).random(3000) < 0.1)
    params = SearchParams(k=10, efs=40)
    many = tsb.search_many(idx.graph, Q.to(cuda), sel, params)
    for i in range(len(Q)):
        one = tsearch.search(idx.graph, Q[i].to(cuda), sel, params)
        assert torch.equal(one.ids, many.ids[i])
        assert torch.equal(one.dists, many.dists[i])
        for f in one.stats._fields:
            assert torch.equal(getattr(one.stats, f), getattr(many.stats, f)[i])


def _close(got, want):
    """Kernel vs plain version: identical +inf placement, rtol 1e-5 / atol
    1e-4 elsewhere (a different f32 summation order)."""
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


def _int8_case(cuda, d, bsz, k):
    """Codes from ``quantize`` of random rows (row 3 all zero: scale 1),
    ids with 20% -1, some ids >= n and a fully retired lane."""
    gen = torch.Generator(device=cuda).manual_seed(d + k)
    X = torch.randn((5000, d), generator=gen, device=cuda)
    X[3] = 0.0
    store = quantize(X)
    Q = torch.randn((bsz, d), generator=gen, device=cuda)
    ids = torch.randint(0, 5010, (bsz, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    ids = torch.where(torch.rand((bsz, k), generator=gen, device=cuda) < 0.2,
                      -1, ids)
    ids[0, 0] = 3                                 # the all-zero row
    if bsz > 1:
        ids[1] = -1
    return Q, store, ids


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
@pytest.mark.parametrize("d", [960, 33])
@pytest.mark.parametrize("k", [1, 32, 64])
def test_int8_kernel_matches_plain_version(cuda, metric, d, k):
    Q, store, ids = _int8_case(cuda, d, 64, k)
    assert store.scale[3].item() == 1.0
    before = quantized_gather_distance.LAUNCHES
    got = ops.quantized_gather_distance_batch(Q, store.codes, store.scale,
                                              ids, metric)
    assert quantized_gather_distance.LAUNCHES == before + 1
    _close(got, ref.quantized_gather_distance_batch(Q, store.codes,
                                                    store.scale, ids, metric))
    # one lane: the single-query entry launches the same kernel, so it
    # gives the batched lane's bits
    before = quantized_gather_distance.ONE_LANE_LAUNCHES
    one = ops.quantized_gather_distance(Q[5], store.codes, store.scale,
                                        ids[5], metric)
    assert quantized_gather_distance.ONE_LANE_LAUNCHES == before + 1
    assert torch.equal(one, got[5])


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
@pytest.mark.parametrize("k", [1, 32, 64])
def test_f32_one_lane_entry_equals_batched_lane(cuda, metric, k):
    gen = torch.Generator(device=cuda).manual_seed(k)
    X = torch.randn((5000, 960), generator=gen, device=cuda)
    Q = torch.randn((8, 960), generator=gen, device=cuda)
    ids = torch.randint(-1, 5010, (8, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    many = ops.gather_distance_batch(Q, X, ids, metric)
    before = gather_distance.ONE_LANE_LAUNCHES
    one = ops.gather_distance(Q[2], X, ids[2], metric)
    assert gather_distance.ONE_LANE_LAUNCHES == before + 1
    assert torch.equal(one, many[2])
    _close(one, ref.gather_distance(Q[2], X, ids[2], metric))


def test_int8_wrapper_checks_its_inputs(cuda):
    Q, store, ids = _int8_case(cuda, 32, 2, 3)
    with pytest.raises(TypeError, match="int8"):
        quantized_gather_distance.quantized_gather_distance_batch(
            Q, store.codes.to(torch.uint8), store.scale, ids, "l2")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        quantized_gather_distance.quantized_gather_distance_batch(
            Q, store.codes.cpu(), store.scale, ids, "l2")
    with pytest.raises(ValueError, match="shape"):
        quantized_gather_distance.quantized_gather_distance_batch(
            Q, store.codes, store.scale[:-1], ids, "l2")


def test_quantized_index_engines_agree_on_the_card(cuda):
    X, _, centers = gaussian_mixture(3000, 32, 10, seed=0)
    idx, _ = NavixIndex.create(X, NavixConfig(m_u=8, ef_construction=64))
    qidx = idx.quantize_resident()
    assert isinstance(qidx.graph.vectors, QuantizedStore)
    assert qidx.graph.vectors.codes.device.type == "cuda"
    rng = np.random.default_rng(1)
    Q = (centers[rng.integers(0, 10, 8)]
         + 0.3 * rng.normal(size=(8, 32))).astype(np.float32)
    mask = np.random.default_rng(2).random(3000) < 0.1
    f32_before = gather_distance.LAUNCHES + gather_distance.ONE_LANE_LAUNCHES
    many = qidx.search_quantized_many(Q, k=10, efs=40, semimask=mask)
    assert many.ids.device.type == "cuda"
    for i in range(len(Q)):
        one = qidx.search_quantized(Q[i], k=10, efs=40, semimask=mask)
        assert torch.equal(one.ids, many.ids[i])
        assert torch.equal(one.dists, many.dists[i])
        for f in one.stats._fields:
            assert torch.equal(getattr(one.stats, f), getattr(many.stats, f)[i])
    # the int8 path launched no f32 gather kernel
    assert (gather_distance.LAUNCHES + gather_distance.ONE_LANE_LAUNCHES
            == f32_before)
