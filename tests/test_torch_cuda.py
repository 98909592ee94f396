"""Tests of the port that need a CUDA device.

Each takes the ``cuda`` fixture, which skips the test on a host without
one; on the card run ``PYTHONPATH=src python -m pytest
tests/test_torch_cuda.py``. This file imports nothing of JAX, so it also
runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import NavixDB, Q
from repro_torch.common.util import tree_leaves
from repro_torch.core import search as tsearch
from repro_torch.core import search_batch as tsb
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.core.quantize import QuantizedStore, quantize
from repro_torch.core.search import SearchParams
from repro_torch.data.synthetic import (gaussian_mixture, make_queries,
                                      make_wiki_like, uncorrelated_plan)
from repro_torch.config.base import ShapeSpec, get_arch
from repro_torch.kernels import (_build, distance_matrix, gather_distance, ops,
                                 quantized, quantized_gather_distance, ref,
                                 segment_sum)
from repro_torch.models import api, recsys

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
    # one lane: the single-query entry sums each row in the batch's order,
    # so it gives the batched lane's bits (both launches run spread here;
    # test_int8_one_lane_entry_equals_batched_lane crosses the schedules)
    before = quantized_gather_distance.ONE_LANE_LAUNCHES
    one = ops.quantized_gather_distance(Q[5], store.codes, store.scale,
                                        ids[5], metric)
    assert quantized_gather_distance.ONE_LANE_LAUNCHES == before + 1
    assert torch.equal(one, got[5])


def _lanes_of_a_tiled_batch(cuda, kernel, d, k, metric):
    """One-lane launches (the spread schedule) at lanes 1, 517 and 1023 of
    a B = 1024 batch (the tiled schedule) on the same q and ids: bit for
    bit the batch's lanes, and the plain version's within tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(d + k)
    X = torch.randn((5000, d), generator=gen, device=cuda)
    Q = torch.randn((1024, d), generator=gen, device=cuda)
    ids = torch.randint(-1, 5010, (1024, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    if kernel is gather_distance:
        args = (X,)
        batched, one_lane = ops.gather_distance_batch, ops.gather_distance
        plain = ref.gather_distance
    else:
        store = quantize(X)
        args = (store.codes, store.scale)
        batched = ops.quantized_gather_distance_batch
        one_lane = ops.quantized_gather_distance
        plain = ref.quantized_gather_distance
    paths = dict(kernel.PATH_LAUNCHES)
    many = batched(Q, *args, ids, metric)
    before = kernel.ONE_LANE_LAUNCHES
    for i in (1, 517, 1023):
        one = one_lane(Q[i], *args, ids[i], metric)
        assert torch.equal(one, many[i])
        _close(one, plain(Q[i], *args, ids[i], metric))
    assert kernel.ONE_LANE_LAUNCHES == before + 3
    assert {s: kernel.PATH_LAUNCHES[s] - paths[s] for s in paths} \
        == {"tiled": 1, "spread": 3}


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
@pytest.mark.parametrize("d", [960, 33])
@pytest.mark.parametrize("k", [1, 32, 64, 72])
def test_f32_one_lane_entry_equals_batched_lane(cuda, metric, d, k):
    _lanes_of_a_tiled_batch(cuda, gather_distance, d, k, metric)


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
@pytest.mark.parametrize("d", [960, 33])
@pytest.mark.parametrize("k", [1, 32, 64, 72])
def test_int8_one_lane_entry_equals_batched_lane(cuda, metric, d, k):
    _lanes_of_a_tiled_batch(cuda, quantized_gather_distance, d, k, metric)


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
@pytest.mark.parametrize("d", [960, 33])
@pytest.mark.parametrize("k", [1, 32, 64, 72])
@pytest.mark.parametrize("bsz", [1, 200])
@pytest.mark.parametrize("schedule", ["tiled", "spread"])
@pytest.mark.parametrize("int8", [False, True])
def test_each_schedule_matches_plain_version(cuda, int8, schedule, bsz, k,
                                             d, metric):
    """Each schedule, named whatever the plan would pick, against the
    plain version; and the two schedules against each other, bit for
    bit."""
    gen = torch.Generator(device=cuda).manual_seed(bsz + k + d)
    X = torch.randn((5000, d), generator=gen, device=cuda)
    Q = torch.randn((bsz, d), generator=gen, device=cuda)
    ids = torch.randint(-1, 5010, (bsz, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    if int8:
        store = quantize(X)
        args = (store.codes, store.scale)
        launch = quantized_gather_distance._launch
        plain = ref.quantized_gather_distance_batch
    else:
        args = (X,)
        launch = gather_distance._launch
        plain = ref.gather_distance_batch
    got, launched = launch(Q, *args, ids, metric, schedule)
    assert launched
    _close(got, plain(Q, *args, ids, metric))
    other = "spread" if schedule == "tiled" else "tiled"
    assert torch.equal(got, launch(Q, *args, ids, metric, other)[0])


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


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
# b <= 16 streams X through CUDA cores, b > 16 runs on the tensor cores (the
# 64-row warpgroup and 128-row tile edges at 64/65 and 128/129); d = 32 is
# the retrieval step's width, 33 and 61 take 4-byte loads; n = 1000 is off
# both paths' row tiles (256 and 128)
@pytest.mark.parametrize("d", [8, 32, 33, 61, 960])
@pytest.mark.parametrize("b", [1, 16, 17, 64, 65, 129])
def test_distance_matrix_kernel_matches_plain_version(cuda, metric, b, d):
    n = 1000
    gen = torch.Generator(device=cuda).manual_seed(b + n + d)
    Q = torch.randn((b, d), generator=gen, device=cuda)
    X = torch.randn((n, d), generator=gen, device=cuda)
    path = "stream" if b <= distance_matrix.STREAM_MAX_BATCH else "wgmma"
    before = distance_matrix.LAUNCHES, distance_matrix.PATH_LAUNCHES[path]
    got = ops.distance_matrix(Q, X, metric)
    assert (distance_matrix.LAUNCHES, distance_matrix.PATH_LAUNCHES[path]) \
        == (before[0] + 1, before[1] + 1)
    # the reference's tolerance for this kernel (another summation order);
    # the tensor-core path holds it through its 3xTF32 split, which plain
    # TF32 products miss by about 3x at d = 32
    torch.testing.assert_close(got, ref.distance_matrix(Q, X, metric),
                               rtol=1e-4, atol=1e-4)
    # each path sums every output over d in one order whatever the batch:
    # on the streaming path a lone row equals its row in the batch; on the
    # tensor-core path the last 64 rows computed alone (another place in
    # the tile) equal the same rows inside the larger batch. The two paths
    # sum in different orders, so no bitwise claim crosses them.
    if path == "stream":
        assert torch.equal(ops.distance_matrix(Q[-1:], X, metric), got[-1:])
    elif b > 64:
        assert torch.equal(ops.distance_matrix(Q[-64:], X, metric),
                           got[-64:])


@pytest.mark.parametrize("b", [3, 100])
def test_distance_matrix_kernel_on_unaligned_rows(cuda, b):
    """Rows at a 4-byte offset (d % 4 == 0 but not 16-byte aligned) take
    the 4-byte loads of either path and give the 16-byte loads' bits."""
    d, n = 32, 777
    gen = torch.Generator(device=cuda).manual_seed(b)
    buf = torch.randn(((b + n) * d + 1,), generator=gen, device=cuda)
    Q = buf[1:1 + b * d].view(b, d)
    X = buf[1 + b * d:].view(n, d)
    assert distance_matrix.plan(Q, X)[1] is False
    for metric in ("l2", "cos", "dot"):
        got = ops.distance_matrix(Q, X, metric)
        torch.testing.assert_close(got, ref.distance_matrix(Q, X, metric),
                                   rtol=1e-4, atol=1e-4)
        aligned = ops.distance_matrix(Q.clone(), X.clone(), metric)
        assert torch.equal(got, aligned)


def _quantized_f64(Q, codes, scale, metric):
    """Kernel 6's form in float64 from the same Q, codes and scale."""
    Q64, c64, s64 = Q.double(), codes.double(), scale.double()[None, :]
    sdot = (Q64 @ c64.T) * s64
    if metric == "l2":
        return ((Q64 * Q64).sum(1)[:, None]
                + (s64 * s64) * (c64 * c64).sum(1)[None, :] - 2 * sdot)
    return 1 - sdot if metric == "cos" else -sdot


_T = quantized.STREAM_MAX_BATCH


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
# b on both sides of the streaming path's threshold and the tensor-core
# path's 64-row warpgroup and 128-row tile edges; d = 960 and 64 take
# 16-byte loads, 100 4-byte copies, 61 byte loads; n off both paths' row
# tiles (256, 128), 70,000 spans many tiles of each block
@pytest.mark.parametrize("b,n,d", [(1, 3000, 960), (8, 1000, 61),
                                   (70, 513, 128), (_T, 3000, 960),
                                   (_T + 1, 3000, 960), (65, 5000, 100),
                                   (129, 70_000, 64), (3, 70_000, 61)])
def test_quantized_distance_kernel_matches_plain_version(cuda, metric, b, n,
                                                         d):
    gen = torch.Generator(device=cuda).manual_seed(b + n + d)
    Q = torch.randn((b, d), generator=gen, device=cuda)
    codes = torch.randint(-127, 128, (n, d), generator=gen, device=cuda,
                          dtype=torch.int8)
    scale = torch.rand((n,), generator=gen, device=cuda) * 0.02 + 1e-3
    scale[::7] = 0.0                              # all-zero rows
    path = "stream" if b <= quantized.STREAM_MAX_BATCH else "wgmma"
    before = quantized.LAUNCHES, quantized.PATH_LAUNCHES[path]
    got = ops.quantized_distance_matrix(Q, codes, scale, metric)
    assert (quantized.LAUNCHES, quantized.PATH_LAUNCHES[path]) \
        == (before[0] + 1, before[1] + 1)
    # the reference's tolerance: the kernel scales last, the plain version
    # dequantizes first
    plain = ref.quantized_distance_matrix(Q, codes, scale, metric)
    torch.testing.assert_close(got, plain, rtol=1e-3, atol=1e-3)
    # beyond that gate (an absolute error of ~1.5 at d = 960 for l2): each
    # path stays within 4x the plain version's error against float64,
    # which one unsplit TF32 product would not
    exact = _quantized_f64(Q, codes, scale, metric)
    assert ((got.double() - exact).abs().max()
            <= 4 * (plain.double() - exact).abs().max())
    # each path sums every output over d in one order whatever the batch:
    # the last row (streaming) or the last 64 rows (tensor cores) computed
    # alone on the same path equal the batch's
    part = Q[-1:] if path == "stream" else Q[-64:]
    alone = quantized._launch(part, codes, scale, metric, path)[0]
    assert torch.equal(alone, got[-part.shape[0]:])


def test_quantized_distance_kernel_on_unaligned_rows(cuda):
    """Codes at a 4-byte offset (d % 16 == 0, not 16-byte aligned) take
    the 4-byte copies on either path and give the 16-byte loads' bits."""
    d, n = 64, 777
    gen = torch.Generator(device=cuda).manual_seed(d + n)
    buf = torch.randint(-127, 128, (n * d + 4,), generator=gen, device=cuda,
                        dtype=torch.int8)
    codes = buf[4:].view(n, d)
    scale = torch.rand((n,), generator=gen, device=cuda)
    for b in (3, quantized.STREAM_MAX_BATCH + 40):
        Q = torch.randn((b, d), generator=gen, device=cuda)
        assert quantized.plan(Q, codes)[1] == 4
        assert quantized.plan(Q, codes.clone())[1] == 16
        for metric in ("l2", "cos", "dot"):
            got = ops.quantized_distance_matrix(Q, codes, scale, metric)
            torch.testing.assert_close(
                got, ref.quantized_distance_matrix(Q, codes, scale, metric),
                rtol=1e-3, atol=1e-3)
            assert torch.equal(got, ops.quantized_distance_matrix(
                Q, codes.clone(), scale, metric))


# per-node degrees of about 1 to 20, as in the GNN graphs (ogb_products
# averages 25), at meshgraphnet's widths (Cora's 1433, Reddit's 602,
# ogb_products' 100 and d_hidden 128) and the scalar path's odd ones; long
# segments are held by the tests below
@pytest.mark.parametrize("e,d,n", [(5000, 128, 300), (4096, 61, 2000),
                                   (1, 4, 3), (20000, 256, 1000),
                                   (3000, 1, 100), (3000, 3, 100),
                                   (3000, 100, 300), (2000, 602, 100),
                                   (1500, 1433, 100)])
def test_segment_sum_kernel_matches_plain_version(cuda, e, d, n):
    gen = torch.Generator(device=cuda).manual_seed(e + d + n)
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen, device=cuda,
                                   dtype=torch.int32)).values
    dst[e - e // 10:] = -1                        # padding at the end
    msgs = torch.randn((e, d), generator=gen, device=cuda)
    before = segment_sum.LAUNCHES
    got = ops.csr_segment_sum(msgs, dst, n)
    assert segment_sum.LAUNCHES == before + segment_sum.launches(e, d)
    torch.testing.assert_close(got, ref.csr_segment_sum(msgs, dst, n),
                               rtol=1e-5, atol=1e-5)
    # sentinel padding gives the same sums, bit for bit
    sent = torch.where(dst < 0, segment_sum.PAD_SENTINEL, dst)
    assert torch.equal(ops.csr_segment_sum(msgs, sent, n), got)


def _power_law_dst(gen, n, e):
    """Sorted destinations by ``random_power_law_graph``'s law (node r with
    weight (r + 1)^-0.75: node 0 is the hub)."""
    w = torch.arange(1, n + 1, dtype=torch.float64, device=gen.device)
    cdf = torch.cumsum(w ** -0.75, 0)
    u = torch.rand((e,), generator=gen, dtype=torch.float64,
                   device=gen.device) * cdf[-1]
    ids = torch.searchsorted(cdf, u).clamp_(max=n - 1).to(torch.int32)
    return torch.sort(ids).values


def _exact(msgs, dst, n):
    out = torch.zeros((n + 1, msgs.shape[1]), dtype=torch.float64,
                      device=msgs.device)
    out.index_add_(0, torch.where((dst >= 0) & (dst < n), dst, n).long(),
                   msgs.double())
    return out[:n]


@pytest.mark.parametrize("d", [128, 61])
def test_segment_sum_kernel_on_a_power_law_graph(cuda, d):
    """The law of ``random_power_law_graph`` at n = 20,000, E = 500,000 (a
    hub of ~11,000 edges): nodes of at most 64 edges against the plain
    version, the rest against float64 (at the long-segment test's atol)."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    n, e = 20_000, 500_000
    dst = _power_law_dst(gen, n, e)
    msgs = torch.randn((e, d), generator=gen, device=cuda)
    got = ops.csr_segment_sum(msgs, dst, n)
    deg = torch.bincount(dst, minlength=n)
    short = deg <= 64
    torch.testing.assert_close(got[short],
                               ref.csr_segment_sum(msgs, dst, n)[short],
                               rtol=1e-5, atol=1e-5)
    assert deg.max() > 10_000
    torch.testing.assert_close(got[~short].double(),
                               _exact(msgs, dst, n)[~short], rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("d", [128, 100, 3])
def test_segment_sum_two_calls_are_bitwise_equal(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    dst = _power_law_dst(gen, 5000, 200_000)
    msgs = torch.randn((200_000, d), generator=gen, device=cuda)
    assert torch.equal(ops.csr_segment_sum(msgs, dst, 5000),
                       ops.csr_segment_sum(msgs, dst, 5000))


# (E, d, n, rows a span): short spans so that segments cross many of them
@pytest.mark.parametrize("e,d,n,span_rows", [
    (5000, 128, 300, 64), (4096, 61, 2000, 32), (3000, 1, 100, 7),
    (3000, 100, 100, 40), (2000, 602, 100, 16), (1500, 1433, 100, 11),
    (20000, 256, 1000, 50), (40, 8, 5, 8), (0, 8, 5, 8), (100, 8, 50, 512)])
def test_segment_sum_kernel_equals_its_schedule_bit_for_bit(
        cuda, e, d, n, span_rows):
    """The kernel at a given span equals ``span_schedule`` (its order in
    plain PyTorch on the CPU) bit for bit, power-law and uniform."""
    gen = torch.Generator(device=cuda).manual_seed(e + d + span_rows)
    for dst in (torch.sort(torch.randint(0, n, (e,), generator=gen,
                                         device=cuda,
                                         dtype=torch.int32)).values,
                _power_law_dst(gen, n, e)):
        dst[e - e // 10:] = segment_sum.PAD_SENTINEL
        msgs = torch.randn((e, d), generator=gen, device=cuda)
        got = segment_sum._launch(msgs, dst, n, span_rows)
        want, _, _ = segment_sum.span_schedule(msgs, dst, n, span_rows)
        assert torch.equal(got.cpu(), want)


def test_segment_sum_kernel_on_long_segments(cuda):
    """2000 edges a node: both f32 sums (the kernel's in span pieces, the
    plain version's by atomics) stray from the exact sum by about
    sqrt(2000) roundings of values near 45, so each is held against a
    float64 sum at atol 1e-3 rather than against the other at 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    e, d, n = 20000, 256, 10
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen, device=cuda,
                                   dtype=torch.int32)).values
    msgs = torch.randn((e, d), generator=gen, device=cuda)
    exact = _exact(msgs, dst, n)
    got = ops.csr_segment_sum(msgs, dst, n)
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(ref.csr_segment_sum(msgs, dst, n).double(),
                               exact, rtol=1e-5, atol=1e-3)


def test_segment_sum_hub_of_many_spans_against_float64(cuda):
    """One node of 40,000 edges across more than 10 spans of the wrapper's
    plan (its pieces added in span order by the fix-up), beside short
    ones."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    e, d, n = 60_000, 128, 1000
    rows, spans = segment_sum.plan(e, d)
    hub = torch.zeros(40_000, dtype=torch.int32, device=cuda) + 3
    rest = torch.randint(4, n, (e - hub.numel(),), generator=gen,
                         device=cuda, dtype=torch.int32)
    dst = torch.sort(torch.cat([hub, rest])).values
    assert 40_000 > 10 * rows and spans > 10
    msgs = torch.randn((e, d), generator=gen, device=cuda)
    got = ops.csr_segment_sum(msgs, dst, n)
    torch.testing.assert_close(got.double(), _exact(msgs, dst, n), rtol=1e-5,
                               atol=1e-3)
    assert not got[:3].any()


def _to(tree, device):
    """A parameter tree with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)


def test_retrieval_step_on_the_card_matches_the_plain_path(cuda):
    cfg = get_arch("bst").smoke_config
    params = recsys.init_recsys(cfg, torch.Generator().manual_seed(0), "cpu")
    shape = ShapeSpec("r", "recsys_retrieval",
                      {"batch": 2, "n_candidates": 20000})
    batch = api.make_batch(cfg, shape, torch.Generator().manual_seed(1), "cpu")
    step = api.make_retrieval_step(cfg, k=100)
    want_vals, want_ids = step(params, batch)
    before = distance_matrix.LAUNCHES
    vals, ids = step(_to(params, cuda),
                     {k: v.to(cuda) for k, v in batch.items()})
    assert distance_matrix.LAUNCHES == before + 1
    assert torch.equal(ids.cpu(), want_ids)
    torch.testing.assert_close(vals.cpu(), want_vals, rtol=1e-5, atol=1e-6)


def test_launch_error_message_comes_from_the_card(cuda):
    with pytest.raises(RuntimeError, match=r"csr_segment_sum kernel launch "
                       r"failed: invalid argument \(cudaError 1\)"):
        _build.check_launch("csr_segment_sum", 1)
    X = torch.randn((10, 8), device=cuda)
    with pytest.raises(ValueError, match="must be contiguous"):
        distance_matrix.distance_matrix(X[:2], X.T.contiguous().T, "dot")


def _wiki_db_on_the_card(cuda):
    """A small Wiki-like store and its chunk index built on the card
    through ``NavixDB.create_index``."""
    data = make_wiki_like(n_person=120, n_resource=300, d=32, seed=2)
    db = NavixDB(data.store)
    idx, _ = db.create_index("chunk_emb", "Chunk", vectors=data.embeddings,
                             config=NavixConfig(m_u=8, ef_construction=48))
    assert db.device.type == "cuda" and idx.device.type == "cuda"
    return db, idx, data


def test_execute_equals_search_many_at_a_padded_bucket(cuda):
    """B = 17 pads to the 32-lane bucket: ids, dists and stats equal an
    unregistered handle's unpadded ``search_many``, bit for bit, and a
    B = 1024 batch (whose gather launches run tiled) lane for lane."""
    db, idx, data = _wiki_db_on_the_card(cuda)
    queries = make_queries(data, 1024, "person", seed=3)
    plan = (Q.match("Person").where("birth_date", "range", lo=0, hi=20000)
            .hop("PersonChunk").knn(k=10, efs=40))
    rs = db.execute(plan, query=queries[:17])
    assert db.programs.info()["programs"] == 1
    plain = NavixIndex(graph=idx.graph, config=idx.config)
    want = plain.search_many(queries[:17], k=10, efs=40, semimask=rs.mask)
    big = plain.search_many(queries, k=10, efs=40, semimask=rs.mask)
    for got in (want, big):
        assert np.array_equal(rs.ids, got.ids[:17].cpu().numpy())
        assert np.array_equal(rs.dists, got.dists[:17].cpu().numpy())
        for f in got.stats._fields:
            assert np.array_equal(getattr(rs.stats, f),
                                  getattr(got.stats, f)[:17].cpu().numpy()), f
    assert rs.timings.search_ms > 0 and rs.timings.pack_ms > 0


def test_postfilter_on_the_card_equals_its_cpu_copy(cuda):
    db, idx, data = _wiki_db_on_the_card(cuda)
    mask = db.prefilter(uncorrelated_plan(0.1, data.n_chunks)).mask
    q = make_queries(data, 1, "uncorrelated", seed=4)[0]
    before = gather_distance.ONE_LANE_LAUNCHES
    d, ids, stats = idx.search_postfilter(q, k=10, semimask=mask)
    assert gather_distance.ONE_LANE_LAUNCHES > before
    cpu = NavixIndex.from_graph(idx.graph, idx.config, device="cpu")
    d_cpu, ids_cpu, stats_cpu = cpu.search_postfilter(q, k=10, semimask=mask)
    assert np.array_equal(ids, ids_cpu) and stats == stats_cpu
    torch.testing.assert_close(torch.from_numpy(d), torch.from_numpy(d_cpu),
                               rtol=1e-5, atol=0.0)
    assert mask[ids[ids >= 0]].all() and stats.restarts >= 1


def _serving_index(cuda):
    X, _, centers = gaussian_mixture(3000, 32, 10, seed=0)
    idx, _ = NavixIndex.create(X, NavixConfig(m_u=8, ef_construction=64))
    assert idx.device.type == "cuda"
    rng = np.random.default_rng(5)
    Q = (centers[rng.integers(0, 10, 24)]
         + 0.3 * rng.normal(size=(24, 32))).astype(np.float32)
    return idx, Q


def test_lane_batch_step_async_equals_step_on_the_card(cuda):
    """step_async + work issued mid-flight + step_wait == step, bit for bit:
    the chunk runs on the stream, its liveness lands in pinned memory and
    the host syncs on one event a chunk."""
    from repro_torch.core import bitset
    from repro_torch.serving.lanes import LaneBatch
    idx, Q = _serving_index(cuda)
    n = idx.graph.n
    prepped = idx._prep_query(Q).cpu().numpy()
    cuts = [n // 5, n // 2, n, n // 3, n // 4, n // 7, 2 * n // 3, n // 9]
    entries = [(j, prepped[j], bitset.pack_np(np.arange(n) < c), c / n,
                (12, 24, 40)[j % 3]) for j, c in enumerate(cuts)]
    a = LaneBatch(idx, "adaptive_local", 6, 40, bsz=8)
    b = LaneBatch(idx, "adaptive_local", 6, 40, bsz=8)
    assert a._live_host.is_pinned()
    a.admit(list(entries))
    b.admit(list(entries))
    while True:
        a.step_async(3)
        assert a.step_pending
        ids_a, d_a = a.finalize(np.ones(1, bool))     # queued behind it
        live_a = a.step_wait()
        live_b = b.step(3)
        ids_b, d_b = b.finalize(np.ones(1, bool))
        assert np.array_equal(live_a, live_b)
        assert np.array_equal(ids_a, ids_b) and np.array_equal(d_a, d_b)
        if not live_a.any():
            break
    assert a.timing()["n_chunks"] == b.timing()["n_chunks"] > 1


def test_continuous_equals_search_many_on_the_card(cuda):
    """The continuous scheduler on the card (ragged efs, refills while other
    lanes run) answers each request bit for bit as the one-shot
    ``search_many`` at the request's own efs; grouped equals it too."""
    from repro_torch.query.operators import Filter, KnnSearch, NodeScan
    from repro_torch.serving import SearchEngine
    from repro_torch.storage.columnar import GraphStore
    idx, Q = _serving_index(cuda)
    n = idx.graph.n
    store = GraphStore()
    store.add_node_table("Chunk", n, {"cID": np.arange(n)})
    reqs = [(int(n * f), k, e) for f, k, e in
            [(0.1, 6, 12), (0.5, 6, 40), (1.0, 4, 20), (0.3, 6, 24),
             (0.05, 5, 16), (0.8, 6, 30)] * 4]
    results = {}
    for sched in ("continuous", "grouped"):
        eng = SearchEngine(index=idx, store=store, efs=40, max_batch=8,
                           scheduler=sched, step_iters=4, refill_threshold=2)
        rids = [eng.submit(Q[j], k=k, plan=KnnSearch(
            child=Filter(NodeScan("Chunk"), "cID", "<", value=c), k=k,
            efs=e)) for j, (c, k, e) in enumerate(reqs)]
        by = {r.rid: r for r in eng.drain()}
        assert sorted(by) == sorted(rids)
        results[sched] = [by[rid] for rid in rids]
    for j, (c, k, e) in enumerate(reqs):
        want = idx.search_many(Q[j:j + 1], k=k, efs=e,
                               semimask=(np.arange(n) < c)[None])
        for sched in ("continuous", "grouped"):
            r = results[sched][j]
            assert np.array_equal(r.ids, want.ids[0].cpu().numpy()), sched
            assert np.array_equal(r.dists, want.dists[0].cpu().numpy())


def test_sharded_search_on_one_card_equals_its_cpu_copy(cuda):
    """Four shards on one card (a (1, 4) grid, every cell cuda:0), one of
    them dead: the search equals the on-card oracle (the unsharded engine
    per shard + numpy lexsort) bit for bit, launches kernel 1, and equals
    the same shards' search on a CPU grid in >= 99% of lanes (kernel 1
    sums in another order than the plain version, so a near tie may flip
    a lane). A (2, 4) grid whose second row is the CPU agrees the same
    way and copies each shard there once."""
    from repro_torch.core.distributed import (ShardedNavix, make_mesh,
                                              per_shard_reference)
    X, _, centers = gaussian_mixture(4001, 32, 10, seed=0)
    sn = ShardedNavix.build(X, NavixConfig(m_u=8, ef_construction=64),
                            make_mesh((1, 4), device=cuda))
    assert sn.device == torch.device("cuda", torch.cuda.current_device())
    assert all(g.device == sn.device for g in sn.graphs)
    cpu = ShardedNavix(mesh=make_mesh((1, 4), device="cpu"),
                       graphs=[g.to(torch.device("cpu")) for g in sn.graphs],
                       n_local=sn.n_local, n_total=sn.n_total,
                       config=sn.config)
    rng = np.random.default_rng(1)
    Q = (centers[rng.integers(0, 10, 256)]
         + 0.3 * rng.normal(size=(256, 32))).astype(np.float32)
    sigmas = (1.0, 0.4, 0.1, 0.0, 0.03, 0.7)
    masks = np.stack([rng.random(len(X)) < sigmas[j % len(sigmas)]
                      for j in range(len(Q))])
    alive = np.array([True, True, False, True])
    before = gather_distance.LAUNCHES
    res = sn.search_many(Q, semimask=masks, k=10, efs=40, alive=alive)
    assert gather_distance.LAUNCHES > before
    d, ids, stats = per_shard_reference(sn, Q, masks, sn._params(10, 40,
                                        "adaptive_local"), alive=alive)
    assert np.array_equal(res.ids.cpu().numpy(), ids)
    assert np.array_equal(res.dists.cpu().numpy(), d)
    for f in res.stats._fields:
        assert np.array_equal(getattr(res.stats, f).cpu().numpy(),
                              getattr(stats, f))
    got = res.ids.cpu().numpy()
    assert not ((got >= 2 * sn.n_local) & (got < 3 * sn.n_local)).any()
    want = cpu.search_many(Q, semimask=masks, k=10, efs=40,
                           alive=alive).ids.numpy()
    assert (got == want).all(axis=1).mean() >= 0.99
    # a grid whose rows differ: the card's shards are copied once to the
    # CPU row, and that row's lane block runs there
    mixed = ShardedNavix(mesh=make_mesh((2, 4), device=[cuda] * 4
                                        + ["cpu"] * 4),
                         graphs=sn.graphs, n_local=sn.n_local,
                         n_total=sn.n_total, config=sn.config)
    outs = [mixed.search_many(Q, semimask=masks, k=10, efs=40,
                              alive=alive).ids.cpu().numpy()
            for _ in range(2)]
    assert np.array_equal(outs[0], outs[1])
    assert (outs[0] == got).all(axis=1).mean() >= 0.99
    assert sorted(mixed._replicas) == [(s, torch.device("cpu"))
                                       for s in range(4)]
    assert all(rep[0] is sn.graphs[s] and rep[1].device.type == "cpu"
               for (s, _), rep in mixed._replicas.items())


_COUNT_NVCC = """\
import json, pathlib, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.analysis.runtime import CompileCounter
from repro_torch.kernels import _build
_build.BUILD_DIR = pathlib.Path(sys.argv[2])    # nothing built there yet
with CompileCounter() as cc:
    _build.load("cuda_error")
    cc.mark("again")
    _build.load("cuda_error")                   # loaded in this process
    _build._loaded.clear()
    _build.load("cuda_error")                   # reused from the build dir
print(json.dumps(cc.kinds))
"""


def test_compile_counter_counts_one_nvcc_run_then_none(cuda, tmp_path):
    """In a fresh process under ``CompileCounter``, building a CUDA source
    with nvcc is one ``"nvcc"`` event; using it again, loaded or from
    the build directory, is none."""
    import json
    import pathlib
    import subprocess
    import sys

    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    proc = subprocess.run(
        [sys.executable, "-c", _COUNT_NVCC, str(src), str(tmp_path / "out")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    kinds = json.loads(proc.stdout.strip().splitlines()[-1])
    assert kinds == {"warmup": {"nvcc": 1}, "again": {}}


def test_segment_sum_backward_on_the_card_equals_the_plain_autograd(cuda):
    """``ops.SegmentSum``: its forward launches kernel 7, and its backward
    (a gather) equals autograd through the plain version bit for bit,
    for f32 and bf16 messages, with -1 padding at the end."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    n, e, d = 5000, 40000, 128
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen, device=cuda,
                                   dtype=torch.int32)).values
    dst = torch.cat([dst, torch.full((512,), -1, dtype=torch.int32,
                                     device=cuda)])
    gout = torch.randn((n, d), generator=gen, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        msgs = torch.randn((e + 512, d), generator=gen, device=cuda
                           ).to(dtype)
        a = msgs.clone().requires_grad_(True)
        before = segment_sum.LAUNCHES
        out = ops.csr_segment_sum(a, dst, n)
        assert segment_sum.LAUNCHES == before + segment_sum.launches(
            e + 512, d)
        out.backward(gout)
        b = msgs.clone().requires_grad_(True)
        want = ref.csr_segment_sum(b, dst, n)
        want.backward(gout)
        assert a.grad.dtype == dtype
        assert torch.equal(a.grad, b.grad)
        torch.testing.assert_close(out, want.detach(), rtol=1e-5, atol=1e-5)


def _gnn_smoke_batch(n=300, e=1500, seed=0):
    cfg = get_arch("meshgraphnet").smoke_config
    rng = np.random.default_rng(seed)
    src = rng.integers(-1, n, size=e).astype(np.int32)
    return cfg, {
        "node_feats": torch.from_numpy(
            rng.normal(size=(n, cfg.in_node_dim)).astype(np.float32)),
        "edge_src": torch.from_numpy(src),
        "edge_dst": torch.from_numpy(
            rng.integers(-1, n, size=e).astype(np.int32)),
        "edge_feats": torch.from_numpy(
            rng.normal(size=(e, cfg.in_edge_dim)).astype(np.float32)),
        "node_targets": torch.from_numpy(
            rng.normal(size=(n, cfg.out_dim)).astype(np.float32)),
        "node_mask": torch.from_numpy(rng.random(n) < 0.7)}


def test_gnn_smoke_forward_and_step_on_the_card_match_the_cpu_copy(cuda):
    """MeshGraphNet SMOKE (f32): a forward and one AdamW step on the card
    equal the same on a CPU copy of the parameters and batch up to f32
    summation order (rtol 1e-4, atol 1e-5; the card's index backward
    scatter-adds atomically, so not bit for bit), and the aggregate ran
    through kernel 7 (3 blocks, one call each in the forward)."""
    import dataclasses
    from repro_torch.models import gnn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, batch = _gnn_smoke_batch()
    params = gnn.init_gnn(cfg, torch.Generator().manual_seed(0), "cpu")
    step, opt = api.make_train_step(cfg, lr=3e-3)
    want_pred = gnn.gnn_forward(cfg, params, batch)
    want = step(params, opt.init(params), batch)
    pc, bc = _to(params, cuda), {k: v.to(cuda) for k, v in batch.items()}
    before = segment_sum.LAUNCHES
    pred = gnn.gnn_forward(cfg, pc, bc)
    assert segment_sum.LAUNCHES - before == cfg.n_layers * \
        segment_sum.launches(1500, cfg.d_hidden)
    torch.testing.assert_close(pred.cpu(), want_pred, rtol=1e-4, atol=1e-5)
    got = step(pc, opt.init(pc), bc)
    torch.testing.assert_close(float(got[2]["loss"]),
                               float(want[2]["loss"]), rtol=1e-4, atol=0)
    for a, b in zip(tree_leaves(got[0]) + tree_leaves(got[1]),
                    tree_leaves(want[0]) + tree_leaves(want[1])):
        assert a.device.type == "cuda"
        # AdamW's first step is lr * g / (|g| + eps): near-zero gradients
        # move it by up to lr x 1e-3, as in the CPU parity test
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    remat = dataclasses.replace(cfg, remat=True, compute_dtype="bfloat16")
    loss, _, _ = api.value_and_grad(api.model_api(remat).loss, pc, bc)
    assert bool(torch.isfinite(loss))


RANKING = ["wide-deep", "deepfm", "dien", "bst"]


@pytest.mark.parametrize("arch_id", RANKING)
def test_ranking_smoke_forward_loss_and_grads_on_the_card_match_the_cpu_copy(
        cuda, arch_id):
    """Each recsys SMOKE model: logits and loss on the card equal a CPU
    copy's at rtol 1e-4 / atol 1e-5 (TF32 off), every gradient leaf within
    5e-3 of that leaf's largest magnitude (the card's ``table[ids]``
    backward scatter-adds atomically, in another order), the serve step
    equals the forward bit for bit, and no kernel of the port launches
    (the ranking path has none)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch_id).smoke_config
    params = recsys.init_recsys(cfg, torch.Generator().manual_seed(0), "cpu")
    shape = ShapeSpec("t", "recsys_train", {"batch": 256})
    batch = api.make_batch(cfg, shape, torch.Generator().manual_seed(1),
                           "cpu")
    loss_fn = api.model_api(cfg).loss
    want_logits = recsys.recsys_forward(cfg, params, batch)
    want_loss, _, want_grads = api.value_and_grad(loss_fn, params, batch)
    pc, bc = _to(params, cuda), {k: v.to(cuda) for k, v in batch.items()}
    before = (distance_matrix.LAUNCHES, segment_sum.LAUNCHES,
              gather_distance.LAUNCHES, quantized.LAUNCHES)
    logits = recsys.recsys_forward(cfg, pc, bc)
    loss, _, grads = api.value_and_grad(loss_fn, pc, bc)
    served = api.make_serve_step(cfg)(pc, bc)
    assert (distance_matrix.LAUNCHES, segment_sum.LAUNCHES,
            gather_distance.LAUNCHES, quantized.LAUNCHES) == before
    assert torch.equal(served, logits)
    torch.testing.assert_close(logits.cpu(), want_logits, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=1e-4, atol=1e-5)
    for g, w in zip(tree_leaves(grads), tree_leaves(want_grads)):
        assert g.device.type == "cuda"
        err = float((g.cpu() - w).abs().max())
        assert err <= 5e-3 * float(w.abs().max().clamp(min=1e-30))


LM_ARCHS = ["gemma-7b", "qwen1.5-0.5b", "gemma2-9b", "kimi-k2-1t-a32b",
            "granite-moe-3b-a800m"]


def _kernel_counts():
    return (distance_matrix.LAUNCHES, segment_sum.LAUNCHES,
            gather_distance.LAUNCHES, gather_distance.ONE_LANE_LAUNCHES,
            quantized.LAUNCHES, quantized_gather_distance.LAUNCHES,
            quantized_gather_distance.ONE_LANE_LAUNCHES)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_smoke_serving_on_the_card_matches_the_cpu_copy(cuda, arch_id):
    """Each LM SMOKE config (f32, TF32 off): prefill logits and cache, two
    decode steps and ``greedy_generate``'s tokens on the card equal a CPU
    copy's (logits at rtol 1e-4 / atol 1e-4: other summation orders, and
    the MoE combine's atomic adds); the decode step reads nothing back to
    the host (CUDA sync debug mode "error"); the cache is updated in
    place; no kernel of the port launches (the LM path has none)."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import greedy_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch_id).smoke_config
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 2)).astype(np.int32)
    tol = dict(rtol=1e-4, atol=1e-4)
    pc = _to(params, cuda)
    before = _kernel_counts()
    with torch.no_grad():
        want_cache, want = T.prefill(cfg, params, torch.from_numpy(prompt),
                                     max_len=24)
        cache, got = T.prefill(cfg, pc, torch.from_numpy(prompt).to(cuda),
                               max_len=24)
        torch.testing.assert_close(got.cpu(), want, **tol)
        torch.testing.assert_close(cache.k.cpu(), want_cache.k, **tol)
        assert cache.length.device.type == "cuda"
        k_ptr = cache.k.data_ptr()
        for i in range(2):
            want_cache, want = T.decode_step(cfg, params, want_cache,
                                             torch.from_numpy(toks[:, i]))
            tok = torch.from_numpy(toks[:, i]).to(cuda)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out, got = T.decode_step(cfg, pc, cache, tok)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert out is cache and cache.k.data_ptr() == k_ptr
            torch.testing.assert_close(got.cpu(), want, **tol)
        assert int(cache.length) == 22
        torch.testing.assert_close(cache.v.cpu(), want_cache.v, **tol)
    prompt8 = prompt[:, :8]
    np.testing.assert_array_equal(greedy_generate(cfg, pc, prompt8, 4),
                                  greedy_generate(cfg, params, prompt8, 4))
    assert _kernel_counts() == before


def test_lm_smoke_loss_and_grads_on_the_card_match_the_cpu_copy(cuda):
    """gemma2-9b SMOKE (f32, remat on): loss on the card at rtol 1e-4 of
    its CPU copy's, every gradient leaf within 1e-3 of that leaf's largest
    magnitude (the embedding's backward scatter-adds atomically)."""
    import dataclasses
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("gemma2-9b").smoke_config, remat=True)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32))
    loss_fn = api.model_api(cfg).loss
    want_loss, _, want = api.value_and_grad(loss_fn, params,
                                            {"tokens": tokens})
    loss, _, grads = api.value_and_grad(loss_fn, _to(params, cuda),
                                        {"tokens": tokens.to(cuda)})
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=1e-4, atol=1e-5)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert g.device.type == "cuda"
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-3 * float(w.abs().max().clamp(min=1e-30))


def test_lm_smoke_adafactor_step_on_the_card_matches_the_cpu_copy(cuda):
    """One ``make_train_step`` of gemma2-9b SMOKE with Adafactor (the full
    CONFIG's optimizer) and remat on (f32, TF32 off): the loss on the card
    at rtol 1e-4 of its CPU copy's, every new parameter within 5e-3 of its
    leaf's largest update (the embedding's backward scatter-adds
    atomically), no kernel of the port launched."""
    import dataclasses
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("gemma2-9b").smoke_config, remat=True,
                              optimizer="adafactor")
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32))
    step, opt = api.make_train_step(cfg)
    assert opt.name == "adafactor"
    want, _, wm = step(params, opt.init(params), {"tokens": tokens})
    pc = _to(params, cuda)
    before = _kernel_counts()
    got, st, m = step(pc, opt.init(pc), {"tokens": tokens.to(cuda)})
    assert _kernel_counts() == before
    torch.testing.assert_close(m["loss"].cpu(), wm["loss"], rtol=1e-4,
                               atol=1e-5)
    for g, w, p in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(params)):
        assert g.device.type == "cuda"
        upd = float((w - p).abs().max().clamp(min=1e-30))
        assert float((g.cpu() - w).abs().max()) <= 5e-3 * upd
    assert st["count"].device.type == "cuda"


def test_host_mesh_on_the_card(cuda):
    """``make_host_mesh()`` makes a one-rank NCCL group on the card and a
    (1, 1) mesh over it; a DTensor placed by the sharding rules on it runs
    a product on the card; the group is gone after."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import Spec, to_placements
    from repro_torch.launch.mesh import make_host_mesh

    with make_host_mesh() as mesh:
        assert mesh.device_type == "cuda"
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        x = torch.randn(8, 16, device=cuda)
        dx = distribute_tensor(x, mesh, to_placements(Spec("data", "model"),
                                                      mesh))
        y = (dx @ dx.T).full_tensor()
        assert y.device.type == "cuda"
        torch.testing.assert_close(y, x @ x.T)
    assert not dist.is_initialized()
