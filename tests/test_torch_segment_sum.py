"""The port's CSR segment sum (``ops.csr_segment_sum`` on CPU tensors, the
plain version the CUDA kernel is held against on the card) against the JAX
package's Pallas kernel in interpret mode (with its host ``plan_tiles``)
and its oracle, at rtol/atol 1e-5 (sums in another order).

The CUDA kernel's span schedule, modelled in plain PyTorch by
``segment_sum.span_schedule`` (spans of S rows, short segments summed whole
in edge order, long ones in per-span pieces added in span order, empty
nodes zero; the card's tests hold the kernel to it bit for bit), is held
against the same references here at small spans, so that segments cross
them, with the rows its spans load (each real row once, padding never)
and the out rows they store (each once); long segments, whose f32 orders
differ over thousands of adds, against a float64 sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.segment_sum import PAD_SENTINEL as J_SENTINEL
from repro.kernels.segment_sum import csr_segment_sum_pallas, plan_tiles
from repro_torch.kernels import ops
from repro_torch.kernels import segment_sum as kernel

RNG = np.random.default_rng(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _port(msgs, dst, n):
    before = kernel.LAUNCHES
    got = ops.csr_segment_sum(torch.from_numpy(msgs), torch.from_numpy(dst),
                              n)
    assert kernel.LAUNCHES == before          # a CPU tensor launches nothing
    assert got.dtype == torch.float32 and got.shape == (n, msgs.shape[1])
    return got.numpy()


def _schedule(msgs, dst, n, span_rows):
    """The CUDA kernel's sums, in its order, at ``span_rows`` rows a span;
    its spans load every row with a destination in [0, n) once and no other
    row, and store every row of out once."""
    out, reads, writes = kernel.span_schedule(
        torch.from_numpy(msgs), torch.from_numpy(dst), n, span_rows)
    assert torch.equal(reads, torch.from_numpy((dst >= 0) & (dst < n)).long())
    assert torch.equal(writes, torch.ones(n, dtype=torch.int64))
    return out.numpy()


def _schedules(msgs, dst, n):
    """The schedule at the wrapper's own span and at small ones."""
    rows = kernel.plan(len(dst), msgs.shape[1])[0]
    return [_schedule(msgs, dst, n, s) for s in (rows, 1, 7, 32)]


def _pallas(msgs, dst, n, bn, be):
    first, t_max = plan_tiles(dst, n, bn, be, len(dst))
    out = csr_segment_sum_pallas(jnp.asarray(msgs), jnp.asarray(dst),
                                 jnp.asarray(first), n, bn=bn, be=be,
                                 t_max=t_max, interpret=True)
    return np.asarray(out)[:n]


def test_sentinel_is_the_reference_one():
    assert kernel.PAD_SENTINEL == J_SENTINEL == 0x3FFFFFFF


@pytest.mark.parametrize("e,d,n,bn,be", [
    (512, 64, 100, 128, 256),
    (1024, 128, 300, 128, 256),
    (256, 32, 1000, 128, 256),   # many empty blocks
])
def test_matches_pallas_interpret_and_oracle(e, d, n, bn, be):
    dst = np.sort(RNG.integers(0, n, size=e)).astype(np.int32)
    msgs = RNG.normal(size=(e, d)).astype(np.float32)
    got = _port(msgs, dst, n)
    np.testing.assert_allclose(got, _pallas(msgs, dst, n, bn, be), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.csr_segment_sum(
        jnp.asarray(msgs), jnp.asarray(dst), n)), **TOL)
    for sched in _schedules(msgs, dst, n):
        np.testing.assert_allclose(sched, got, **TOL)


def test_sentinel_padding():
    n, e, d = 50, 256, 16
    dst = np.sort(RNG.integers(0, n, size=e - 20)).astype(np.int32)
    dst = np.concatenate([dst, np.full(20, kernel.PAD_SENTINEL, np.int32)])
    msgs = RNG.normal(size=(e, d)).astype(np.float32)
    got = _port(msgs, dst, n)
    np.testing.assert_allclose(got, _pallas(msgs, dst, n, 128, 256), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.csr_segment_sum(
        jnp.asarray(msgs[:-20]), jnp.asarray(dst[:-20]), n)), **TOL)
    for s in (kernel.plan(e, d)[0], 7, 32):      # padding is never read
        sched, reads, _ = kernel.span_schedule(torch.from_numpy(msgs),
                                               torch.from_numpy(dst), n, s)
        assert (reads[:e - 20] == 1).all() and not reads[e - 20:].any()
        np.testing.assert_allclose(sched.numpy(), got, **TOL)


@pytest.mark.parametrize("e,d,n", [(300, 24, 40), (700, 20, 90)])
def test_minus_one_padding_through_ops(monkeypatch, e, d, n):
    """-1 padding at the end of the sorted list, through both packages'
    ``ops`` entries (the reference's with its Pallas kernel forced, which
    maps -1 to the sentinel and pads E to its tile)."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    dst = np.sort(RNG.integers(0, n, size=e)).astype(np.int32)
    dst[-37:] = -1
    msgs = RNG.normal(size=(e, d)).astype(np.float32)
    got = _port(msgs, dst, n)
    want = jops.csr_segment_sum(jnp.asarray(msgs), jnp.asarray(dst), n)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.csr_segment_sum(
        jnp.asarray(msgs), jnp.asarray(dst), n)), **TOL)
    mapped = np.where(dst < 0, kernel.PAD_SENTINEL, dst).astype(np.int32)
    for sched in _schedules(msgs, mapped, n):
        np.testing.assert_allclose(sched, got, **TOL)


def test_many_empty_nodes():
    """Edges on 10 of 2000 nodes: every other node sums to zero."""
    n, d = 2000, 8
    nodes = np.sort(RNG.choice(n, size=10, replace=False))
    dst = np.sort(RNG.choice(nodes, size=256)).astype(np.int32)
    msgs = RNG.normal(size=(256, d)).astype(np.float32)
    got = _port(msgs, dst, n)
    np.testing.assert_allclose(got, _pallas(msgs, dst, n, 128, 256), **TOL)
    empty = np.setdiff1d(np.arange(n), nodes)
    assert not got[empty].any()
    for sched in _schedules(msgs, dst, n):
        np.testing.assert_allclose(sched, got, **TOL)
        assert not sched[empty].any()


def _power_law_dst(n, e, seed):
    """Sorted destinations by ``random_power_law_graph``'s law (node r with
    weight (r + 1)^-0.75: node 0 is the hub)."""
    w = 1.0 / np.arange(1, n + 1) ** 0.75
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=e, p=w / w.sum())).astype(np.int32)


def _exact(msgs, dst, n):
    out = np.zeros((n + 1, msgs.shape[1]))
    np.add.at(out, np.where((dst >= 0) & (dst < n), dst, n),
              msgs.astype(np.float64))
    return out[:n]


@pytest.mark.parametrize("span_rows", [32, 100, 512])
def test_schedule_hub_across_many_spans(span_rows):
    """A hub of ~2,100 edges crossing up to 66 spans (the power-law law at
    n = 2000, E = 50,000): nodes of at most 64 edges against the JAX oracle
    at TOL, longer ones against float64 (rtol 1e-5, atol 1e-3, as the card's
    long-segment test)."""
    n, e, d = 2000, 50_000, 4
    dst = _power_law_dst(n, e, seed=span_rows)
    msgs = RNG.normal(size=(e, d)).astype(np.float32)
    got = _schedule(msgs, dst, n, span_rows)
    deg = np.bincount(dst, minlength=n)
    assert deg.max() > 10 * span_rows or span_rows == 512
    short = deg <= 64
    oracle = np.asarray(jref.csr_segment_sum(jnp.asarray(msgs),
                                             jnp.asarray(dst), n))
    np.testing.assert_allclose(got[short], oracle[short], **TOL)
    np.testing.assert_allclose(got[~short], _exact(msgs, dst, n)[~short],
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(_port(msgs, dst, n)[short], got[short], **TOL)


@pytest.mark.parametrize("e,span_rows", [
    (64, 16),      # every segment ends exactly on a span edge
    (64, 8),       # two whole spans, short: it ends L = 8 rows past the first
    (64, 4),       # four whole spans, long: its pieces added in span order
    (48, 16),      # the last span ends with a segment ending on E
])
def test_schedule_segments_ending_on_span_edges(e, span_rows):
    n, d = 6, 3
    dst = np.repeat(np.arange(e // 16), 16).astype(np.int32)
    msgs = RNG.normal(size=(e, d)).astype(np.float32)
    got = _schedule(msgs, dst, n, span_rows)
    np.testing.assert_allclose(got, _pallas(msgs, dst, n, 128, 16), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.csr_segment_sum(
        jnp.asarray(msgs), jnp.asarray(dst), n)), **TOL)
    assert not got[e // 16:].any()


@pytest.mark.parametrize("e,n", [(1, 3), (37, 50), (200, 20)])
def test_schedule_fewer_rows_than_one_span(e, n):
    """E below one span: one span reads every row, the wrapper launches once
    (no fix-up)."""
    d = 5
    dst = np.sort(RNG.integers(0, n, size=e)).astype(np.int32)
    msgs = RNG.normal(size=(e, d)).astype(np.float32)
    rows, spans = kernel.plan(e, d)
    assert rows > e and spans == 1 and kernel.launches(e, d) == 1
    got = _schedule(msgs, dst, n, rows)
    np.testing.assert_allclose(got, np.asarray(jref.csr_segment_sum(
        jnp.asarray(msgs), jnp.asarray(dst), n)), **TOL)
    np.testing.assert_allclose(got, _port(msgs, dst, n), **TOL)


def test_plan_spans_by_bytes():
    """Spans hold SPAN_BYTES of rows, capped at MAX_SPAN_ROWS; more than one
    span adds the fix-up launch."""
    assert kernel.plan(61_859_328, 128) == (256, 241_638)
    assert kernel.plan(10, 1) == (kernel.MAX_SPAN_ROWS, 1)
    assert kernel.plan(5000, 1433)[0] == kernel.SPAN_BYTES // (4 * 1433)
    assert kernel.plan(0, 8) == (kernel.MAX_SPAN_ROWS, 1)
    assert kernel.launches(61_859_328, 128) == 2
