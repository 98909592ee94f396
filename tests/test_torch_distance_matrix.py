"""The port's all-pairs distance (``ops.distance_matrix`` on CPU tensors,
the plain version the CUDA kernel is held against on the card) against
the JAX package's Pallas kernel in interpret mode and its oracle; and the
CUDA wrapper's shape-to-path rule and range checks, which need no card.

Tolerance rtol/atol 1e-4, the reference's own for this kernel
(``tests/test_kernels.py``): a different f32 summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.distance_matrix import distance_matrix_pallas
from repro_torch.kernels import distance_matrix as kernel
from repro_torch.kernels import ops, quantized, ref

RNG = np.random.default_rng(0)
METRICS = ["l2", "cos", "dot"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _case(b, n, d):
    return (RNG.normal(size=(b, d)).astype(np.float32),
            RNG.normal(size=(n, d)).astype(np.float32))


def _port(Q, X, metric):
    before = kernel.LAUNCHES, dict(kernel.PATH_LAUNCHES)
    got = ops.distance_matrix(torch.from_numpy(Q), torch.from_numpy(X),
                              metric)
    # a CPU tensor launches nothing, on either path
    assert (kernel.LAUNCHES, kernel.PATH_LAUNCHES) == before
    assert got.dtype == torch.float32
    assert got.shape == (Q.shape[0], X.shape[0])
    return got.numpy()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,n,d,bq,bn,bd", [
    (8, 128, 128, 8, 128, 128),
    (16, 256, 256, 16, 128, 128),
    (32, 384, 128, 8, 128, 128),
])
def test_matches_pallas_interpret_and_oracle(metric, b, n, d, bq, bn, bd):
    Q, X = _case(b, n, d)
    got = _port(Q, X, metric)
    pallas = distance_matrix_pallas(jnp.asarray(Q), jnp.asarray(X), metric,
                                    bq=bq, bn=bn, bd=bd, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.distance_matrix(
        jnp.asarray(Q), jnp.asarray(X), metric)), **TOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,n,d", [
    (5, 77, 61),       # every axis off the tile
    (1, 300, 32),      # the retrieval step's b = 1, at its d
    (1, 129, 7),
])
def test_odd_shapes_match_padded_pallas(monkeypatch, metric, b, n, d):
    """The reference pads these shapes to its tiles (``ops.distance_matrix``
    with the Pallas kernel forced, interpret mode on the CPU)."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    Q, X = _case(b, n, d)
    got = _port(Q, X, metric)
    want = jops.distance_matrix(jnp.asarray(Q), jnp.asarray(X), metric)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_bfloat16_queries_match_oracle(metric):
    """Q in bf16: both sides widen it to f32 before any product."""
    Q, X = _case(16, 256, 64)
    Qb = torch.from_numpy(Q).to(torch.bfloat16)
    got = ops.distance_matrix(Qb, torch.from_numpy(X), metric)
    want = jref.distance_matrix(jnp.asarray(Q, jnp.bfloat16), jnp.asarray(X),
                                metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unknown_metric_raises():
    Q, X = _case(2, 3, 4)
    with pytest.raises(ValueError):
        ref.distance_matrix(torch.from_numpy(Q), torch.from_numpy(X), "ip")


@pytest.mark.parametrize("b,path", [(1, "stream"), (16, "stream"),
                                    (17, "wgmma"), (512, "wgmma")])
@pytest.mark.parametrize("d,vec", [(32, True), (960, True), (33, False),
                                   (61, False)])
def test_plan_picks_the_path_by_batch_and_the_loads_by_width(b, path, d, vec):
    """b <= 16 streams, larger batches run on the tensor cores; rows whose
    byte width is a multiple of 16 take 16-byte loads."""
    Q, X = torch.zeros((b, d)), torch.zeros((5, d))
    assert kernel.plan(Q, X) == (path, vec)
    assert (b <= kernel.STREAM_MAX_BATCH) == (path == "stream")


@pytest.mark.parametrize("q_off,x_off", [(1, 0), (0, 1), (2, 2)])
def test_plan_takes_4_byte_loads_off_16_byte_alignment(q_off, x_off):
    """d % 4 == 0 is not enough: a view that starts 4 or 8 bytes into its
    storage takes the 4-byte loads."""
    d = 32
    Q = torch.zeros((3 * d + q_off,))[q_off:].view(3, d)
    X = torch.zeros((7 * d + x_off,))[x_off:].view(7, d)
    assert kernel.plan(Q, X) == ("stream", False)
    assert kernel.plan(Q.clone(), X.clone()) == ("stream", True)


def _wide(rows, d=4):
    """A [rows, d] f32 view of one stored row: no memory for huge rows."""
    return torch.zeros((1, d)).expand(rows, d)


@pytest.mark.parametrize("Q,X,metric,error", [
    (torch.zeros((2, 4), dtype=torch.float64), torch.zeros((3, 4)), "l2",
     TypeError),                                      # Q's dtype
    (torch.zeros((2, 4)), torch.zeros((3, 4), dtype=torch.float16), "l2",
     TypeError),                                      # X's dtype
    (torch.zeros((2, 4)), torch.zeros((3, 5)), "l2", ValueError),   # widths
    (torch.zeros((4,)), torch.zeros((3, 4)), "l2", ValueError),     # 1-D Q
    (torch.zeros((2, 0)), torch.zeros((3, 0)), "l2", ValueError),   # d = 0
    (torch.zeros((2, 4)), torch.zeros((3, 4)), "ip", ValueError),   # metric
    (_wide(2 ** 31), torch.zeros((3, 4)), "dot", ValueError),       # b
    (torch.zeros((2, 4)), _wide(2 ** 31), "dot", ValueError),       # n
])
def test_range_checks_raise_without_a_card(Q, X, metric, error):
    with pytest.raises(error):
        kernel.check_matrix_shapes(Q, X, metric)


def test_max_batch_is_the_kernels_and_kernel_6_keeps_its_own():
    """b up to ``MAX_BATCH`` (a C int) passes this kernel's checks; the
    int8 kernel checks b against its own limit, ``quantized.MAX_BATCH``,
    and refuses a batch past it."""
    assert kernel.MAX_BATCH == 2 ** 31 - 1
    kernel.check_matrix_shapes(_wide(kernel.MAX_BATCH), _wide(3), "dot")
    codes, scale = torch.zeros((3, 4), dtype=torch.int8), torch.zeros(3)
    quantized.check_shapes(_wide(quantized.MAX_BATCH), codes, scale, "dot")
    with pytest.raises(ValueError, match="range"):
        quantized.check_shapes(_wide(quantized.MAX_BATCH + 1), codes, scale,
                               "dot")


def test_wrapper_checks_the_device_before_the_shapes():
    """On the CPU the wrapper refuses the tensors before it looks at them,
    and counts no launch."""
    before = kernel.LAUNCHES, dict(kernel.PATH_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernel.distance_matrix(torch.zeros((2, 4), dtype=torch.float64),
                               torch.zeros((3, 4)), "dot")
    assert (kernel.LAUNCHES, kernel.PATH_LAUNCHES) == before
