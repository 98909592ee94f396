"""The port's all-pairs distance (``ops.distance_matrix`` on CPU tensors,
the plain version the CUDA kernel is held against on the card) against
the JAX package's Pallas kernel in interpret mode and its oracle.

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
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(0)
METRICS = ["l2", "cos", "dot"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _case(b, n, d):
    return (RNG.normal(size=(b, d)).astype(np.float32),
            RNG.normal(size=(n, d)).astype(np.float32))


def _port(Q, X, metric):
    before = kernel.LAUNCHES
    got = ops.distance_matrix(torch.from_numpy(Q), torch.from_numpy(X),
                              metric)
    assert kernel.LAUNCHES == before          # a CPU tensor launches nothing
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
