"""The port's all-pairs int8 distance (``ops.quantized_distance_matrix`` on
CPU tensors, the plain version the CUDA kernel is held against on the card)
against the JAX package's Pallas kernel in interpret mode and its oracle.

Tolerance rtol/atol 1e-3, the reference's own for this kernel
(``tests/test_kernels.py``): the kernel scales q.c last, the plain version
dequantizes the rows first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quantized import quantized_distance_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import quantized as kernel

RNG = np.random.default_rng(0)
METRICS = ["l2", "cos", "dot"]
TOL = dict(rtol=1e-3, atol=1e-3)


def _case(b, n, d):
    Q = RNG.normal(size=(b, d)).astype(np.float32)
    codes = RNG.integers(-127, 128, size=(n, d)).astype(np.int8)
    scale = (RNG.random(n) * 0.02 + 1e-3).astype(np.float32)
    return Q, codes, scale


def _port(Q, codes, scale, metric):
    before = kernel.LAUNCHES
    got = ops.quantized_distance_matrix(
        torch.from_numpy(Q), torch.from_numpy(codes), torch.from_numpy(scale),
        metric)
    assert kernel.LAUNCHES == before          # a CPU tensor launches nothing
    assert got.dtype == torch.float32
    assert got.shape == (Q.shape[0], codes.shape[0])
    return got.numpy()


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,n,d", [(8, 128, 128), (16, 256, 256)])
def test_matches_pallas_interpret_and_oracle(metric, b, n, d):
    Q, codes, scale = _case(b, n, d)
    got = _port(Q, codes, scale, metric)
    pallas = quantized_distance_pallas(*_jax(Q, codes, scale), metric, bq=8,
                                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.quantized_distance_matrix(
        *_jax(Q, codes, scale), metric)), **TOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,n,d", [
    (5, 130, 61),      # every axis off the 128 tile
    (3, 127, 32),      # n one short of a tile
    (9, 200, 100),
    (1, 70, 48),       # one query
])
def test_odd_shapes_match_padded_pallas(monkeypatch, metric, b, n, d):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    Q, codes, scale = _case(b, n, d)
    got = _port(Q, codes, scale, metric)
    want = jops.quantized_distance_matrix(*_jax(Q, codes, scale), metric)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_zero_scale_rows(monkeypatch):
    """Zero-scale rows inside the store (all-zero vectors) under l2: their
    distance is ||q||^2, finite, as in the reference's kernel."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    Q, codes, scale = _case(4, 70, 48)
    scale[::7] = 0.0
    got = _port(Q, codes, scale, "l2")
    want = np.asarray(jops.quantized_distance_matrix(*_jax(Q, codes, scale),
                                                     "l2"))
    np.testing.assert_allclose(got, want, **TOL)
    qn = np.sum(Q.astype(np.float64) ** 2, axis=1)
    np.testing.assert_allclose(got[:, ::7], np.broadcast_to(
        qn[:, None], got[:, ::7].shape), **TOL)
    assert np.isfinite(got).all()
