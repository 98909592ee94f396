"""The plain PyTorch gather-distance against the JAX package's oracle and
its Pallas kernel (interpret mode, as tests/test_kernels.py runs it).

``kernels/ref.py::gather_distance_batch`` is what the CUDA kernel is held
against on the card, and what a CPU tensor runs; here it must match
``repro.kernels.ref.gather_distance_batch`` and
``gather_distance_batch_pallas(..., interpret=True)`` for every metric,
with -1 padding and out-of-range ids (>= n, clamped to row n-1), at
rtol 1e-5 / atol 1e-5 (different f32 summation order). +inf must sit at
exactly the same places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.gather_distance import gather_distance_batch_pallas
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(0)
METRICS = ["l2", "cos", "dot"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(b, n, d, k):
    Q = RNG.normal(size=(b, d)).astype(np.float32)
    X = RNG.normal(size=(n, d)).astype(np.float32)
    ids = RNG.integers(-1, n + 3, size=(b, k)).astype(np.int32)
    ids[0] = -1                                  # a fully retired lane
    return Q, X, ids


def _check(got: np.ndarray, want: np.ndarray):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,n,d,k", [(4, 64, 128, 7), (8, 128, 128, 16),
                                     (3, 100, 33, 5)])
def test_plain_matches_reference_oracle(metric, b, n, d, k):
    Q, X, ids = _case(b, n, d, k)
    got = ref.gather_distance_batch(torch.from_numpy(Q), torch.from_numpy(X),
                                    torch.from_numpy(ids), metric)
    assert got.dtype == torch.float32 and got.shape == (b, k)
    _check(got.numpy(), np.asarray(jref.gather_distance_batch(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(np.clip(ids, -1, n - 1)),
        metric)))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,n,d,k", [(4, 64, 128, 7), (2, 100, 256, 5)])
def test_plain_matches_pallas_interpret(metric, b, n, d, k):
    Q, X, ids = _case(b, n, d, k)
    got = ops.gather_distance_batch(torch.from_numpy(Q), torch.from_numpy(X),
                                    torch.from_numpy(ids), metric)
    want = gather_distance_batch_pallas(jnp.asarray(Q), jnp.asarray(X),
                                        jnp.asarray(ids), metric,
                                        interpret=True)
    _check(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", METRICS)
def test_single_query_plain_matches_reference(metric):
    Q, X, ids = _case(2, 50, 40, 9)
    got = ref.gather_distance(torch.from_numpy(Q[1]), torch.from_numpy(X),
                              torch.from_numpy(ids[1]), metric)
    _check(got.numpy(), np.asarray(jref.gather_distance(
        jnp.asarray(Q[1]), jnp.asarray(X),
        jnp.asarray(np.clip(ids[1], -1, 49)), metric)))


def test_out_of_range_ids_read_the_last_row():
    X = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    Q = torch.zeros((1, 3))
    ids = torch.tensor([[3, 4, 1000, -1, -7]], dtype=torch.int32)
    got = ref.gather_distance_batch(Q, X, ids, "l2")
    last = float((X[3] ** 2).sum())
    assert got[0, :3].tolist() == [last] * 3
    assert torch.isinf(got[0, 3:]).all()
