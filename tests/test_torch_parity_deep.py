"""The port against the JAX package at the card's search shape: k = 100,
efs = 200.

The other parity tests run at k <= 10 and efs <= 40, where a sigma 0.01
mask of their 2500 rows holds fewer rows than the card's k. Here the index
is 20,000 x 16 (``gaussian_mixture``, 20 clusters), built once by the
port with the bench preset (``BENCH_INDEX``: m_u 16, efc 100) and handed
to the reference as the same arrays, so every lane's mask holds at least k
rows at sigma 0.01 (sigma * n = 2k).
Both packages get the same queries and per-lane masks, at sigma 0.01, 0.03
and 0.1 under the adaptive-local heuristic, f32- and int8-resident
(the int8 arm through ``search_quantized_many``: the beam on the codes,
then the exact re-rank). Ids and every ``SearchStats`` field are equal,
dists allclose at rtol 1e-5 (XLA and torch may sum in another order; the
tolerance of ``tests/test_torch_search.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from repro.core.graph import HnswGraph as JHnswGraph
from repro.core.navix import NavixConfig as JNavixConfig
from repro.core.navix import NavixIndex as JNavixIndex
from repro.data.synthetic import gaussian_mixture
from repro_torch.configs.navix_paper import BENCH_INDEX
from repro_torch.core.navix import NavixIndex

N, DIM, CLUSTERS = 20_000, 16, 20
K, EFS = 100, 200
LANES = 32
SIGMAS = (0.01, 0.03, 0.1)


@pytest.fixture(scope="module")
def env():
    """(reference index, port index on the CPU, queries)."""
    X, _, centers = gaussian_mixture(N, DIM, CLUSTERS, seed=0)
    port, _ = NavixIndex.create(X, BENCH_INDEX, device="cpu")
    ref = JNavixIndex(graph=JHnswGraph(*(jnp.asarray(t.numpy())
                                         for t in port.graph)),
                      config=JNavixConfig(**BENCH_INDEX._asdict()))
    rng = np.random.default_rng(7)
    base = centers[rng.integers(0, CLUSTERS, size=LANES)]
    qs = (base + 0.3 * rng.normal(size=base.shape)).astype(np.float32)
    return ref, port, qs


@pytest.fixture(scope="module")
def port_int8(env):
    return env[1].quantize_resident()


def _masks(sigma, seed):
    masks = np.random.default_rng(seed).random((LANES, N)) < sigma
    assert (masks.sum(1) >= K).all(), "every lane's mask must hold k rows"
    return list(masks)


def _assert_matches_reference(port, ref):
    assert port.ids.shape == (LANES, K)
    np.testing.assert_array_equal(port.ids.numpy(), np.asarray(ref.ids))
    for f in ref.stats._fields:
        np.testing.assert_array_equal(getattr(port.stats, f).numpy(),
                                      np.asarray(getattr(ref.stats, f)),
                                      err_msg=f"stats.{f}")
    np.testing.assert_allclose(port.dists.numpy(), np.asarray(ref.dists),
                               rtol=1e-5)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_f32_matches_reference_at_card_shape(env, sigma):
    ref, port, qs = env
    masks = _masks(sigma, seed=int(sigma * 1000))
    _assert_matches_reference(
        port.search_many(qs, k=K, efs=EFS, semimask=masks,
                         heuristic="adaptive_local"),
        ref.search_many(qs, k=K, efs=EFS, semimask=masks,
                        heuristic="adaptive_local"))


@pytest.mark.parametrize("sigma", SIGMAS)
def test_int8_matches_reference_at_card_shape(env, port_int8, sigma):
    ref, _, qs = env
    masks = _masks(sigma, seed=int(sigma * 1000) + 1)
    _assert_matches_reference(
        port_int8.search_quantized_many(qs, k=K, efs=EFS, semimask=masks,
                                        heuristic="adaptive_local"),
        ref.search_quantized_many(qs, k=K, efs=EFS, semimask=masks,
                                  heuristic="adaptive_local"))
