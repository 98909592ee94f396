"""The port's shared forward layers against the JAX package's.

``softcap``, ``mha`` (GQA groups 1 and 2, a partial mask with a fully
masked query row, no cap and a cap of 50, the default and a given scale),
``gated_mlp`` (swiglu and geglu, on a matrix and on a [B, S, d] stack) and
``mlp_stack`` (with and without a final activation and biases), each on
inputs made with numpy from a seed, at rtol 1e-5 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-6)


def _both(a: np.ndarray):
    return torch.from_numpy(a), jnp.asarray(a)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cap", [0.0, 3.0, 50.0])
def test_softcap_matches_reference(cap):
    x = np.random.default_rng(0).normal(scale=40.0, size=(7, 33))
    t, j = _both(x.astype(np.float32))
    got = L.softcap(t, cap)
    assert got.dtype == torch.float32
    _close(got, JL.softcap(j, cap))
    if cap <= 0.0:
        assert got is t


def _attention_inputs(seed, b, sq, skv, kvh, groups, hd):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, kvh * groups, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)
    mask = rng.random((b, sq, skv)) < 0.6
    mask[0, 1] = False                  # a query that sees nothing
    mask[1, :, 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("logit_cap", [0.0, 50.0])
@pytest.mark.parametrize("scale", [None, 0.7])
def test_mha_matches_reference(groups, logit_cap, scale):
    q, k, v, mask = _attention_inputs(groups, 2, 5, 7, 2, groups, 8)
    # large logits, so that the cap of 50 bites
    q *= 6.0
    got = L.mha(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                logit_cap=logit_cap, scale=scale)
    want = JL.mha(*(jnp.asarray(a) for a in (q, k, v, mask)),
                  logit_cap=logit_cap, scale=scale)
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, want)


def test_mha_with_everything_masked_averages_the_values():
    """A row with no visible key: every logit is -1e30, so the softmax is
    uniform and the output is the mean of v, as in the reference."""
    q, k, v, mask = _attention_inputs(5, 2, 5, 7, 2, 2, 8)
    got = L.mha(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    mean_v = v[0].mean(axis=0)                        # [KV, hd]
    np.testing.assert_allclose(got[0, 1].numpy().reshape(2, 2, 8),
                               np.repeat(mean_v[:, None], 2, axis=1),
                               **TOL)


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
@pytest.mark.parametrize("lead", [(9,), (3, 4)])
def test_gated_mlp_matches_reference(activation, lead):
    rng = np.random.default_rng(1)
    d, f = 12, 20
    x = rng.normal(size=lead + (d,)).astype(np.float32)
    p = {"wi": rng.normal(size=(d, 2 * f)).astype(np.float32) / 3,
         "wo": rng.normal(size=(f, d)).astype(np.float32) / 4}
    got = L.gated_mlp({k: torch.from_numpy(w) for k, w in p.items()},
                      torch.from_numpy(x), activation)
    want = JL.gated_mlp({k: jnp.asarray(w) for k, w in p.items()},
                        jnp.asarray(x), activation)
    assert got.shape == x.shape
    _close(got, want)


def test_gated_mlp_names_an_unknown_activation():
    p = {"wi": torch.zeros(4, 6), "wo": torch.zeros(3, 4)}
    with pytest.raises(ValueError, match="relu"):
        L.gated_mlp(p, torch.zeros(2, 4), "relu")


@pytest.mark.parametrize("final_act", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_mlp_stack_matches_reference(final_act, bias):
    rng = np.random.default_rng(2)
    dims = [11, 16, 8, 3]
    layers = []
    for i in range(len(dims) - 1):
        lay = {"w": rng.normal(size=(dims[i], dims[i + 1])
                               ).astype(np.float32) / 3}
        if bias:
            lay["b"] = rng.normal(size=(dims[i + 1],)).astype(np.float32)
        layers.append(lay)
    x = rng.normal(size=(6, dims[0])).astype(np.float32)
    tp = {"layers": tuple({k: torch.from_numpy(w) for k, w in lay.items()}
                          for lay in layers)}
    jp = {"layers": tuple({k: jnp.asarray(w) for k, w in lay.items()}
                          for lay in layers)}
    got = L.mlp_stack(tp, torch.from_numpy(x), final_act=final_act)
    want = JL.mlp_stack(jp, jnp.asarray(x), final_act=final_act)
    assert got.shape == (6, 3)
    _close(got, want)
    if final_act:
        assert bool((got >= 0).all())


def test_products_of_two_dtypes_run_in_the_promoted_one():
    """bf16 activations against f32 weights: f32 out, as ``jnp`` gives."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    p = {"layers": ({"w": torch.from_numpy(
        rng.normal(size=(8, 4)).astype(np.float32))},)}
    got = L.mlp_stack(p, x.to(torch.bfloat16))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, x.to(torch.bfloat16).float()
                               @ p["layers"][0]["w"])
