"""The port's shared forward layers against the JAX package's.

``softcap``, ``mha`` (GQA groups 1 and 2, a partial mask with a fully
masked query row, no cap and a cap of 50, the default and a given scale),
``gated_mlp`` (swiglu and geglu, on a matrix and on a [B, S, d] stack) and
``mlp_stack`` (with and without a final activation and biases), each on
inputs made with numpy from a seed, at rtol 1e-5 / atol 1e-6. The LM
layers: ``rmsnorm`` (f32 and bf16, scales from a seed), ``rope`` (f32 and
bf16, theta 1e4 and 1e6, positions up to 8191), ``attention_mask`` (causal
or not, windows) and ``chunked_mha`` (chunks of 16 over 40 keys, so the
last is padded; causal and not, a window, caps, GQA; bf16 within a stated
tolerance), and ``chunked_mha`` against ``mha`` in the port itself.
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 5, 24)) * 3).astype(np.float32)
    scale = rng.normal(size=(24,)).astype(np.float32) * 0.1
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = L.rmsnorm({"scale": torch.from_numpy(scale).to(tdt)},
                    torch.from_numpy(x).to(tdt), 1e-6)
    want = JL.rmsnorm({"scale": jnp.asarray(scale, jdt)},
                      jnp.asarray(x, jdt), 1e-6)
    assert got.dtype == tdt
    # the same f32 arithmetic up to the mean's order and rsqrt's last bit;
    # in bf16 one rounding after it, so at most one bf16 ulp apart
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=1e-6)
    init = L.rmsnorm_init(24, dtype, "cpu", layers=3)
    assert init["scale"].shape == (3, 24) and not init["scale"].any()


@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-5, atol=1e-5)),
                                       ("bfloat16", dict(rtol=0, atol=0.0))])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(dtype, tol, theta):
    """Positions up to 8191 (the card's long prompt). f32 at 1e-5: the
    angle ``pos * freq`` reaches 8191 rad, where one ulp of freq moves it
    by ~5e-4; the two packages' ``theta ** x`` agree at these sizes (the
    test would show it). bf16 rounds both to the same values."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(6), np.array([0, 1, 511, 4095, 8190, 8191])]
                   ).astype(np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = L.rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), theta)
    want = JL.rope(jnp.asarray(x, jdt), jnp.asarray(pos), theta)
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [3, 1 << 30])
def test_attention_mask_matches_reference(causal, window):
    q = np.array([[0, 2, 5, 9]], np.int32)
    kv = np.array([[0, 1, 2, 5, 6, 9, -1]], np.int32)
    got = L.attention_mask(torch.from_numpy(q), torch.from_numpy(kv),
                           causal=causal, window=window)
    want = JL.attention_mask(jnp.asarray(q), jnp.asarray(kv), causal=causal,
                             window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _chunked_inputs(seed, groups, dtype=np.float32):
    q, k, v, _ = _attention_inputs(seed, 2, 40, 40, 2, groups, 8)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    return (q * 4).astype(dtype), k.astype(dtype), v.astype(dtype), pos


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("causal,window", [(True, 1 << 30), (True, 7),
                                           (False, 1 << 30)])
@pytest.mark.parametrize("logit_cap", [0.0, 5.0])
def test_chunked_mha_matches_reference(groups, causal, window, logit_cap):
    q, k, v, pos = _chunked_inputs(6, groups)
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, chunk=16)
    got = L.chunked_mha(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)),
                        **kw)
    want = JL.chunked_mha(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                          **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, want)
    # the one-pass form on the same mask, in the port
    mask = L.attention_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                            causal=causal, window=window)
    full = L.mha(*(torch.from_numpy(a) for a in (q, k, v)), mask,
                 logit_cap=logit_cap)
    torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-5)


def test_chunked_mha_in_bf16_matches_reference():
    """bf16 q, k, v: q is scaled in f32 (the reference's numpy scale
    promotes it), the probabilities are rounded to bf16 before they weigh
    v, the output is rounded to bf16; within 1 bf16 ulp of the output's
    scale (2 ** -7 of |out| <= 4) of the reference's."""
    q, k, v, pos = _chunked_inputs(7, 2)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    kw = dict(causal=True, window=9, logit_cap=50.0, chunk=16)
    got = L.chunked_mha(tq, tk, tv, torch.from_numpy(pos),
                        torch.from_numpy(pos), **kw)
    want = JL.chunked_mha(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                          **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2.0 ** -6)


def test_chunked_mha_backward_recomputes_each_chunk():
    """With grad enabled every chunk runs under ``torch.utils.checkpoint``;
    the gradient equals the one-pass ``mha``'s."""
    q, k, v, pos = _chunked_inputs(8, 2)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tp = torch.from_numpy(pos)
    out = L.chunked_mha(*ts, tp, tp, causal=True, window=11, chunk=16)
    grads = torch.autograd.grad(out.square().sum(), ts)
    ts2 = [t.detach().requires_grad_(True) for t in ts]
    mask = L.attention_mask(tp, tp, causal=True, window=11)
    full = L.mha(*ts2, mask)
    want = torch.autograd.grad(full.square().sum(), ts2)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
