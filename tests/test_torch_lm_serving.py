"""The port's LM serving path against the JAX package's: ``prefill``,
``decode_step`` with its KV cache, ``greedy_generate`` and the prefill and
decode steps.

For the five LM archs' SMOKE configs (f32), with the reference's
parameters carried across by ``params_from_numpy`` and prompts made with
numpy from a seed: ``prefill``'s last-position logits and its ``KVCache``
(k, v, length), then two ``decode_step``s' logits and caches, at rtol 1e-5
/ atol 1e-5; ``greedy_generate``'s tokens (8-token prompts, 4 new tokens)
equal the reference's. gemma2-9b SMOKE in bf16 (parameters and compute):
prefill and decode logits within 1/16 of the reference's (a logit of
|x| <= 1 is rounded to bf16, 2^-8 relative, at the head; the layers below
round differently in the two packages; measured <= 0.0083) and the greedy
tokens equal wherever the reference's top-2 gap exceeds twice the logits'
difference (one exact bf16 tie at this seed, named in the test).
The port's cache is written in place (a deliberate difference: the
reference's ``decode_step`` returns a new cache): the step returns the
cache it was given, and two reference steps equal the port's two in
sequence. The reference's serving tests (decode matches forward, the
local window, ``greedy_generate``'s shapes) run on the port too.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import get_arch as jget_arch
from repro.models import api as japi
from repro.models import transformer as JT
from repro.serving.engine import greedy_generate as jgreedy_generate
from repro_torch.config.base import get_arch
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.serving import greedy_generate

LM_ARCHS = ["gemma-7b", "qwen1.5-0.5b", "gemma2-9b", "kimi-k2-1t-a32b",
            "granite-moe-3b-a800m"]
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
B, PROMPT, MAX_LEN = 2, 20, 24
BF16_ATOL = 1 / 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ints(cfg, seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _reference_serving(jcfg, jparams, prompt, steps, greedy_prompt):
    """The reference's prefill, ``len(steps)`` decode steps and greedy
    tokens, each jitted once."""
    pre = jax.jit(functools.partial(JT.prefill, jcfg),
                  static_argnames="max_len")
    dec = jax.jit(functools.partial(JT.decode_step, jcfg))
    cache, logits = pre(jparams, jnp.asarray(prompt), max_len=MAX_LEN)
    out = {"prefill": (_np_tree(cache), np.asarray(logits)), "decode": []}
    for tok in steps:
        cache, logits = dec(jparams, cache, jnp.asarray(tok))
        out["decode"].append((_np_tree(cache), np.asarray(logits)))
    out["greedy"] = jgreedy_generate(jcfg, jparams, greedy_prompt, n_new=4)
    return out


@pytest.fixture(scope="module", params=LM_ARCHS)
def served(request):
    """(port config, port params, the inputs, the reference's outputs)."""
    jcfg = jget_arch(request.param).smoke_config
    cfg = get_arch(request.param).smoke_config
    jparams = jax.jit(japi.model_api(jcfg).init)(jax.random.key(1))
    prompt = _ints(cfg, 2, (B, PROMPT))
    steps = [_ints(cfg, 3 + i, (B,)) for i in range(2)]
    greedy_prompt = _ints(cfg, 5, (B, 8))
    ref = _reference_serving(jcfg, jparams, prompt, steps, greedy_prompt)
    params = T.params_from_numpy(cfg, _np_tree(jparams), CPU)
    return cfg, params, (prompt, steps, greedy_prompt), ref


def _check_cache(cache, want, where):
    assert isinstance(cache, T.KVCache)
    assert cache.length.dtype == torch.int32 and cache.length.shape == ()
    assert int(cache.length) == int(want.length), where
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(cache, name).numpy(),
                                   getattr(want, name), err_msg=where, **TOL)


def test_prefill_and_two_decode_steps_match_reference(served):
    cfg, params, (prompt, steps, _), ref = served
    cache, logits = api.make_prefill_step(cfg)(params,
                                               torch.from_numpy(prompt))
    assert logits.shape == (B, cfg.vocab_size)
    assert logits.dtype == torch.float32 and not logits.requires_grad
    np.testing.assert_allclose(logits.numpy(), ref["prefill"][1], **TOL)
    # max_len past the prompt: the reference pads with zeros
    cache, logits = T.prefill(cfg, params, torch.from_numpy(prompt),
                              max_len=MAX_LEN)
    _check_cache(cache, ref["prefill"][0], "prefill")
    assert not cache.k[:, :, PROMPT:].any()
    dec = api.make_decode_step(cfg)
    for i, (tok, (want_cache, want)) in enumerate(zip(steps,
                                                      ref["decode"])):
        cache, logits = dec(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(logits.numpy(), want, err_msg=f"step {i}",
                                   **TOL)
        _check_cache(cache, want_cache, f"decode step {i}")


def test_greedy_generate_matches_reference(served):
    cfg, params, (_, _, greedy_prompt), ref = served
    got = greedy_generate(cfg, params, greedy_prompt, n_new=4)
    assert got.shape == (B, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(ref["greedy"]))


def test_greedy_generate_returns_the_last_decode_logits(served):
    """``return_logits``: the logits of the last decode step, which fed
    the last new token: those of a prefill of the prompt and every new
    token."""
    cfg, params, (_, _, greedy_prompt), _ = served
    if cfg.moe is not None:      # no drops: a prefill's T differs
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    got, logits = greedy_generate(cfg, params, greedy_prompt, n_new=4,
                                  return_logits=True)
    full = np.concatenate([greedy_prompt, got], axis=1)
    _, want = T.prefill(cfg, params, torch.from_numpy(full))
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_decode_step_updates_the_cache_in_place(served):
    """The port's deliberate difference: ``decode_step`` writes the new
    K/V and the length into the cache it is given and returns it; the
    reference's two steps from one cache (each returning a new cache)
    equal the port's two steps in sequence."""
    cfg, params, (prompt, steps, _), ref = served
    cache, _ = T.prefill(cfg, params, torch.from_numpy(prompt),
                         max_len=MAX_LEN)
    k_ptr, length = cache.k.data_ptr(), cache.length
    with torch.no_grad():
        out, _ = T.decode_step(cfg, params, cache, torch.from_numpy(steps[0]))
        assert out is cache and out.k.data_ptr() == k_ptr
        assert out.length is length and int(length) == PROMPT + 1
        out, _ = T.decode_step(cfg, params, out, torch.from_numpy(steps[1]))
    _check_cache(cache, ref["decode"][1][0], "two steps in place")


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "gemma2-9b"])
def test_decode_from_an_empty_cache_matches_reference(arch_id):
    """``init_cache`` (zeros in the compute dtype, length 0 on the device)
    and three decode steps from it, against the reference's."""
    jcfg = jget_arch(arch_id).smoke_config
    cfg = get_arch(arch_id).smoke_config
    jparams = jax.jit(japi.model_api(jcfg).init)(jax.random.key(2))
    params = T.params_from_numpy(cfg, _np_tree(jparams), CPU)
    toks = _ints(cfg, 12, (3, B))
    dec = jax.jit(functools.partial(JT.decode_step, jcfg))
    jcache = JT.init_cache(jcfg, B, 6)
    cache = T.init_cache(cfg, B, 6, device="cpu")
    assert cache.k.shape == jcache.k.shape and cache.k.dtype == torch.float32
    assert int(cache.length) == 0 and not cache.v.any()
    with torch.no_grad():
        for tok in toks:
            jcache, want = dec(jparams, jcache, jnp.asarray(tok))
            cache, got = T.decode_step(cfg, params, cache,
                                       torch.from_numpy(tok))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_cache(cache, _np_tree(jcache), "three steps from empty")


@pytest.fixture(scope="module")
def bf16_served():
    """gemma2-9b SMOKE with bf16 parameters and compute: the reference's
    outputs on its own bf16 parameters (and the logits of each of its
    greedy steps), and the port's tree from them."""
    jcfg = dataclasses.replace(jget_arch("gemma2-9b").smoke_config,
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("gemma2-9b").smoke_config,
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jparams = jax.jit(japi.model_api(jcfg).init)(jax.random.key(7))
    prompt = _ints(cfg, 8, (B, PROMPT))
    steps = [_ints(cfg, 9 + i, (B,)) for i in range(2)]
    greedy_prompt = _ints(cfg, 11, (B, 8))
    ref = _reference_serving(jcfg, jparams, prompt, steps, greedy_prompt)
    cache, logits = JT.prefill(jcfg, jparams, jnp.asarray(greedy_prompt),
                               max_len=12)
    ref["greedy_logits"] = []
    for tok in np.asarray(ref["greedy"]).T:
        ref["greedy_logits"].append(np.asarray(logits))
        cache, logits = JT.decode_step(jcfg, jparams, cache, jnp.asarray(tok))
    params = T.params_from_numpy(cfg, _np_tree(jparams), CPU)
    return cfg, params, (prompt, steps, greedy_prompt), ref


def test_bf16_serving_matches_reference(bf16_served):
    """Prefill and decode logits within ``BF16_ATOL``. The greedy tokens:
    along the reference's greedy path (the port fed the reference's
    tokens), the port picks the reference's token at every step where
    the reference's top-2 gap exceeds twice the logits' difference there.
    One step at this seed is a named near-tie: row 0's third token, where
    the reference's bf16 logits of tokens 140 and 487 are equal (gap 0;
    it takes the lower id) and the port's differ by one bf16 ulp in
    487's favour. So ``greedy_generate`` equals the reference's tokens
    except row 0 from its third token on."""
    cfg, params, (prompt, steps, greedy_prompt), ref = bf16_served
    assert params["embed"].dtype == torch.bfloat16
    cache, logits = T.prefill(cfg, params, torch.from_numpy(prompt),
                              max_len=MAX_LEN)
    assert cache.k.dtype == torch.bfloat16 and logits.dtype == torch.float32
    errs = [float(np.abs(logits.numpy() - ref["prefill"][1]).max())]
    with torch.no_grad():
        for tok, (_, want) in zip(steps, ref["decode"]):
            cache, logits = T.decode_step(cfg, params, cache,
                                          torch.from_numpy(tok))
            errs.append(float(np.abs(logits.numpy() - want).max()))
    assert max(errs) <= BF16_ATOL, errs

    jtokens = np.asarray(ref["greedy"])
    near_ties = []
    with torch.no_grad():
        cache, logits = T.prefill(cfg, params,
                                  torch.from_numpy(greedy_prompt), max_len=12)
        for i, want in enumerate(ref["greedy_logits"]):
            got = logits.numpy()
            diff = np.abs(got - want).max(axis=-1)
            assert diff.max() <= BF16_ATOL
            top2 = np.sort(want, axis=-1)[:, -2:]
            for r in range(B):
                if got[r].argmax() != jtokens[r, i]:
                    gap = float(top2[r, 1] - top2[r, 0])
                    assert gap <= 2 * diff[r], (i, r, gap, diff[r])
                    near_ties.append((i, r, int(got[r].argmax()),
                                      int(jtokens[r, i]), gap))
            cache, logits = T.decode_step(cfg, params, cache,
                                          torch.from_numpy(jtokens[:, i]))
    assert near_ties == [(2, 0, 487, 140, 0.0)]
    got = greedy_generate(cfg, params, greedy_prompt, n_new=4)
    np.testing.assert_array_equal(got[1], jtokens[1])
    np.testing.assert_array_equal(got[0, :2], jtokens[0, :2])
    assert got[0, 2] == 487


# -- the reference's own serving tests, on the port ----------------------------


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "gemma2-9b",
                                     "granite-moe-3b-a800m"])
def test_decode_matches_forward(arch_id):
    """prefill(s) + decode(t) reproduce the full-forward logits; MoE archs
    get a no-drop capacity factor (the reference test's reason: a
    different T gives a different capacity and different drops)."""
    rng = np.random.default_rng(0)
    cfg = get_arch(arch_id).smoke_config
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = api.model_api(cfg).init(torch.Generator().manual_seed(1), CPU)
    b, s = 2, 12
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           size=(b, s + 1)).astype(np.int32))
    with torch.no_grad():
        full = T.lm_forward(cfg, params, tokens, chunked=False)
        cache, logits_pre = T.prefill(cfg, params, tokens[:, :s],
                                      max_len=s + 2)
        np.testing.assert_allclose(logits_pre.numpy(), full[:, s - 1].numpy(),
                                   rtol=2e-3, atol=2e-3)
        cache, logits_dec = T.decode_step(cfg, params, cache, tokens[:, s])
    np.testing.assert_allclose(logits_dec.numpy(), full[:, s].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_local_window_masks_past():
    """The reference test's check of the per-layer windows, and a stronger
    one: in a one-layer config whose layer is local (window 4), the last of
    40 positions cannot see token 0, so changing it leaves the last
    logits unchanged bit for bit, in the port and in the reference."""
    cfg = dataclasses.replace(get_arch("gemma2-9b").smoke_config,
                              n_layers=2, local_window=4)
    w = T.layer_windows(cfg)
    assert int(w[0]) == 4 and int(w[1]) == T.GLOBAL_WINDOW

    cfg1 = dataclasses.replace(cfg, n_layers=1)
    jcfg1 = dataclasses.replace(jget_arch("gemma2-9b").smoke_config,
                                n_layers=1, local_window=4)
    jparams = japi.model_api(jcfg1).init(jax.random.key(3))
    params = T.params_from_numpy(cfg1, _np_tree(jparams), CPU)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, size=(1, 40)).astype(np.int32)
    other = tokens.copy()
    other[0, 0] = 0
    outs = []
    for t in (tokens, other):
        with torch.no_grad():
            got = T.lm_forward(cfg1, params, torch.from_numpy(t),
                               chunked=False)
        want = JT.lm_forward(jcfg1, jparams, jnp.asarray(t), chunked=False)
        outs.append((got.numpy(), np.asarray(want)))
    (a, ja), (b, jb) = outs
    np.testing.assert_array_equal(a[0, -1], b[0, -1])
    np.testing.assert_array_equal(ja[0, -1], jb[0, -1])
    assert not np.array_equal(a[0, 0], b[0, 0])      # token 0 did change
    np.testing.assert_allclose(a, ja, **TOL)
    # the same window through prefill and one decode step
    with torch.no_grad():
        cache, _ = T.prefill(cfg1, params, torch.from_numpy(tokens[:, :39]),
                             max_len=40)
        _, dec = T.decode_step(cfg1, params, cache,
                               torch.from_numpy(tokens[:, 39]))
    np.testing.assert_allclose(dec.numpy(), a[:, -1], **TOL)


def test_greedy_generate_shapes():
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    params = api.model_api(cfg).init(torch.Generator().manual_seed(0), CPU)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(2, 8))
    out = greedy_generate(cfg, params, prompt, n_new=4)
    assert out.shape == (2, 4)
    assert (out >= 0).all() and (out < cfg.vocab_size).all()


def test_prefill_chunks_from_8192_tokens(monkeypatch):
    """``prefill`` takes ``chunked_mha`` from 8192 tokens (the card's long
    request), ``mha`` below, as the reference does (both attentions are
    stubbed here: what is held is the choice, and the cache's shape)."""
    cfg = dataclasses.replace(get_arch("gemma2-9b").smoke_config, n_layers=2,
                              d_model=16, n_heads=2, n_kv_heads=1,
                              head_dim=8, d_ff=16, vocab_size=64)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), CPU)
    seen = []

    def stub(name):
        def attend(q, *a, **kw):
            seen.append(name)
            return torch.zeros_like(q)
        return attend

    monkeypatch.setattr(T.L, "mha", stub("mha"))
    monkeypatch.setattr(T.L, "chunked_mha", stub("chunked"))
    tokens = torch.from_numpy(_ints(cfg, 0, (1, 8192)))
    with torch.no_grad():
        cache, _ = T.prefill(cfg, params, tokens[:, :8191])
        assert seen == ["mha"] * 2 and int(cache.length) == 8191
        cache, logits = T.prefill(cfg, params, tokens, max_len=8200)
    assert seen[2:] == ["chunked"] * 2
    assert cache.k.shape == (2, 1, 8200, 1, 8)
    assert bool(torch.isfinite(logits).all())
