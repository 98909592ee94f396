"""The port's LM family (``models/transformer.py``, ``LMConfig``) against
the JAX package's: configs, parameter trees, the training forward, loss,
gradients and a train step, MoE dispatch, specs and the launcher's data.

For the five LM archs' SMOKE configs (f32), with the reference's
parameters (its ``init_lm``, carried across by ``params_from_numpy``) and
tokens made with numpy from a seed: ``lm_forward``'s logits unchunked and
chunked and ``lm_loss`` at rtol 1e-5 / atol 1e-5; the gradient of
``lm_loss`` for gemma2-9b and kimi-k2 (every leaf at rtol 1e-4 / atol
1e-5); one AdamW step of ``make_train_step`` for qwen1.5-0.5b at the
recsys ranking path's tolerances; ``moe_apply`` for granite-moe and
kimi-k2 at the default capacity factor and at 0.25 (tokens dropped): the
output at rtol 1e-5 and the routing table (so the tokens dropped) equal.
The reference's own LM tests (``tests/test_models_lm.py``) run on the
port too. The serving path (prefill, decode, ``greedy_generate``) is in
``tests/test_torch_lm_serving.py``.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import config_to_json as jconfig_to_json
from repro.config.base import get_arch as jget_arch
from repro.launch import train as jlaunch
from repro.models import api as japi
from repro.models import transformer as JT
from repro_torch.common.util import tree_params
from repro_torch.config.base import (LMConfig, MoEConfig, config_to_json,
                                     get_arch, list_archs)
from repro_torch.launch import train as launch
from repro_torch.models import api
from repro_torch.models import transformer as T

LM_ARCHS = ["gemma-7b", "qwen1.5-0.5b", "gemma2-9b", "kimi-k2-1t-a32b",
            "granite-moe-3b-a800m"]
MOE_ARCHS = ["granite-moe-3b-a800m", "kimi-k2-1t-a32b"]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")
B, S = 2, 40


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named_leaves(tree):
    return [(jax.tree_util.keystr(path), leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _tokens(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=LM_ARCHS)
def arch(request):
    """(port config, reference config, reference params as numpy, port
    params carried from them, the reference's forward logits unchunked and
    chunked and its loss on one token batch, and the batch)."""
    jcfg = jget_arch(request.param).smoke_config
    cfg = get_arch(request.param).smoke_config
    jparams = jax.jit(japi.model_api(jcfg).init)(jax.random.key(0))
    tokens = _tokens(cfg, 1)
    fwd = jax.jit(functools.partial(JT.lm_forward, jcfg),
                  static_argnames="chunked")
    ref = {"tokens": tokens,
           "logits": np.asarray(fwd(jparams, jnp.asarray(tokens),
                                    chunked=False)),
           "chunked": np.asarray(fwd(jparams, jnp.asarray(tokens),
                                     chunked=True)),
           "loss": float(jax.jit(functools.partial(JT.lm_loss, jcfg))(
               jparams, {"tokens": jnp.asarray(tokens)})[0])}
    npp = _np_tree(jparams)
    return cfg, jcfg, npp, T.params_from_numpy(cfg, npp, CPU), ref


# -- configs, trees, specs ----------------------------------------------------


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_configs_equal_the_reference(arch_id):
    a, j = get_arch(arch_id), jget_arch(arch_id)
    for mine, ref in ((a.config, j.config), (a.smoke_config, j.smoke_config)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert config_to_json(mine) == jconfig_to_json(ref)
        assert mine.n_params() == ref.n_params()
        assert mine.n_active_params() == ref.n_active_params()
        assert (mine.is_moe, mine.q_per_kv) == (ref.is_moe, ref.q_per_kv)
        assert isinstance(mine, LMConfig)
        assert mine.moe is None or isinstance(mine.moe, MoEConfig)
    assert [dataclasses.asdict(s) for s in a.shapes] == \
        [dataclasses.asdict(s) for s in j.shapes]
    assert (a.description, a.source) == (j.description, j.source)
    assert set(LM_ARCHS) <= set(list_archs())


def test_lm_shapes_and_skip_reason_equal_the_reference():
    from repro.configs import lm_shapes as jshapes
    from repro_torch.configs import lm_shapes
    assert lm_shapes.FULL_ATTN_SKIP == jshapes.FULL_ATTN_SKIP
    for ok in (True, False):
        assert [dataclasses.asdict(s) for s in lm_shapes.lm_shapes(ok)] == \
            [dataclasses.asdict(s) for s in jshapes.lm_shapes(ok)]


def _shapes(tree):
    return {name: (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
            for name, leaf in _named_leaves(tree)}


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_init_tree_matches_reference(arch_id):
    cfg = get_arch(arch_id).smoke_config
    mine = api.model_api(cfg).init(torch.Generator().manual_seed(0), CPU)
    ref = jax.eval_shape(japi.model_api(jget_arch(arch_id).smoke_config)
                         .init, jax.random.key(0))
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(ref)
    assert _shapes(mine) == _shapes(ref)
    assert all(t.device == CPU for t in jax.tree_util.tree_leaves(mine))
    assert api.model_api(cfg).family == "lm"
    meta = T.init_lm(cfg, None, "meta")
    assert _shapes(meta) == _shapes(ref)
    assert all(t.is_meta for t in jax.tree_util.tree_leaves(meta))
    # dense leaves are drawn (a layer at a time), norms and biases zero
    blocks = mine["blocks"]
    assert all(bool(blocks["attn"][w][i].std() > 0)
               for w in ("wq", "wo") for i in range(cfg.n_layers))
    assert not blocks["attn_norm"]["scale"].any()


def test_init_defaults_to_the_card():
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_lm(cfg, torch.Generator().manual_seed(0))


def test_params_from_numpy_carries_every_leaf(arch):
    cfg, _, npp, params, _ = arch
    for (name, got), (_, want) in zip(_named_leaves(params),
                                      _named_leaves(npp)):
        assert np.array_equal(got.numpy(), want), name
    with pytest.raises(ValueError, match="keys"):
        T.params_from_numpy(cfg, {"embed": npp["embed"]}, CPU)


def test_params_from_numpy_takes_bf16_leaves():
    jcfg = dataclasses.replace(jget_arch("gemma2-9b").smoke_config,
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("gemma2-9b").smoke_config,
                              param_dtype="bfloat16")
    npp = _np_tree(japi.model_api(jcfg).init(jax.random.key(0)))
    params = T.params_from_numpy(cfg, npp, CPU)
    for (name, got), (_, want) in zip(_named_leaves(params),
                                      _named_leaves(npp)):
        assert got.dtype == torch.bfloat16, name
        assert np.array_equal(got.float().numpy(),
                              want.astype(np.float32)), name


@pytest.mark.parametrize("arch_id", LM_ARCHS)
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
def test_input_specs_match_reference(arch_id, shape_name):
    a, j = get_arch(arch_id), jget_arch(arch_id)
    mine = api.input_specs(a.config, a.shape(shape_name))
    ref = japi.input_specs(j.config, j.shape(shape_name))
    assert list(mine) == list(ref)
    if a.shape(shape_name).kind == "decode":
        assert isinstance(mine["cache"], T.KVCache)
        pairs = list(zip(mine["cache"], ref["cache"])) + \
            [(mine["token"], ref["token"])]
    else:
        pairs = [(mine["tokens"], ref["tokens"])]
    for (shape, dtype), want in pairs:
        assert shape == want.shape
        assert str(dtype).removeprefix("torch.") == str(want.dtype)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_abstract_trees_match_reference(arch_id):
    """Full CONFIG (kimi-k2's ~1T parameters too): on ``meta``, nothing
    allocated."""
    a, j = get_arch(arch_id), jget_arch(arch_id)
    params = api.abstract_params(a.config)
    jparams = japi.abstract_params(j.config)
    assert _shapes(params) == _shapes(jparams)
    assert tree_params(params) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    st = api.abstract_opt_state(a.config, params)
    jst = japi.abstract_opt_state(j.config, jparams)
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(st)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jst)]
    assert all(x.is_meta for x in jax.tree_util.tree_leaves(st))


def test_lm_shape_kinds_are_refused_for_other_families():
    a = get_arch("gemma2-9b")
    with pytest.raises(ValueError, match="graph_full"):
        api.input_specs(a.config, dataclasses.replace(
            a.shape("train_4k"), kind="graph_full"))
    with pytest.raises(TypeError, match="LM step; got GNNConfig"):
        api.make_prefill_step(get_arch("meshgraphnet").smoke_config)


# -- the training forward, loss, gradients --------------------------------------


@pytest.mark.parametrize("chunked", [False, True])
def test_forward_matches_reference(arch, chunked):
    cfg, _, _, params, ref = arch
    got = T.lm_forward(cfg, params, torch.from_numpy(ref["tokens"]),
                       chunked=chunked)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(),
                               ref["chunked" if chunked else "logits"], **TOL)


def test_loss_matches_reference(arch):
    cfg, _, _, params, ref = arch
    batch = {"tokens": torch.from_numpy(ref["tokens"])}
    loss, metrics = T.lm_loss(cfg, params, batch)
    assert loss.shape == () and metrics["loss"] is loss
    np.testing.assert_allclose(float(loss), ref["loss"], **TOL)
    np.testing.assert_allclose(float(metrics["ppl"]), np.exp(ref["loss"]),
                               rtol=1e-5)
    api_loss, _ = api.model_api(cfg).loss(params, batch)
    assert float(api_loss) == float(loss)
    ev = api.make_eval_step(cfg)(params, batch)
    assert float(ev["loss"]) == float(loss)


def test_lm_forward_defaults_to_chunked_from_2048_tokens(monkeypatch):
    """``chunked=None`` picks ``chunked_mha`` from 2048 tokens, as the
    reference does; every layer under remat runs through the checkpoint
    with grad enabled."""
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").smoke_config,
                              n_layers=1, remat=True)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), CPU)
    seen = []
    real = T.L.chunked_mha

    def spy(*a, **kw):
        seen.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(T.L, "chunked_mha", spy)
    calls = []
    real_ckpt = T.checkpoint
    monkeypatch.setattr(T, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real_ckpt(*a, **kw))
    with torch.no_grad():
        T.lm_forward(cfg, params, torch.zeros((1, 2047), dtype=torch.int32))
    assert seen == [] and calls == []
    T.lm_forward(cfg, params, torch.zeros((1, 2048), dtype=torch.int32))
    assert seen == [2048] and calls == [1]


@pytest.fixture(scope="module")
def grads_ref():
    """The reference's loss and gradient for gemma2-9b and kimi-k2 SMOKE
    on one batch, jitted once each."""
    out = {}
    for arch_id in ("gemma2-9b", "kimi-k2-1t-a32b"):
        jcfg = jget_arch(arch_id).smoke_config
        jparams = jax.jit(japi.model_api(jcfg).init)(jax.random.key(2))
        tokens = _tokens(jcfg, 3)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: JT.lm_loss(jcfg, p, b)[0]))(
                jparams, {"tokens": jnp.asarray(tokens)})
        out[arch_id] = (_np_tree(jparams), tokens, float(loss),
                        _np_tree(grads))
    return out


@pytest.mark.parametrize("arch_id", ["gemma2-9b", "kimi-k2-1t-a32b"])
def test_loss_gradients_match_reference(arch_id, grads_ref):
    npp, tokens, jloss, jgrads = grads_ref[arch_id]
    cfg = get_arch(arch_id).smoke_config
    params = T.params_from_numpy(cfg, npp, CPU)
    loss, _, grads = api.value_and_grad(
        api.model_api(cfg).loss, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), jloss, **TOL)
    mine, ref = _named_leaves(grads), _named_leaves(jgrads)
    assert [n for n, _ in mine] == [n for n, _ in ref]
    for (name, g), (_, w) in zip(mine, ref):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **GRAD_TOL)


def test_remat_leaves_the_gradient_unchanged(grads_ref):
    """``cfg.remat`` runs each layer (and each attention chunk) under
    ``torch.utils.checkpoint``: the same gradient."""
    npp, tokens, _, _ = grads_ref["gemma2-9b"]
    cfg = get_arch("gemma2-9b").smoke_config
    batch = {"tokens": torch.from_numpy(tokens)}
    params = T.params_from_numpy(cfg, npp, CPU)
    _, _, plain = api.value_and_grad(api.model_api(cfg).loss, params, batch)
    cfg_r = dataclasses.replace(cfg, remat=True)
    _, _, remat = api.value_and_grad(functools.partial(T.lm_loss, cfg_r),
                                     params, batch)
    for (name, a), (_, b) in zip(_named_leaves(plain), _named_leaves(remat)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


STEP_LR = 1e-2


def test_train_step_matches_reference():
    """One AdamW step of ``make_train_step`` (qwen1.5-0.5b SMOKE, the
    SMOKE optimizer) from the same parameters on the same batch: the loss
    at rtol 1e-5, every parameter at rtol 1e-5 / atol 2e-6, except where
    AdamW's first update, lr * g / (|g| + eps), turns the two packages'
    last-bit gradient differences into movement: its slope in g is
    lr * eps / g^2, so a gradient difference of 5e-9 (the f32 noise of
    these leaves, whose largest entries are ~1e-2) moves an entry of |g| =
    1.1e-7 by 4e-5. Entries whose reference gradient is nonzero and below
    ``near_zero`` = 1e-6 (there lr * eps * 5e-9 / g^2 passes 5e-7) are
    held to lr: at this seed 128 of 133,824 entries, among them the key
    bias's smallest (the softmax is blind to it) and ``wk``'s entry of
    -1.076e-7 that moved 3.8e-5."""
    near_zero = 1e-6
    jcfg = jget_arch("qwen1.5-0.5b").smoke_config
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    jparams = jax.jit(japi.model_api(jcfg).init)(jax.random.key(4))
    tokens = _tokens(cfg, 5)
    jb = {"tokens": jnp.asarray(tokens)}
    jstep, jopt = japi.make_train_step(jcfg, lr=STEP_LR)
    jp2, jst, jm = jax.jit(jstep)(jparams, jopt.init(jparams), jb)
    jg = _np_tree(jax.grad(lambda p: JT.lm_loss(jcfg, p, jb)[0])(jparams))

    params = T.params_from_numpy(cfg, _np_tree(jparams), CPU)
    step, opt = api.make_train_step(cfg, lr=STEP_LR)
    p2, st, m = step(params, opt.init(params),
                     {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    g0 = dict(_named_leaves(jg))
    n_tiny = 0
    for (name, a), (_, w) in zip(_named_leaves(p2),
                                 _named_leaves(_np_tree(jp2))):
        tiny = (np.abs(g0[name]) < near_zero) & (g0[name] != 0)
        a = a.numpy()
        np.testing.assert_allclose(a[~tiny], w[~tiny], rtol=1e-5, atol=2e-6,
                                   err_msg=name)
        assert np.abs(a[tiny] - w[tiny]).max(initial=0.0) <= STEP_LR, name
        n_tiny += int(tiny.sum())
    assert n_tiny == 128
    assert int(st["count"]) == 1 == int(jst["count"])


# -- MoE ----------------------------------------------------------------------


class _VmapSpy(types.SimpleNamespace):
    """Stands in for the reference module's ``jax`` and keeps what its
    first ``jax.vmap`` call returns: ``moe_apply``'s routing tables."""

    def __init__(self):
        super().__init__(tables=[])

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        vf = jax.vmap(fn, *a, **kw)

        def run(*args):
            out = vf(*args)
            self.tables.append(out)
            return out
        return run


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 0.25])
def test_moe_apply_matches_reference(arch_id, capacity_factor, monkeypatch):
    """80 tokens of one layer's MoE: the output at rtol 1e-5, and the
    routing table (each expert's slots: which token, which gate) equal to
    the reference's, so the same tokens are dropped. At a capacity factor
    of 0.25 some tokens lose every choice (their routed output is 0)."""
    jcfg = jget_arch(arch_id).smoke_config
    cfg = get_arch(arch_id).smoke_config
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    jparams = _np_tree(japi.model_api(jcfg).init(jax.random.key(6)))
    jp0 = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                 jparams["blocks"]["mlp"])
    x = np.random.default_rng(7).normal(size=(80, cfg.d_model)
                                        ).astype(np.float32)
    spy = _VmapSpy()
    monkeypatch.setattr(JT, "jax", spy)
    want = np.asarray(JT.moe_apply(jp0, jnp.asarray(x), jcfg.moe,
                                   jcfg.activation))
    monkeypatch.undo()
    jtok, jgate = (np.asarray(a) for a in spy.tables[0])

    params = T.params_from_numpy(cfg, jparams, CPU)
    p0 = T._layer(params["blocks"], 0)["mlp"]
    got = T.moe_apply(p0, torch.from_numpy(x), cfg.moe, cfg.activation)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    tok, gate = T.moe_dispatch(p0["router"], torch.from_numpy(x)[None],
                               cfg.moe)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    np.testing.assert_allclose(gate.numpy(), jgate, rtol=1e-6, atol=1e-7)
    kept = np.zeros(80, int)
    np.add.at(kept, tok.numpy()[tok.numpy() >= 0], 1)
    if capacity_factor == 0.25:
        assert (kept < cfg.moe.top_k).any()
        if "shared" not in p0:
            np.testing.assert_array_equal(got.numpy()[kept == 0], 0.0)
    else:
        assert tok.shape[-1] == T.moe_capacity(cfg.moe, 80)


def test_moe_top_k_keeps_the_lower_expert_among_ties():
    """Equal router logits: the lower expert wins, and within an expert the
    earlier token takes the first slot, as ``lax.top_k`` and the stable
    ``jnp.argsort`` give."""
    moe = MoEConfig(n_experts=4, top_k=2, d_ff_expert=8)
    router = torch.zeros((6, 4))
    x = torch.ones((1, 10, 6))
    tok, gate = T.moe_dispatch(router, x, moe)
    assert tok.shape == (1, 4, 8)
    assert tok[0, 0].tolist() == list(range(8))
    assert tok[0, 1].tolist() == list(range(8))
    assert (tok[0, 2:] == -1).all()
    assert torch.all(gate[0, :2] == 0.5)


# -- the reference's own LM tests, on the port --------------------------------


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_smoke_train_step(arch_id):
    rng = np.random.default_rng(0)
    cfg = get_arch(arch_id).smoke_config
    params = api.model_api(cfg).init(torch.Generator().manual_seed(0), CPU)
    step, opt = api.make_train_step(cfg)
    opt_state = opt.init(params)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32))}
    p2, o2, m = step(params, opt_state, batch)
    assert np.isfinite(float(m["loss"]))
    delta = sum(float((a - b).abs().sum()) for a, b in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(p2)))
    assert delta > 0


def test_chunked_attention_matches_full():
    rng = np.random.default_rng(0)
    cfg = get_arch("gemma2-9b").smoke_config
    params = api.model_api(cfg).init(torch.Generator().manual_seed(2), CPU)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32))
    with torch.no_grad():
        full = T.lm_forward(cfg, params, tokens, chunked=False)
        chk = T.lm_forward(cfg, params, tokens, chunked=True)
    np.testing.assert_allclose(chk.numpy(), full.numpy(), rtol=3e-3,
                               atol=3e-3)


def test_moe_dispatch_mass_conservation():
    rng = np.random.default_rng(0)
    cfg = get_arch("kimi-k2-1t-a32b").smoke_config
    params = api.model_api(cfg).init(torch.Generator().manual_seed(4), CPU)
    x = torch.from_numpy(rng.normal(size=(32, cfg.d_model)
                                    ).astype(np.float32))
    p0 = T._layer(params["blocks"], 0)["mlp"]
    out = T.moe_apply(p0, x, cfg.moe, cfg.activation)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    # every kept pair's gate comes from its token's k gates, which sum to 1
    tok, gate = T.moe_dispatch(p0["router"], x[None], cfg.moe)
    sums = torch.zeros(32).index_add_(0, tok[tok >= 0], gate[tok >= 0])
    kept = torch.bincount(tok[tok >= 0], minlength=32)
    full = kept == cfg.moe.top_k
    assert bool(full.any())
    torch.testing.assert_close(sums[full], torch.ones(int(full.sum())))


def test_moe_capacity_drops_dont_nan():
    rng = np.random.default_rng(0)
    moe = MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                    capacity_factor=0.25)
    cfg = dataclasses.replace(get_arch("kimi-k2-1t-a32b").smoke_config,
                              moe=moe)
    params = api.model_api(cfg).init(torch.Generator().manual_seed(5), CPU)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32))
    loss, _ = api.model_api(cfg).loss(params, {"tokens": tokens})
    assert np.isfinite(float(loss))


def test_qwen_bias_present():
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    params = api.model_api(cfg).init(torch.Generator().manual_seed(0), CPU)
    assert "bq" in params["blocks"]["attn"]


def test_param_count_analytic_matches_init():
    for arch_id in ["qwen1.5-0.5b", "granite-moe-3b-a800m"]:
        cfg = get_arch(arch_id).smoke_config
        params = api.model_api(cfg).init(torch.Generator().manual_seed(0),
                                         CPU)
        got = tree_params(params)
        exp = cfg.n_params()
        assert abs(got - exp) / exp < 0.02, (arch_id, got, exp)
    # full CONFIG on meta: gemma2-9b's 9.24 B parameters
    cfg = get_arch("gemma2-9b").config
    got = tree_params(api.abstract_params(cfg))
    assert abs(got - cfg.n_params()) / cfg.n_params() < 0.02


# -- the launcher's LM branch ---------------------------------------------------


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "gemma2-9b"])
def test_launcher_lm_batches_equal_reference(arch_id):
    cfg = get_arch(arch_id).smoke_config
    jcfg = jget_arch(arch_id).smoke_config
    mine = launch.data_iterator(cfg, 3, 16, seed=4, device="cpu")
    ref = jlaunch.data_iterator(jcfg, 3, 16, seed=4)
    for _ in range(3):
        got, want = next(mine), next(ref)
        assert list(got) == ["tokens"]
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))


def test_launcher_main_trains_qwen_on_cpu(tmp_path, capsys):
    launch.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "3",
                 "--batch", "2", "--seq", "16", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out
    assert (tmp_path / "ck").exists()
