"""The port's MeshGraphNet against the JAX package's.

The reference's parameters (``init_gnn`` from ``jax.random.key(0)``) are
carried across by ``params_from_numpy``; graphs are made with numpy from a
seed: unsorted edges with -1 padding interleaved (both ends, and one end
only), and masked node targets. Under the SMOKE config (f32), the port's
``gnn_forward``, ``gnn_loss`` and every parameter's gradient match the
reference's ``jax.value_and_grad`` at rtol 1e-4 / atol 1e-5 (sum and mean
aggregators, remat on and off): both compute in f32, and the port sums
each node's messages in edge order after its sort while XLA's scatter-add
and matmuls take their own orders. The aggregate goes through
``ops.csr_segment_sum`` and its autograd Function, whose backward equals
autograd through the plain version bit for bit. The four cases of
``tests/test_models_gnn.py`` are mirrored on the port. At bf16 compute the
port sums messages in f32 (as kernel 7 and the TPU kernel do) where the
reference's ``jax.ops.segment_sum`` sums in bf16: a named test pins that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import config_to_json as jconfig_to_json
from repro.config.base import get_arch as jget_arch
from repro.models import api as japi
from repro.models import gnn as jgnn
from repro_torch.config.base import GNNConfig, config_to_json, get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models import api, gnn
from repro_torch.models import layers as L

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
N, E, PAD = 40, 120, 24


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graph(seed: int, cfg) -> dict:
    """numpy batch: E random edges plus PAD padded ones interleaved (a
    third with both ends -1, a third src only, a third dst only), and a
    node mask over about two thirds of the nodes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, size=E + PAD).astype(np.int32)
    dst = rng.integers(0, N, size=E + PAD).astype(np.int32)
    pad = rng.permutation(E + PAD)[:PAD]
    src[pad[: 2 * PAD // 3]] = -1
    dst[pad[PAD // 3:]] = -1
    return {"node_feats": rng.normal(size=(N, cfg.in_node_dim)
                                     ).astype(np.float32),
            "edge_src": src, "edge_dst": dst,
            "edge_feats": rng.normal(size=(E + PAD, cfg.in_edge_dim)
                                     ).astype(np.float32),
            "node_targets": rng.normal(size=(N, cfg.out_dim)
                                       ).astype(np.float32),
            "node_mask": rng.random(N) < 0.66}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _smoke(aggregator="sum", remat=False):
    return dataclasses.replace(get_arch("meshgraphnet").smoke_config,
                               aggregator=aggregator, remat=remat)


def _jcfg(cfg):
    return jgnn.GNNConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def setup():
    cfg = _smoke()
    jparams = _np_tree(jgnn.init_gnn(_jcfg(cfg), jax.random.key(0)))
    return cfg, jparams, _graph(0, cfg)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_config_matches_reference():
    for mine, ref_cfg in ((get_arch("meshgraphnet").config,
                           jget_arch("meshgraphnet").config),
                          (get_arch("meshgraphnet").smoke_config,
                           jget_arch("meshgraphnet").smoke_config)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref_cfg)
        assert config_to_json(mine) == jconfig_to_json(ref_cfg)
    assert [dataclasses.asdict(s) for s in get_arch("meshgraphnet").shapes] \
        == [dataclasses.asdict(s) for s in jget_arch("meshgraphnet").shapes]
    assert GNNConfig("x", 1, 2).compute_dtype == "bfloat16"


def test_init_tree_matches_reference(setup):
    cfg, jparams, _ = setup
    mine = gnn.init_gnn(cfg, torch.Generator().manual_seed(0), CPU)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, mine)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0,
                                                            jparams))
    for a, b in zip(_leaves(mine), _leaves(jparams)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    meta = api.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in _leaves(meta))
    with pytest.raises(ValueError, match="keys"):
        gnn.params_from_numpy(cfg, {**jparams, "decoder": jparams["node_enc"]},
                              CPU)
    dec = jparams["decoder"]
    with pytest.raises(ValueError, match="shape"):
        gnn.params_from_numpy(cfg, {**jparams, "decoder": {
            **dec, "w": (dec["w"][0][:-1],) + dec["w"][1:]}}, CPU)


def test_layernorm_matches_reference():
    from repro.models import layers as JL
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 33)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=33).astype(np.float32),
         "bias": rng.normal(size=33).astype(np.float32)}
    want = np.asarray(JL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x)))
    got = L.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    got16 = L.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x).to(torch.bfloat16))
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("aggregator", ["sum", "mean"])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_reference(setup, aggregator, remat):
    _, jparams, b = setup
    cfg = _smoke(aggregator, remat)
    jc = _jcfg(cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jgnn.gnn_loss(jc, p, _jbatch(b)), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, jparams))
    jpred = np.asarray(jgnn.gnn_forward(jc, jax.tree_util.tree_map(
        jnp.asarray, jparams), _jbatch(b)))
    params = gnn.params_from_numpy(cfg, jparams, CPU)
    pred = gnn.gnn_forward(cfg, params, _tbatch(b))
    np.testing.assert_allclose(pred.numpy(), jpred, **TOL)
    loss, metrics, grads = api.value_and_grad(
        api.model_api(cfg).loss, params, _tbatch(b))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert float(metrics["loss"]) == float(loss)
    mine = _leaves(grads)
    theirs = _leaves(_np_tree(jgrads))
    assert len(mine) == len(theirs)
    for a, w in zip(mine, theirs):
        assert tuple(a.shape) == w.shape
        np.testing.assert_allclose(a.numpy(), w, **TOL)


def test_remat_changes_nothing(setup):
    _, jparams, b = setup
    outs = []
    for remat in (False, True):
        cfg = _smoke(remat=remat)
        params = gnn.params_from_numpy(cfg, jparams, CPU)
        loss, _, grads = api.value_and_grad(api.model_api(cfg).loss, params,
                                            _tbatch(b))
        outs.append((loss, _leaves(grads)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, c) for a, c in zip(outs[0][1], outs[1][1]))


def test_aggregate_goes_through_the_segment_sum_function(setup, monkeypatch):
    """Each block's aggregate is one ``ops.csr_segment_sum`` call on
    destination-sorted edges with -1 padding at the end; with remat the
    backward runs each block's forward, and so the call, again."""
    _, jparams, b = setup
    calls = []
    real = ops.SegmentSum.forward

    def spy(ctx, messages, dst_sorted, n):
        d = dst_sorted
        ok = d >= 0
        # padding is a tail, and the real part ascends
        assert bool((ok[:int(ok.sum())]).all())
        assert bool((d[ok][1:] >= d[ok][:-1]).all())
        calls.append(n)
        return real(ctx, messages, dst_sorted, n)

    monkeypatch.setattr(ops.SegmentSum, "forward", staticmethod(spy))
    for remat, want in ((False, 3), (True, 6)):
        calls.clear()
        cfg = _smoke(remat=remat)
        params = gnn.params_from_numpy(cfg, jparams, CPU)
        api.value_and_grad(api.model_api(cfg).loss, params, _tbatch(b))
        assert calls == [N] * want


def test_segment_sum_backward_equals_autograd_through_plain_version():
    rng = np.random.default_rng(5)
    n, e, d = 30, 200, 16
    dst = np.sort(rng.integers(0, n + 3, size=e)).astype(np.int32)
    dst[dst >= n] = -1                  # out-of-range and padding: dropped
    dst = np.concatenate([dst[dst >= 0], dst[dst < 0]])
    msgs = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    gout = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    a = msgs.clone().requires_grad_(True)
    out = ops.csr_segment_sum(a, torch.from_numpy(dst), n)
    (out * gout).sum().backward()
    b = msgs.clone().requires_grad_(True)
    want = ref.csr_segment_sum(b, torch.from_numpy(dst), n)
    (want * gout).sum().backward()
    assert torch.equal(out, want.detach())
    assert torch.equal(a.grad, b.grad)
    bf = msgs.to(torch.bfloat16).requires_grad_(True)
    ops.csr_segment_sum(bf, torch.from_numpy(dst), n).sum().backward()
    assert bf.grad.dtype == torch.bfloat16


def test_bf16_aggregation_sums_in_f32():
    """Pinned difference: at bf16 compute the port (kernel 7's contract,
    like the TPU kernel) sums each node's bf16 messages in f32 and rounds
    once; ``jax.ops.segment_sum`` in ``gnn.py:97`` sums in bf16. On a node
    of 256 messages the port's sum equals the float64 sum of the same bf16
    values to f32 precision, and the reference's misses it by more than
    the port's error."""
    rng = np.random.default_rng(11)
    e, d = 256, 8
    msgs = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)
                            + 1.0).to(torch.bfloat16)
    dst = torch.zeros(e, dtype=torch.int32)
    exact = msgs.double().sum(0)
    mine = ops.csr_segment_sum(msgs, dst, 1)[0]
    assert mine.dtype == torch.float32
    theirs = np.asarray(jax.ops.segment_sum(
        jnp.asarray(msgs.float().numpy(), jnp.bfloat16),
        jnp.zeros(e, jnp.int32), num_segments=1)[0], np.float32)
    err_mine = float((mine.double() - exact).abs().max())
    err_ref = float((torch.from_numpy(theirs).double() - exact).abs().max())
    assert err_mine <= 1e-4 * float(exact.abs().max())
    assert err_ref > 10 * err_mine


def _bf16_pair(jparams, b, param_dtype):
    """(port, reference) predictions at bf16 compute, remat on."""
    cfg = dataclasses.replace(_smoke(remat=True), compute_dtype="bfloat16",
                              param_dtype=param_dtype)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, param_dtype),
                                jparams)
    want = np.asarray(jgnn.gnn_forward(_jcfg(cfg), jp, _jbatch(b)))
    params = gnn.params_from_numpy(
        cfg, jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp),
        CPU)
    got = gnn.gnn_forward(cfg, params, _tbatch(b)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    return got, want


def test_bf16_compute_with_f32_params_matches_reference(setup, monkeypatch):
    """CONFIG's dtypes (f32 parameters, bf16 compute) at SMOKE widths: the
    messages reach the segment sum as f32 in both packages (a bf16
    activation times an f32 weight is f32 under JAX's promotion, and the
    port promotes the same way), so the two sum the same f32 values; each
    aggregate is then rounded to bf16, where a different summation order
    can land one bf16 step apart (2^-8 relative): atol 2e-2 on outputs of
    order 1."""
    _, jparams, b = setup
    seen = []
    real = ops.SegmentSum.forward

    def spy(ctx, messages, dst_sorted, n):
        seen.append(messages.dtype)
        return real(ctx, messages, dst_sorted, n)

    monkeypatch.setattr(ops.SegmentSum, "forward", staticmethod(spy))
    with torch.enable_grad():
        got, want = _bf16_pair(
            {k: v for k, v in jparams.items()}, b, "float32")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    gcfg = dataclasses.replace(_smoke(remat=True), compute_dtype="bfloat16")
    params = gnn.params_from_numpy(gcfg, jparams, CPU)
    api.value_and_grad(api.model_api(gcfg).loss, params, _tbatch(b))
    assert seen and set(seen) == {torch.float32}


def test_bf16_messages_sum_in_f32_unlike_reference(setup):
    """Pinned difference, model level: with bf16 parameters too the
    messages are bf16; the reference's ``jax.ops.segment_sum`` sums them
    in bf16, the port in f32 (then rounds once). The two stay within bf16
    noise of each other, atol 0.15 on outputs of order 1 (8-bit mantissas
    through three blocks, plus the summation difference)."""
    _, jparams, b = setup
    got, want = _bf16_pair(jparams, b, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=0, atol=0.15)


def test_train_step_matches_reference(setup):
    cfg, jparams, b = setup
    jc = _jcfg(cfg)
    jstep, jopt = japi.make_train_step(jc, lr=3e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jp2, jst2, jm = jstep(jp, jopt.init(jp), _jbatch(b))
    step, opt = api.make_train_step(cfg, lr=3e-3)
    params = gnn.params_from_numpy(cfg, jparams, CPU)
    p2, st2, m = step(params, opt.init(params), _tbatch(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    # AdamW's first step is lr * g / (|g| + eps): where |g| is near eps
    # (1e-8) the f32 gradient's last bits move it by up to lr x 1e-3
    for a, w in zip(_leaves(p2), _leaves(_np_tree(jp2))):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=1e-5)
    # m = 0.1 g and v = 0.001 g^2: the gradients' tolerance carried over
    for key, tol in (("m", dict(rtol=1e-4, atol=1e-6)),
                     ("v", dict(rtol=2e-4, atol=1e-10))):
        for a, w in zip(_leaves(st2[key]), _leaves(_np_tree(jst2[key]))):
            np.testing.assert_allclose(a.numpy(), w, **tol)
    assert int(st2["count"]) == int(jst2["count"]) == 1
    assert st2["count"].dtype == torch.int32
    ev = api.make_eval_step(cfg)(params, _tbatch(b))
    assert float(ev["loss"]) == float(m["loss"])


# -- the four cases of tests/test_models_gnn.py, on the port -----------------


@pytest.fixture(scope="module")
def tiny_graph():
    rng = np.random.default_rng(0)
    cfg = get_arch("meshgraphnet").smoke_config
    n, e = 40, 120
    return cfg, {
        "node_feats": torch.from_numpy(
            rng.normal(size=(n, cfg.in_node_dim)).astype(np.float32)),
        "edge_src": torch.from_numpy(
            rng.integers(0, n, size=e).astype(np.int32)),
        "edge_dst": torch.from_numpy(
            rng.integers(0, n, size=e).astype(np.int32)),
        "edge_feats": torch.from_numpy(
            rng.normal(size=(e, cfg.in_edge_dim)).astype(np.float32)),
        "node_targets": torch.from_numpy(
            rng.normal(size=(n, cfg.out_dim)).astype(np.float32)),
        "node_mask": torch.ones(n, dtype=torch.bool),
    }


def _init(cfg, seed=0):
    return api.model_api(cfg).init(torch.Generator().manual_seed(seed), CPU)


def test_forward_shapes_and_finite(tiny_graph):
    cfg, batch = tiny_graph
    out = gnn.gnn_forward(cfg, _init(cfg), batch)
    assert out.shape == (40, cfg.out_dim)
    assert bool(torch.isfinite(out).all())


def test_padding_edges_are_inert(tiny_graph):
    cfg, batch = tiny_graph
    params = _init(cfg)
    base = gnn.gnn_forward(cfg, params, batch)
    pad = torch.full((16,), -1, dtype=torch.int32)
    padded = dict(batch,
                  edge_src=torch.cat([batch["edge_src"], pad]),
                  edge_dst=torch.cat([batch["edge_dst"], pad]),
                  edge_feats=torch.cat([batch["edge_feats"],
                                        torch.full((16, cfg.in_edge_dim),
                                                   99.0)]))
    got = gnn.gnn_forward(cfg, params, padded)
    torch.testing.assert_close(got, base, rtol=1e-5, atol=1e-5)


def test_message_passing_locality(tiny_graph):
    cfg, batch = tiny_graph
    src = batch["edge_src"].clone()
    dst = batch["edge_dst"].clone()
    src[src == 0] = 1
    dst[dst == 0] = 1
    b = dict(batch, edge_src=src, edge_dst=dst)
    params = _init(cfg)
    base = gnn.gnn_forward(cfg, params, b)
    nf = b["node_feats"].clone()
    nf[0] += 10.0
    got = gnn.gnn_forward(cfg, params, dict(b, node_feats=nf))
    torch.testing.assert_close(got[1:], base[1:], rtol=1e-4, atol=1e-4)
    assert float((got[0] - base[0]).abs().max()) > 1e-4


def test_training_reduces_loss(tiny_graph):
    cfg, batch = tiny_graph
    params = _init(cfg, seed=1)
    step, opt = api.make_train_step(cfg, lr=3e-3)
    opt_state = opt.init(params)
    first = None
    for _ in range(25):
        params, opt_state, m = step(params, opt_state, batch)
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < first * 0.8, (first, float(m["loss"]))


def test_entry_points_default_to_the_card_and_raise_without_it(
        monkeypatch, tmp_path):
    from repro_torch.launch import train as launch_train
    from repro_torch.training import loop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("meshgraphnet").smoke_config
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn.init_gnn(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.train(cfg, iter(()), loop.LoopConfig(
            total_steps=1, checkpoint_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "meshgraphnet", "--smoke", "--steps",
                           "1", "--ckpt-dir", str(tmp_path)])
    assert gnn.init_gnn(cfg, None, "meta")["decoder"]["w"][0].is_meta
