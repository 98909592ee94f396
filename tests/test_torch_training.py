"""The port's training stack against the JAX package's.

Optimizers: AdamW and Adafactor over 5 steps of the same gradients (made
with numpy from a seed) on a tree with a stacked [L, r, c] leaf, a matrix,
a vector and a bf16 leaf; parameters and every state leaf allclose at rtol
1e-5 (bias corrections ``b ** count`` come from two pow implementations;
the rest is the same f32 arithmetic) and the counts equal. Compression:
int8 and top-k (with ties) with error feedback over 4 steps, the
decompressed gradients, residuals and byte counts equal the reference's.
The GNN step specs equal the reference's for the four meshgraphnet shapes.
The loop: a failure and a resume on the GNN SMOKE config equal an
uninterrupted run bit for bit; a port checkpoint loads in the reference's
``store.load`` and a reference checkpoint in the port's ``train``. The
launcher's batches equal the reference's (a GNN's and each recsys arch's),
and ``main`` runs 3 steps on the CPU (the GNN, and BST, whose checkpoint
then resumes). The reference's own training tests are mirrored on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.config.base import get_arch as jget_arch
from repro.launch import train as jlaunch
from repro.models import api as japi
from repro.training import grad_compress as jgc
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch.checkpoint import store
from repro_torch.common.util import tree_bytes
from repro_torch.config.base import get_arch
from repro_torch.launch import train as launch
from repro_torch.models import api
from repro_torch.training import grad_compress as gc
from repro_torch.training import loop
from repro_torch.training import optimizer as opt_mod

CPU = torch.device("cpu")
GNN = "meshgraphnet"
RECSYS = ["wide-deep", "deepfm", "dien", "bst"]


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _tree_np(rng):
    return {"stack": rng.normal(size=(3, 6, 5)).astype(np.float32),
            "w": rng.normal(size=(7, 4)).astype(np.float32),
            "b": (rng.normal(size=(4,)).astype(np.float32),
                  rng.normal(size=(1, 9)).astype(np.float32)),
            "h": rng.normal(size=(4, 3)).astype(np.float32)}


def _to_jax(tree):
    t = jax.tree_util.tree_map(jnp.asarray, tree)
    t["h"] = t["h"].astype(jnp.bfloat16)
    return t


def _to_torch(tree):
    t = jax.tree_util.tree_map(torch.from_numpy, tree)
    t["h"] = t["h"].to(torch.bfloat16)
    return t


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_equal_reference(name):
    rng = np.random.default_rng(0)
    p0 = _tree_np(rng)
    grads = [jax.tree_util.tree_map(
        lambda x: (rng.normal(size=x.shape) * 0.1).astype(np.float32), p0)
        for _ in range(5)]
    jo = jopt.make_optimizer(name, 0.05)
    to = opt_mod.make_optimizer(name, 0.05)
    jp, tp = _to_jax(p0), _to_torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(_to_jax(g), js, jp)
        tp, ts = to.update(_to_torch(g), ts, tp)
    for a, w in zip(_leaves(tp), _leaves(jp)):
        assert a.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                           else torch.float32)
        np.testing.assert_allclose(_np(a), _np(w), rtol=1e-5, atol=1e-6)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, ts)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, js))
    for a, w in zip(_leaves(ts), _leaves(js)):
        assert tuple(a.shape) == w.shape
        assert str(a.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_allclose(_np(a), _np(w), rtol=1e-5, atol=1e-9)
    assert int(ts["count"]) == 5


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_a_train_step_frees_the_previous_state_without_the_collector(name):
    """With the garbage collector off, one step of ``make_train_step`` on
    the BST SMOKE tree frees the previous parameters, moments and
    gradients as soon as the step returns: no reference cycle holds them
    (on the card such a cycle kept a full-width tree and its moments,
    ~14 GB for BST, alive into the next step). AdamW writes its moments
    in place: the new state holds the very tensors given, and nothing
    else of the previous state is alive."""
    import gc
    import weakref

    cfg = dataclasses.replace(get_arch("bst").smoke_config, optimizer=name)
    params = api.model_api(cfg).init(torch.Generator().manual_seed(0), CPU)
    batch = launch.data_iterator(cfg, 8, 1, device="cpu").__next__()
    step, opt = api.make_train_step(cfg)
    state = opt.init(params)
    kept = ({"m": state["m"], "v": state["v"]} if name == "adamw" else {})
    kept_ids = [id(t) for t in _leaves(kept)]
    refs = [weakref.ref(t) for t in _leaves(params) + _leaves(state)
            if id(t) not in kept_ids]
    del kept
    gc.disable()
    try:
        params, state, _ = step(params, state, batch)
        assert all(r() is None for r in refs)
        if name == "adamw":
            assert [id(t) for t in _leaves({"m": state["m"],
                                            "v": state["v"]})] == kept_ids
    finally:
        gc.enable()


@pytest.mark.parametrize("split_bytes", [0, opt_mod.SPLIT_BYTES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_a_layer_at_a_time_is_the_whole_leaf_arithmetic(dtype,
                                                              split_bytes):
    """AdamW updates a stacked leaf one leading slice at a time where its
    f32 copy passes ``split_bytes`` (0: every stacked leaf), else whole,
    writing the moments into the state's own tensors in place: two steps
    on a [4, 3, 5, 6] leaf (and a [4, 6] one, always updated whole) equal
    the whole-leaf arithmetic bit for bit, parameters and moments."""
    b1, b2, eps, wd, lr = 0.9, 0.999, 1e-8, 0.01, 0.05
    gen = torch.Generator().manual_seed(3)
    params = {"stack": torch.randn((4, 3, 5, 6), generator=gen).to(dtype),
              "norm": torch.randn((4, 6), generator=gen).to(dtype)}
    opt = opt_mod.adamw(lr=lr, split_bytes=split_bytes)
    state = opt.init(params)
    moments = state["m"], state["v"]
    want_p = dict(params)
    want_m = {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()}
    want_v = {k: t.clone() for k, t in want_m.items()}
    for c in (1, 2):
        grads = {k: torch.randn(p.shape, generator=gen).to(dtype)
                 for k, p in params.items()}
        params, state = opt.update(grads, state, params)
        cf = torch.tensor(float(c))
        for k, g in grads.items():
            g = g.to(torch.float32)
            want_m[k] = b1 * want_m[k] + (1 - b1) * g
            want_v[k] = b2 * want_v[k] + (1 - b2) * g * g
            step = lr * (want_m[k] / (1 - b1 ** cf)
                         / (torch.sqrt(want_v[k] / (1 - b2 ** cf)) + eps)
                         + wd * want_p[k].to(torch.float32))
            want_p[k] = (want_p[k].to(torch.float32) - step).to(dtype)
    assert all(a is b for a, b in zip(_leaves((state["m"], state["v"])),
                                      _leaves(moments)))   # in place
    for k in params:
        assert params[k].dtype == dtype
        assert torch.equal(params[k], want_p[k]), k
        assert torch.equal(state["m"][k], want_m[k]), k
        assert torch.equal(state["v"][k], want_v[k]), k
    assert int(state["count"]) == 2


def test_adafactor_clips_each_layer_of_a_stack():
    """The stacked leaf's update is clipped per leading slice (the
    reference's ``lax.map``): one layer's large gradient leaves the other
    layers' steps as they were."""
    p = {"stack": torch.zeros((2, 4, 4))}
    g = torch.ones((2, 4, 4)) * 1e-3
    g2 = g.clone()
    g2[0] *= 1e4
    af = opt_mod.adafactor(lr=0.1)
    a, _ = af.update({"stack": g}, af.init(p), p)
    b, _ = af.update({"stack": g2}, af.init(p), p)
    assert torch.equal(a["stack"][1], b["stack"][1])


def _quadratic_params():
    return {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 8)).astype(np.float32)), "b": torch.zeros(8)}


def _quad_grads(p):
    return {"w": 2 * (p["w"] - 3.0), "b": 2 * (p["b"] + 1)}


def _quad_loss(p):
    return float(((p["w"] - 3.0) ** 2).sum() + ((p["b"] + 1) ** 2).sum())


@pytest.mark.parametrize("make_opt", [lambda: opt_mod.adamw(lr=0.05),
                                      lambda: opt_mod.adafactor(lr=0.2)])
def test_optimizer_converges(make_opt):
    opt = make_opt()
    params = _quadratic_params()
    state = opt.init(params)
    first = _quad_loss(params)
    for _ in range(300):
        params, state = opt.update(_quad_grads(params), state, params)
    final = _quad_loss(params)
    assert final < max(0.5, 0.01 * first), (first, final)


def test_adafactor_state_is_factored():
    params = {"big": torch.zeros((256, 128))}
    af = opt_mod.adafactor().init(params)
    aw = opt_mod.adamw().init(params)
    assert tree_bytes(af) < tree_bytes(aw) / 20


@pytest.mark.parametrize("method,frac", [("int8", 0.0), ("topk", 0.15),
                                         ("topk", 0.01), ("none", 0.0)])
def test_compression_equals_reference(method, frac):
    rng = np.random.default_rng(1)
    p0 = {"a": np.zeros((12, 10), np.float32), "b": np.zeros(7, np.float32),
          "c": (np.zeros((3, 3, 4), np.float32),)}
    js, ts = jgc.init_state(jax.tree_util.tree_map(jnp.asarray, p0)), \
        gc.init_state(jax.tree_util.tree_map(torch.from_numpy, p0))
    for step in range(4):
        # values on a coarse grid, so |g| ties across positions
        g = jax.tree_util.tree_map(lambda x: (np.round(
            rng.normal(size=x.shape) * 4) / 4).astype(np.float32), p0)
        if step == 0:
            g["b"][:] = 0.0             # an all-zero tensor: scale 1
        jd, js, jw, jden = jgc.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, g), js, method, frac)
        td, ts, tw, tden = gc.compress_grads(
            jax.tree_util.tree_map(torch.from_numpy, g), ts, method, frac)
        assert (tw, tden) == (jw, jden)
        for a, w in zip(_leaves(td) + _leaves(ts.residual),
                        _leaves(jd) + _leaves(js.residual)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("method,frac,steps,min_ratio,max_loss",
                         [("int8", 0.0, 400, 3.5, 0.5),
                          ("topk", 0.15, 600, 3.0, 2.0)])
def test_grad_compression_converges(method, frac, steps, min_ratio, max_loss):
    opt = opt_mod.adamw(lr=0.05)
    params = _quadratic_params()
    state = opt.init(params)
    comp = gc.init_state(params)
    first = _quad_loss(params)
    ratio = None
    for _ in range(steps):
        grads, comp, wire, dense = gc.compress_grads(
            _quad_grads(params), comp, method, frac)
        ratio = dense / wire
        params, state = opt.update(grads, state, params)
    final = _quad_loss(params)
    assert final < max_loss and final < 0.01 * first, (method, first, final)
    assert ratio >= min_ratio


@pytest.mark.parametrize("shape_name", ["full_graph_sm", "minibatch_lg",
                                        "ogb_products", "molecule"])
def test_gnn_specs_equal_reference(shape_name):
    arch, jarch = get_arch(GNN), jget_arch(GNN)
    shape, jshape = arch.shape(shape_name), jarch.shape(shape_name)
    assert api._gnn_block_sizes(shape) == japi._gnn_block_sizes(jshape)
    cfg = api.resolve_config(arch.config, shape)
    jcfg = japi.resolve_config(jarch.config, jshape)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    mine = api.input_specs(cfg, shape)
    ref = japi.input_specs(jcfg, jshape)
    assert list(mine) == list(ref)
    for k, (shp, dt) in mine.items():
        assert shp == ref[k].shape, k
        assert str(dt).split(".")[-1] == str(ref[k].dtype), k
    # the abstract trees' shapes are the reference's eval_shape
    params = api.abstract_params(cfg)
    jparams = japi.abstract_params(jcfg)
    assert [tuple(a.shape) for a in _leaves(params)] == \
        [a.shape for a in _leaves(jparams)]
    st = api.abstract_opt_state(cfg, params)
    jst = japi.abstract_opt_state(jcfg, jparams)
    assert [tuple(a.shape) for a in _leaves(st)] == \
        [a.shape for a in _leaves(jst)]
    assert all(a.is_meta for a in _leaves(st))


def test_what_waits_for_later_slices_raises():
    """What is not a model config is refused by name (the LM family has
    landed: its decode step takes only an LM config)."""
    cfg = get_arch("bst").smoke_config
    with pytest.raises(TypeError, match="LM step; got RecsysConfig"):
        api.make_decode_step(cfg)
    with pytest.raises(TypeError, match="no model API for object"):
        api.model_api(object())
    with pytest.raises(TypeError, match="no synthetic data for object"):
        next(launch.data_iterator(object(), 2, 4, device="cpu"))


# -- the loop ------------------------------------------------------------------


def _gnn_data(cfg, start=0, n=40, e=120):
    """Batch i of a fixed sequence (numpy from seed i), from ``start``."""
    i = start
    while True:
        rng = np.random.default_rng(100 + i)
        yield {"node_feats": torch.from_numpy(
                   rng.normal(size=(n, cfg.in_node_dim)).astype(np.float32)),
               "edge_src": torch.from_numpy(
                   rng.integers(-1, n, size=e).astype(np.int32)),
               "edge_dst": torch.from_numpy(
                   rng.integers(-1, n, size=e).astype(np.int32)),
               "edge_feats": torch.from_numpy(
                   rng.normal(size=(e, cfg.in_edge_dim)).astype(np.float32)),
               "node_targets": torch.from_numpy(
                   rng.normal(size=(n, cfg.out_dim)).astype(np.float32)),
               "node_mask": torch.from_numpy(rng.random(n) < 0.7)}
        i += 1


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_failure_and_resume_equal_an_uninterrupted_run(tmp_path, compression):
    cfg = get_arch(GNN).smoke_config
    total, every, fail = 8, 3, 5
    full_lc = loop.LoopConfig(total_steps=total, checkpoint_every=every,
                              checkpoint_dir=str(tmp_path / "full"), lr=3e-3,
                              grad_compression=compression, keep_last=2)
    full = loop.train(cfg, _gnn_data(cfg), full_lc, device="cpu")
    lc = dataclasses.replace(full_lc, checkpoint_dir=str(tmp_path / "cut"))
    with pytest.raises(RuntimeError, match="injected failure"):
        loop.train(cfg, _gnn_data(cfg), lc, fail_at_step=fail, device="cpu")
    assert store.latest_complete(lc.checkpoint_dir).name == "step_00000003"
    resumed = loop.train(cfg, _gnn_data(cfg, start=3), lc, device="cpu")
    assert resumed.step == full.step == total
    assert len(resumed.step_seconds) == total - 3
    steps = sorted(p.name for p in (tmp_path / "cut").iterdir())
    assert steps == ["step_00000006", "step_00000008"]       # keep_last 2
    losses = [m["loss"] for m in full.metrics_history]
    assert all(np.isfinite(losses))
    if compression == "none":
        # the resumed run's checkpointed state is the whole state: bit for
        # bit (the compressor's residual restarts from zero, as in the
        # reference, so with int8 the runs part after the resume)
        assert [m["loss"] for m in resumed.metrics_history] == losses[3:]
        for a, b in zip(_leaves(resumed.params) + _leaves(resumed.opt_state),
                        _leaves(full.params) + _leaves(full.opt_state)):
            assert torch.equal(a, b)
    else:
        assert all(m["compression_ratio"] > 3.5
                   for m in resumed.metrics_history)


def _jax_gnn_data(cfg, start=0):
    for b in _gnn_data(cfg, start):
        yield {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def test_port_checkpoint_loads_in_reference(tmp_path):
    cfg = get_arch(GNN).smoke_config
    lc = loop.LoopConfig(total_steps=2, checkpoint_every=2,
                         checkpoint_dir=str(tmp_path), lr=3e-3)
    st = loop.train(cfg, _gnn_data(cfg), lc, device="cpu")
    jcfg = jget_arch(GNN).smoke_config
    jo = jopt.make_optimizer("adamw", 3e-3)
    like = jax.eval_shape(japi.model_api(jcfg).init, jax.random.key(0))
    back = jstore.load(jstore.latest_complete(tmp_path),
                       {"params": like, "opt": jax.eval_shape(jo.init, like)})
    mine = _leaves({"params": st.params, "opt": st.opt_state})
    theirs = _leaves(back)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """The reference's loop trains 2 steps and checkpoints; the port's
    ``train`` resumes from that step with the reference's parameters and
    AdamW state, and its next step matches the reference's own next step
    (the tolerances of ``test_torch_gnn.py``'s train step)."""
    jcfg = jget_arch(GNN).smoke_config
    cfg = get_arch(GNN).smoke_config
    jlc = jloop.LoopConfig(total_steps=2, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path / "ref"), lr=3e-3)
    jloop.train(jcfg, _jax_gnn_data(jcfg), jlc)
    lc = loop.LoopConfig(total_steps=3, checkpoint_every=10,
                         checkpoint_dir=str(tmp_path / "ref"), lr=3e-3)
    st = loop.train(cfg, _gnn_data(cfg, start=2), lc, device="cpu")
    assert st.step == 3 and len(st.metrics_history) == 1
    jlc3 = dataclasses.replace(jlc, total_steps=3,
                               checkpoint_dir=str(tmp_path / "ref3"))
    jst = jloop.train(jcfg, _jax_gnn_data(jcfg), jlc3)
    np.testing.assert_allclose(st.metrics_history[0]["loss"],
                               jst.metrics_history[-1]["loss"], rtol=1e-4)
    for a, b in zip(_leaves(st.params), _leaves(jst.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert int(st.opt_state["count"]) == 3


def test_launcher_batches_equal_reference():
    cfg = get_arch(GNN).smoke_config
    jcfg = jget_arch(GNN).smoke_config
    mine = launch.data_iterator(cfg, 8, 128, seed=2, device="cpu")
    theirs = jlaunch.data_iterator(jcfg, 8, 128, seed=2)
    for _ in range(2):
        a, b = next(mine), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].device == CPU
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


@pytest.mark.parametrize("arch_id", RECSYS)
def test_launcher_recsys_batches_equal_reference(arch_id):
    cfg = get_arch(arch_id).smoke_config
    jcfg = jget_arch(arch_id).smoke_config
    mine = launch.data_iterator(cfg, 8, 128, seed=3, device="cpu")
    theirs = jlaunch.data_iterator(jcfg, 8, 128, seed=3)
    for _ in range(2):
        a, b = next(mine), next(theirs)
        assert list(a) == list(b)
        for k in a:
            assert a[k].device == CPU
            assert str(a[k].dtype).removeprefix("torch.") == str(b[k].dtype)
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_launcher_main_trains_bst_on_cpu(tmp_path, capsys):
    launch.main(["--arch", "bst", "--smoke", "--steps", "3", "--device",
                 "cpu", "--batch", "16", "--ckpt-dir", str(tmp_path),
                 "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "step 0: loss=" in out
    assert store.latest_complete(tmp_path).name == "step_00000003"
    # the checkpoint holds the recsys tree: it resumes for one more step
    cfg = get_arch("bst").smoke_config
    st = loop.train(cfg, launch.data_iterator(cfg, 16, 1, device="cpu"),
                    loop.LoopConfig(total_steps=4, checkpoint_every=10,
                                    checkpoint_dir=str(tmp_path)),
                    device="cpu")
    assert st.step == 4 and len(st.metrics_history) == 1
    assert np.isfinite(st.metrics_history[0]["loss"])


def test_launcher_main_runs_three_steps_on_cpu(tmp_path, capsys):
    launch.main(["--arch", GNN, "--smoke", "--steps", "3", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                 "--compress", "topk"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "step 0: loss=" in out
    assert store.latest_complete(tmp_path).name == "step_00000003"
