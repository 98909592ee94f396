"""The port's recsys ranking and retrieval paths against the JAX
package's.

For the four recsys archs' smoke configs: the registry's configs equal the
reference's field for field; ``init_recsys`` builds the reference's tree
(structure and shapes); ``params_from_numpy`` carries the reference's
parameters across leaf for leaf; and on one batch (drawn by the port's
``make_batch``, with -1 candidates and -1 inside multi-hot bags)
``retrieval_scores`` equals the reference's at rtol 1e-5 / atol 1e-6 and
``make_retrieval_step(k=100)`` gives the reference's ids exactly.

Ranking, on train batches made with numpy from a seed (-1 holes inside the
multi-hot bags and the behavior sequences): ``recsys_forward`` and
``recsys_loss`` at rtol 1e-5 / atol 1e-6, every gradient leaf at rtol 1e-4
/ atol 1e-5, three AdamW steps of ``make_train_step`` (losses at rtol
1e-5; parameters as ``test_train_steps_match_reference`` states), the
serve and eval steps, and the reference's own ranking tests on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import get_arch as jget_arch
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import recsys as JR
from repro_torch.config.base import ShapeSpec, get_arch, list_archs
from repro_torch.kernels import distance_matrix as kernel
from repro_torch.models import api, recsys
from repro_torch.models import layers as L

RECSYS = ["wide-deep", "deepfm", "dien", "bst"]
N_CAND = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    """{path: shape} of every leaf, paths as the tree's keys and indices."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, x in enumerate(node):
                walk(x, path + (i,))
        else:
            out[path] = tuple(node.shape)
    walk(tree, ())
    return out


@pytest.fixture(scope="module", params=RECSYS)
def arch(request):
    """(port config, JAX params as numpy, port params from them)."""
    cfg = get_arch(request.param).smoke_config
    jparams = _np_tree(jax.jit(japi.model_api(
        jget_arch(request.param).smoke_config).init)(jax.random.key(0)))
    return cfg, jparams, recsys.params_from_numpy(cfg, jparams, CPU)


def _batch(cfg, seed):
    """A retrieval batch from the port's ``make_batch``, with some -1
    candidates and -1 holes inside the multi-hot bags."""
    gen = torch.Generator().manual_seed(seed)
    shape = ShapeSpec("r", "recsys_retrieval",
                      {"batch": 3, "n_candidates": N_CAND})
    batch = api.make_batch(cfg, shape, gen, CPU)
    rng = np.random.default_rng(seed)
    cand = batch["candidates"]
    cand[torch.from_numpy(rng.random(N_CAND) < 0.02)] = -1
    sparse = batch["sparse"]
    holes = torch.from_numpy(rng.random(tuple(sparse.shape)) < 0.3)
    sparse[holes] = -1
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.mark.parametrize("arch_id", RECSYS)
def test_configs_equal_the_reference(arch_id):
    a, j = get_arch(arch_id), jget_arch(arch_id)
    for mine, ref in ((a.config, j.config), (a.smoke_config, j.smoke_config)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.total_rows() == ref.total_rows()
    assert [dataclasses.asdict(s) for s in a.shapes] == \
        [dataclasses.asdict(s) for s in j.shapes]
    assert (a.description, a.source) == (j.description, j.source)
    assert set(RECSYS) <= set(list_archs())


@pytest.mark.parametrize("arch_id", RECSYS)
def test_init_tree_matches_reference(arch_id):
    cfg = get_arch(arch_id).smoke_config
    gen = torch.Generator().manual_seed(0)
    mine = api.model_api(cfg).init(gen, CPU)
    ref = jax.eval_shape(japi.model_api(jget_arch(arch_id).smoke_config)
                         .init, jax.random.key(0))
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(ref)
    assert _shapes(mine) == _shapes(ref)
    assert all(t.dtype == torch.float32 and t.device == CPU
               for t in jax.tree_util.tree_leaves(mine))
    meta = recsys.init_recsys(cfg, None, "meta")
    assert _shapes(meta) == _shapes(ref)


def test_params_from_numpy_carries_every_leaf(arch):
    cfg, jparams, params = arch
    assert _shapes(params) == _shapes(jparams)
    for got, want in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(jparams)):
        assert np.array_equal(got.numpy(), want)


def test_params_from_numpy_checks_shapes(arch):
    cfg, jparams, _ = arch
    bad = dict(jparams, tables=(jparams["tables"][0][:-1],)
               + tuple(jparams["tables"][1:]))
    with pytest.raises(ValueError, match="shape"):
        recsys.params_from_numpy(cfg, bad, CPU)
    with pytest.raises(ValueError, match="keys"):
        recsys.params_from_numpy(cfg, {"tables": jparams["tables"]}, CPU)


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_scores_match_reference(arch, seed):
    cfg, jparams, params = arch
    batch = _batch(cfg, seed)
    before = kernel.LAUNCHES
    got = recsys.retrieval_scores(cfg, params, batch)
    assert kernel.LAUNCHES == before
    assert got.shape == (3, N_CAND) and got.dtype == torch.float32
    want = JR.retrieval_scores(cfg, jparams, _jax_batch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_step_matches_reference(arch, seed):
    cfg, jparams, params = arch
    batch = _batch(cfg, seed)
    vals, ids = api.make_retrieval_step(cfg, k=100)(params, batch)
    jvals, jids = japi.make_retrieval_step(cfg, k=100)(jparams,
                                                       _jax_batch(batch))
    assert vals.shape == ids.shape == (3, 100)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), **TOL)


def test_retrieval_top_k_keeps_the_lower_position_among_ties():
    """Every candidate the same item: all scores tie, and the step returns
    the first k positions, as ``lax.top_k`` does."""
    cfg = get_arch("bst").smoke_config
    params = recsys.init_recsys(cfg, torch.Generator().manual_seed(3), CPU)
    batch = _batch(cfg, 3)
    batch["candidates"] = torch.full((N_CAND,), 7, dtype=torch.int32)
    batch["candidates"][::2] = -1                 # zero rows: score 0
    scores = recsys.retrieval_scores(cfg, params, batch)
    _, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, ids = api.make_retrieval_step(cfg, k=10)(params, batch)
    jscores = jnp.asarray(scores.numpy())
    jvals, jidx = jax.lax.top_k(jscores, 10)
    np.testing.assert_array_equal(idx[:, :10].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(2)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(-1, 50, size=(17, 6)).astype(np.int32)
    ids[3] = -1                                    # an empty bag
    got = L.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          mode)
    want = JL.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert not got[3].any()


def test_embedding_lookup_matches_reference():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(40, 5)).astype(np.float32)
    ids = rng.integers(-1, 40, size=(6, 7)).astype(np.int32)
    got = L.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    want = JL.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch_id", RECSYS)
@pytest.mark.parametrize("shape_name", ["serve_p99", "retrieval_cand",
                                        "train_batch", "serve_bulk"])
def test_input_specs_match_reference(arch_id, shape_name):
    a, j = get_arch(arch_id), jget_arch(arch_id)
    mine = api.input_specs(a.config, a.shape(shape_name))
    ref = japi.input_specs(j.config, j.shape(shape_name))
    assert list(mine) == list(ref)
    for key, (shape, dtype) in mine.items():
        assert shape == ref[key].shape
        assert str(dtype).removeprefix("torch.") == str(ref[key].dtype)


def test_make_batch_follows_the_specs():
    cfg = get_arch("wide-deep").smoke_config
    shape = ShapeSpec("r", "recsys_retrieval",
                      {"batch": 4, "n_candidates": 100})
    batch = api.make_batch(cfg, shape, torch.Generator().manual_seed(0), CPU)
    for key, (shp, dtype) in api.input_specs(cfg, shape).items():
        assert tuple(batch[key].shape) == shp and batch[key].dtype == dtype
    sizes = cfg.multi_hot_sizes
    for f, hot in enumerate(sizes):
        col = batch["sparse"][:, f]
        assert bool((col[:, hot:] == -1).all())
        assert bool(((col[:, :hot] >= 0)
                     & (col[:, :hot] < cfg.field_vocabs[f])).all())
    assert int(batch["candidates"].max()) < cfg.field_vocabs[0]
    train = ShapeSpec("t", "recsys_train", {"batch": 64})
    batch = api.make_batch(cfg, train, torch.Generator().manual_seed(0), CPU)
    for key, (shp, dtype) in api.input_specs(cfg, train).items():
        assert tuple(batch[key].shape) == shp and batch[key].dtype == dtype
    assert set(batch["labels"].tolist()) == {0.0, 1.0}
    with pytest.raises(ValueError, match="graph_full"):
        api.input_specs(cfg, ShapeSpec("g", "graph_full", {"batch": 4}))


# -- the ranking path ----------------------------------------------------------


RANK_BATCH = 24
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_LR = 1e-2
N_STEPS = 3


def _train_batch(cfg, seed, b=RANK_BATCH):
    """A train batch made with numpy from ``seed``: the reference test's
    draws, then 30% of the sparse ids and 10% of the behavior sequence set
    to -1 (holes inside the multi-hot bags; padded sequence positions)."""
    rng = np.random.default_rng(seed)
    hot = max(cfg.multi_hot_sizes) if cfg.multi_hot_sizes else 1
    sparse = np.stack([rng.integers(0, cfg.field_vocabs[f], size=(b, hot))
                       for f in range(cfg.n_sparse)], axis=1)
    sparse[rng.random(sparse.shape) < 0.3] = -1
    batch = {"dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
             "sparse": sparse.astype(np.int32),
             "labels": rng.integers(0, 2, size=b).astype(np.float32)}
    if cfg.seq_len:
        seq = rng.integers(0, cfg.item_vocab, size=(b, cfg.seq_len))
        seq[rng.random(seq.shape) < 0.1] = -1
        batch["seq"] = seq.astype(np.int32)
        batch["target_item"] = rng.integers(0, cfg.item_vocab,
                                            size=b).astype(np.int32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ranked(arch):
    """The reference's results on one train batch, each jitted: logits,
    loss, the gradient tree, and N_STEPS AdamW steps of its
    ``make_train_step`` (losses, the parameters after each step, and the
    state after the last); with the batch they ran on."""
    cfg, jparams, _ = arch
    batch = _train_batch(cfg, 7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)

    def loss_and_logits(p, b):
        return JR.recsys_loss(cfg, p, b)[0], JR.recsys_forward(cfg, p, b)

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(jp, jb)
    jcfg = jget_arch(cfg.arch_id.removesuffix("-smoke")).smoke_config
    step, opt = japi.make_train_step(jcfg, lr=STEP_LR)
    step = jax.jit(step)
    state, losses, trail = opt.init(jp), [], []
    for _ in range(N_STEPS):
        jp, state, m = step(jp, state, jb)
        losses.append(float(m["loss"]))
        trail.append(_np_tree(jp))
    return {"batch": batch, "logits": np.asarray(logits),
            "loss": float(loss), "grads": _np_tree(grads),
            "losses": losses, "trail": trail, "state": _np_tree(state)}


def _named_leaves(tree):
    return [(jax.tree_util.keystr(path), leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_forward_and_loss_match_reference(arch, ranked):
    cfg, _, params = arch
    batch = _torch_batch(ranked["batch"])
    logits = recsys.recsys_forward(cfg, params, batch)
    assert logits.shape == (RANK_BATCH,) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ranked["logits"], **TOL)
    loss, metrics = recsys.recsys_loss(cfg, params, batch)
    assert loss.shape == () and metrics["loss"] is loss
    np.testing.assert_allclose(float(loss), ranked["loss"], **TOL)
    # the model's API names the same loss
    api_loss, _ = api.model_api(cfg).loss(params, batch)
    assert float(api_loss) == float(loss)


def test_every_gradient_leaf_matches_reference(arch, ranked):
    cfg, _, params = arch
    loss, metrics, grads = api.value_and_grad(
        api.model_api(cfg).loss, params, _torch_batch(ranked["batch"]))
    np.testing.assert_allclose(float(loss), ranked["loss"], **TOL)
    assert float(metrics["loss"]) == float(loss)
    mine, ref = _named_leaves(grads), _named_leaves(ranked["grads"])
    assert [n for n, _ in mine] == [n for n, _ in ref]
    for (name, g), (_, w) in zip(mine, ref):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **GRAD_TOL)
    # field 0's table: the rows no id of the batch touches get none
    ids = ranked["batch"]["sparse"][:, 0, 0]
    untouched = np.ones(cfg.field_vocabs[0], bool)
    untouched[ids[ids >= 0]] = False
    assert not grads["tables"][0][torch.from_numpy(untouched)].any()


def test_train_steps_match_reference(arch, ranked):
    """N_STEPS AdamW steps from the same parameters on the same batch.

    Losses at rtol 1e-5. Parameters at rtol 1e-5 / atol 2e-6 (lr 1e-2:
    the gradients' 1e-4 relative tolerance moves an update by about
    lr x 1e-4), except where AdamW's first update divides a near-zero
    gradient by itself: where the reference's first gradient is nonzero
    and below ``near_zero`` (1e-7, ten times AdamW's eps of 1e-8),
    g / (|g| + eps) turns the f32 gradient's last bits into up to lr of
    movement a step, so those entries are held to N_STEPS x lr. At this
    seed they are 3 entries of DIEN's first MLP layer (one of which moves
    5.7e-6) and DIEN's attention vector, whose gradient is ~1e-7 at init
    (near-uniform scores) and ~1e-14 in the target's rows (a softmax over
    T does not see a term that is the same at every t)."""
    near_zero = 1e-7
    cfg, _, params = arch
    step, opt = api.make_train_step(cfg, lr=STEP_LR)
    batch = _torch_batch(ranked["batch"])
    state = opt.init(params)
    p = params
    for i in range(N_STEPS):
        p, state, m = step(p, state, batch)
        np.testing.assert_allclose(float(m["loss"]), ranked["losses"][i],
                                   rtol=1e-5)
    mine = _named_leaves(p)
    ref = _named_leaves(ranked["trail"][-1])
    g0 = dict(_named_leaves(ranked["grads"]))
    for (name, a), (_, w) in zip(mine, ref):
        tiny = (np.abs(g0[name]) < near_zero) & (g0[name] != 0)
        a = a.numpy()
        np.testing.assert_allclose(a[~tiny], w[~tiny], rtol=1e-5, atol=2e-6,
                                   err_msg=name)
        assert np.abs(a[tiny] - w[tiny]).max(initial=0.0) \
            <= N_STEPS * STEP_LR, name
    assert int(state["count"]) == N_STEPS == int(ranked["state"]["count"])
    # the step changes neither input
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(arch[2])):
        assert a is b


def test_serve_and_eval_steps_equal_the_forward_and_loss(arch, ranked):
    cfg, _, params = arch
    batch = _torch_batch(ranked["batch"])
    logits = recsys.recsys_forward(cfg, params, batch)
    served = api.make_serve_step(cfg)(params, batch)
    assert not served.requires_grad
    assert torch.equal(served, logits)
    ev = api.make_eval_step(cfg)(params, batch)
    assert float(ev["loss"]) == float(recsys.recsys_loss(cfg, params,
                                                         batch)[0])


@pytest.mark.parametrize("arch_id", RECSYS)
def test_train_step_reduces_loss(arch_id):
    """The reference's test on the port: 20 AdamW steps at lr 1e-2 on one
    64-row batch lower the loss."""
    rng = np.random.default_rng(1)
    cfg = get_arch(arch_id).smoke_config
    params = api.model_api(cfg).init(torch.Generator().manual_seed(0), CPU)
    step, opt = api.make_train_step(cfg, lr=1e-2)
    opt_state = opt.init(params)
    hot = max(cfg.multi_hot_sizes) if cfg.multi_hot_sizes else 1
    batch = {"dense": rng.normal(size=(64, cfg.n_dense)).astype(np.float32),
             "sparse": np.stack(
                 [rng.integers(0, cfg.field_vocabs[f], size=(64, hot))
                  for f in range(cfg.n_sparse)], axis=1).astype(np.int32)}
    if cfg.seq_len:
        batch["seq"] = rng.integers(0, cfg.item_vocab,
                                    size=(64, cfg.seq_len)).astype(np.int32)
        batch["target_item"] = rng.integers(0, cfg.item_vocab,
                                            size=64).astype(np.int32)
    batch["labels"] = rng.integers(0, 2, size=64).astype(np.float32)
    batch = _torch_batch(batch)
    first = None
    for _ in range(20):
        params, opt_state, m = step(params, opt_state, batch)
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first, (arch_id, first, float(m["loss"]))


def test_dien_attention_shifts_with_target():
    """The reference's test on the port: other target items change DIEN's
    prediction (the AUGRU attention conditions on the target)."""
    cfg = get_arch("dien").smoke_config
    params = api.model_api(cfg).init(torch.Generator().manual_seed(0), CPU)
    batch = _torch_batch(_train_batch(cfg, 5, b=4))
    out1 = recsys.recsys_forward(cfg, params, batch)
    batch2 = dict(batch,
                  target_item=(batch["target_item"] + 7) % cfg.item_vocab)
    out2 = recsys.recsys_forward(cfg, params, batch2)
    assert float((out1 - out2).abs().max()) > 1e-6


def test_gru_cell_matches_reference():
    """One GRU and one AUGRU step in the reference's gate layout."""
    rng = np.random.default_rng(8)
    d, g, b = 5, 7, 6
    p = {"wx": rng.normal(size=(d, 3 * g)).astype(np.float32),
         "wh": rng.normal(size=(g, 3 * g)).astype(np.float32),
         "b": rng.normal(size=(3 * g,)).astype(np.float32)}
    h = rng.normal(size=(b, g)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    att = rng.random(b).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for a in (None, att):
        got = recsys._gru_cell(tp, torch.from_numpy(h), torch.from_numpy(x),
                               None if a is None else torch.from_numpy(a))
        want = JR._gru_cell(jp, jnp.asarray(h), jnp.asarray(x),
                            None if a is None else jnp.asarray(a))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
