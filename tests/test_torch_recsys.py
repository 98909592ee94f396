"""The port's recsys retrieval path against the JAX package's.

For the four recsys archs' smoke configs: the registry's configs equal the
reference's field for field; ``init_recsys`` builds the reference's tree
(structure and shapes); ``params_from_numpy`` carries the reference's
parameters across leaf for leaf; and on one batch (drawn by the port's
``make_batch``, with -1 candidates and -1 inside multi-hot bags)
``retrieval_scores`` equals the reference's at rtol 1e-5 / atol 1e-6 and
``make_retrieval_step(k=100)`` gives the reference's ids exactly.
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
    jparams = _np_tree(japi.model_api(jget_arch(request.param).smoke_config)
                       .init(jax.random.key(0)))
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
    ref = japi.model_api(jget_arch(arch_id).smoke_config).init(
        jax.random.key(0))
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(_np_tree(ref))
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
@pytest.mark.parametrize("shape_name", ["serve_p99", "retrieval_cand"])
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
    with pytest.raises(ValueError):
        api.input_specs(cfg, ShapeSpec("t", "recsys_train", {"batch": 4}))
