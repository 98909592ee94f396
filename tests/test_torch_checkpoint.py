"""The port's checkpoint store (``repro_torch.checkpoint.store``) against
the JAX package's ``repro.checkpoint.store``.

The reference's three cases run on the port (a round trip with a bf16
leaf, a corrupt leaf detected, an incomplete step skipped), on the CPU.
Both packages name the same leaves the same way (an f32 graph, an int8
graph, a nested dict/list/tuple tree) and read each other's files: a graph
the reference saved loads in the port and searches equal to
``graph_from_numpy`` of the same arrays (ids, dists and every
``SearchStats`` field, bit for bit: the same arrays on the same engine), a
graph the port saved loads in the reference's ``load`` with the JAX graph
as ``like``, with equal arrays. A ``ShardedNavix``'s per-shard graphs,
saved as a list with the grid and config in ``extra`` (by either
package), rebuild a ``ShardedNavix`` that searches equal to the original
at S in {1, 2, 4}. The shape and checksum errors carry the reference's
messages, and ``load`` with no device runs on CUDA or raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core.graph import HnswGraph as JHnswGraph
from repro.core.quantize import QuantizedStore as JQuantizedStore
from repro_torch.checkpoint import store
from repro_torch.common.util import leaf_key, tree_flatten_with_path
from repro_torch.core import bitset
from repro_torch.core import search_batch as tsb
from repro_torch.core.distributed import ShardedNavix, make_mesh
from repro_torch.core.graph import FIELDS, HnswGraph, graph_from_numpy
from repro_torch.core.heuristics import Heuristic
from repro_torch.core.navix import NavixConfig
from repro_torch.core.quantize import QuantizedStore, quantize
from repro_torch.core.search import SearchParams
from repro.data.synthetic import gaussian_mixture

CPU = torch.device("cpu")
META = torch.device("meta")
K, EFS = 10, 40
SIGMAS = (1.0, 0.3, 0.05)
SHARD_COUNTS = [1, 2, 4]


def _leaves(tree):
    return [x for _, x in tree_flatten_with_path(tree)[0]]


# -- the reference's cases ----------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "nested": {"b": torch.ones((3, 4), dtype=torch.bfloat16)},
            "tup": (torch.zeros(2), torch.ones(3))}
    store.save(tmp_path, 7, tree, extra={"note": "hi"})
    latest = store.latest_complete(tmp_path)
    assert latest is not None and latest.name == "step_00000007"
    like = {"a": torch.empty(10, device=META),
            "nested": {"b": torch.empty((3, 4), dtype=torch.bfloat16,
                                        device=META)},
            "tup": (torch.empty(2, device=META), torch.empty(3, device=META))}
    back = store.load(latest, like, device="cpu")
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype and b.device == CPU
        assert torch.equal(a, b)
    manifest = store.load_manifest(latest)
    assert manifest["extra"] == {"note": "hi"} and manifest["step"] == 7
    assert manifest["leaves"]["nested.b"]["dtype"] == "bfloat16"


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.float32)}
    d = store.save(tmp_path, 1, tree)
    npy = next(d.glob("*.npy"))
    arr = np.load(npy)
    arr[0] += 1
    np.save(npy, arr)
    with pytest.raises(IOError, match="checksum"):
        store.load(d, {"a": torch.empty(4, device=META)}, device="cpu")


def test_incomplete_checkpoint_skipped(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.float32)}
    store.save(tmp_path, 1, tree)
    d2 = store.save(tmp_path, 2, tree)
    (d2 / "COMMIT").unlink()                   # simulate preemption mid-write
    latest = store.latest_complete(tmp_path)
    assert latest.name == "step_00000001"
    assert store.latest_complete(tmp_path / "absent") is None


# -- the format both packages share ----------------------------------------------

@pytest.fixture(scope="module")
def graphs(index):
    """{"f32" | "int8": (port graph on the CPU, JAX graph)} over the same
    arrays (the int8 codes made once, by the port)."""
    port = graph_from_numpy({f: np.asarray(getattr(index.graph, f))
                             for f in FIELDS}, device="cpu")
    qport = port._replace(vectors=quantize(port.vectors))
    qref = index.graph._replace(vectors=JQuantizedStore(
        codes=jnp.asarray(qport.vectors.codes.numpy()),
        scale=jnp.asarray(qport.vectors.scale.numpy())))
    return {"f32": (port, index.graph), "int8": (qport, qref)}


def _ref_keys(tree):
    return [jstore._leaf_key(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("resident", ["f32", "int8"])
def test_leaf_keys_match_reference(graphs, resident):
    port, ref = graphs[resident]
    keys = [leaf_key(p) for p, _ in tree_flatten_with_path(port)[0]]
    assert keys == _ref_keys(ref)
    want = [f".{f}" for f in FIELDS[:-1]]
    want += ([".vectors..codes", ".vectors..scale"] if resident == "int8"
             else [".vectors"])
    assert keys == want


def test_leaf_keys_of_a_nested_tree_match_reference():
    tree = {"g": [torch.zeros(2), (torch.ones(3),)]}
    keys = [leaf_key(p) for p, _ in tree_flatten_with_path(tree)[0]]
    assert keys == _ref_keys({"g": [jnp.zeros(2), (jnp.ones(3),)]}) \
        == ["g.0", "g.1.0"]


def _search(graph, seed=3):
    """The batched engine at SIGMAS' per-lane masks on 12 queries."""
    rng = np.random.default_rng(seed)
    n = graph.n
    Q = torch.from_numpy(rng.normal(size=(12, graph.dim)).astype(np.float32))
    masks = np.stack([rng.random(n) < SIGMAS[j % len(SIGMAS)]
                      for j in range(len(Q))])
    sel = bitset.from_words(bitset.pack_np(masks), CPU)
    return tsb.search_many(graph, Q, sel,
                           SearchParams(k=K, efs=EFS, heuristic=int(
                               Heuristic.from_name("adaptive_local"))))


def _assert_same_search(a, b):
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.dists, b.dists)
    for f in a.stats._fields:
        assert torch.equal(getattr(a.stats, f), getattr(b.stats, f)), f


def _arrays(graph):
    """The graph's arrays as ``graph_from_numpy`` takes them."""
    out = {f: getattr(graph, f).numpy() for f in FIELDS[:-1]}
    v = graph.vectors
    out["vectors"] = ({"codes": v.codes.numpy(), "scale": v.scale.numpy()}
                      if isinstance(v, QuantizedStore) else v.numpy())
    return out


@pytest.mark.parametrize("resident", ["f32", "int8"])
def test_reference_checkpoint_loads_in_port_and_searches_equal(
        tmp_path, graphs, resident):
    port, ref = graphs[resident]
    d = jstore.save(tmp_path, 3, ref, extra={"resident": resident})
    back = store.load(d, port.to(META), device="cpu")
    assert isinstance(back, HnswGraph)
    assert back.entry_pos.shape == () and back.entry_pos.dtype == torch.int32
    assert (isinstance(back.vectors, QuantizedStore)) == (resident == "int8")
    for a, b in zip(_leaves(back), _leaves(port)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _assert_same_search(_search(back),
                        _search(graph_from_numpy(_arrays(port), "cpu")))


@pytest.mark.parametrize("resident", ["f32", "int8"])
def test_port_checkpoint_loads_in_reference(tmp_path, graphs, resident):
    port, ref = graphs[resident]
    d = store.save(tmp_path, 5, port)
    back = jstore.load(d, jax.eval_shape(lambda: ref))
    for (pa, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                          jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype, jstore._leaf_key(pa)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the manifests agree leaf for leaf (shape, dtype, SHA1)
    theirs = jstore.load_manifest(jstore.save(tmp_path / "ref", 5, ref))
    ours = store.load_manifest(d)
    assert ours["leaves"] == theirs["leaves"]


def test_bf16_and_unsigned_words_cross_both_ways(tmp_path):
    w = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    words = np.array([0xFFFFFFFF, 0x80000001, 7], np.uint32)
    # reference -> port: bf16 by its bits, uint32 words as the port's int32
    d = jstore.save(tmp_path / "ref", 1, {"w": jnp.asarray(w, jnp.bfloat16),
                                          "words": jnp.asarray(words)})
    back = store.load(d, {"w": torch.empty((5, 3), dtype=torch.bfloat16,
                                           device=META),
                          "words": torch.empty(3, dtype=torch.int32,
                                               device=META)}, device="cpu")
    assert torch.equal(back["w"], torch.from_numpy(w).to(torch.bfloat16))
    assert np.array_equal(back["words"].numpy(), words.view(np.int32))
    # port -> reference
    d = store.save(tmp_path / "port", 1,
                   {"w": torch.from_numpy(w).to(torch.bfloat16)})
    got = jstore.load(d, {"w": jax.ShapeDtypeStruct((5, 3), jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(got["w"], np.float32),
                                  np.asarray(jnp.asarray(w, jnp.bfloat16),
                                             np.float32))


def test_shape_and_checksum_errors_are_the_reference_messages(tmp_path):
    d = store.save(tmp_path / "port", 1,
                   {"a": torch.arange(4, dtype=torch.float32)})
    jd = jstore.save(tmp_path / "ref", 1,
                     {"a": jnp.arange(4, dtype=jnp.float32)})
    with pytest.raises(ValueError) as ours:
        store.load(d, {"a": torch.empty(5, device=META)}, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jstore.load(jd, {"a": jax.ShapeDtypeStruct((5,), jnp.float32)})
    assert str(ours.value) == str(theirs.value) \
        == "a: checkpoint shape (4,) != expected (5,)"
    for where in (d, jd):
        npy = where / "a.npy"
        arr = np.load(npy)
        arr[1] = -1.0
        np.save(npy, arr)
    with pytest.raises(IOError) as ours:
        store.load(d, {"a": torch.empty(4, device=META)}, device="cpu")
    with pytest.raises(IOError) as theirs:
        jstore.load(jd, {"a": jax.ShapeDtypeStruct((4,), jnp.float32)})
    assert str(ours.value) == str(theirs.value) == "checksum mismatch for a"


def test_dtype_mismatch_raises(tmp_path):
    d = store.save(tmp_path, 1, {"a": torch.arange(4, dtype=torch.int32)})
    with pytest.raises(ValueError, match="a: checkpoint dtype int32"):
        store.load(d, {"a": torch.empty(4, device=META)}, device="cpu")


def test_load_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    d = store.save(tmp_path, 1, {"a": torch.arange(4, dtype=torch.float32)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        store.load(d, {"a": torch.empty(4, device=META)})


def test_save_replaces_a_step_and_clears_a_stale_tmp(tmp_path):
    store.save(tmp_path, 1, {"a": torch.zeros(2)})
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "junk.npy").write_text("x")
    d = store.save(tmp_path, 2, {"a": torch.ones(2)})
    assert not (tmp_path / "step_00000002.tmp").exists()
    assert sorted(p.name for p in d.iterdir()) == ["COMMIT", "a.npy",
                                                   "manifest.json"]
    d = store.save(tmp_path, 2, {"a": torch.full((2,), 3.0)})
    back = store.load(d, {"a": torch.empty(2, device=META)}, device="cpu")
    assert torch.equal(back["a"], torch.full((2,), 3.0))
    assert json.loads((d / "manifest.json").read_text())["step"] == 2


# -- sharded indexes ---------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_env():
    """(queries, per-lane masks, factory(S) -> port ShardedNavix on a
    (1, S) CPU grid), built once per S."""
    X, _, centers = gaussian_mixture(640, 16, 8, seed=0)
    X = X[:637]                          # S in {2, 4} pads the last shard
    rng = np.random.default_rng(7)
    base = centers[rng.integers(0, len(centers), size=8)]
    qs = (base + 0.25 * rng.normal(size=base.shape)).astype(np.float32)
    masks = np.stack([rng.random(len(X)) < SIGMAS[j % len(SIGMAS)]
                      for j in range(len(qs))])
    cfg = NavixConfig(m_u=8, ef_construction=48, metric="l2", seed=0)
    built = {}

    def factory(s):
        if s not in built:
            built[s] = ShardedNavix.build(X, cfg,
                                          make_mesh((1, s), device="cpu"))
        return built[s]

    return qs, masks, factory


def _extra(sn):
    return {"grid": [sn.lane_shards, sn.n_shards], "n_local": sn.n_local,
            "n_total": sn.n_total, "config": sn.config._asdict()}


def _rebuild(d, like):
    """A ShardedNavix from a checkpoint of its per-shard graph list."""
    extra = store.load_manifest(d)["extra"]
    graphs = store.load(d, like, device="cpu")
    return ShardedNavix(mesh=make_mesh(tuple(extra["grid"]), device="cpu"),
                        graphs=graphs, n_local=extra["n_local"],
                        n_total=extra["n_total"],
                        config=NavixConfig(**extra["config"]))


def _same_sharded(a, b, qs, masks):
    ra = a.search_many(qs, semimask=masks, k=6, efs=24)
    rb = b.search_many(qs, semimask=masks, k=6, efs=24)
    _assert_same_search(ra, rb)


@pytest.mark.parametrize("s", SHARD_COUNTS)
def test_sharded_graphs_roundtrip_and_search_equal(tmp_path, shard_env, s):
    qs, masks, factory = shard_env
    sn = factory(s)
    d = store.save(tmp_path, 1, sn.graphs, extra=_extra(sn))
    keys = list(store.load_manifest(d)["leaves"])
    assert keys[0] == "0..lower" and keys[-1] == f"{s - 1}..vectors"
    assert keys == _ref_keys([_jax_graph(g) for g in sn.graphs])
    back = _rebuild(d, [g.to(META) for g in sn.graphs])
    assert (back.n_shards, back.n_local, back.n_total) == (
        s, sn.n_local, sn.n_total)
    assert back.config == sn.config
    _same_sharded(sn, back, qs, masks)


def _jax_graph(g):
    return JHnswGraph(*(jnp.asarray(t.numpy()) for t in g))


@pytest.mark.parametrize("s", SHARD_COUNTS)
def test_sharded_graphs_cross_both_ways(tmp_path, shard_env, s):
    qs, masks, factory = shard_env
    sn = factory(s)
    jgraphs = [_jax_graph(g) for g in sn.graphs]
    # reference-written -> the port rebuilds and searches equal
    d = jstore.save(tmp_path / "ref", 1, jgraphs, extra=_extra(sn))
    _same_sharded(sn, _rebuild(d, [g.to(META) for g in sn.graphs]), qs,
                  masks)
    # port-written -> the reference loads equal arrays
    d = store.save(tmp_path / "port", 1, sn.graphs, extra=_extra(sn))
    back = jstore.load(d, jax.eval_shape(lambda: jgraphs))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jgraphs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
