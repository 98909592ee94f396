"""The port's halo-partitioned MeshGraphNet (``models/gnn_partitioned.py``)
against the JAX package's and against the port's own unpartitioned model.

* ``partitioned_input_specs`` equals the reference's for every
  MeshGraphNet shape at P in {4, 256}.
* Under the SMOKE config (f32), on a partitioned batch made with numpy from
  a seed (-1 padding in ``edge_dst``, ``edge_src`` and ``send_idx``), the
  loss and every gradient equal the reference's ``partitioned_loss`` at
  rtol 1e-4 / atol 1e-5: at P = 1 on a 1-device mesh in this process
  (remat on and off), and at P = 4 on a 4-device mesh in a process of its
  own, against both of the port's forms: ``mesh=None`` over the stacked
  partitions, and a ``DeviceMesh`` of 4 gloo ranks (4 processes), each
  holding its partition as the local shard of a ``DTensor``.
* Owner-computes equals the whole graph: ``chip_smoke.py``'s grid graph,
  split into strips by its ``strip_partition``, gives the loss and
  gradients of ``gnn.gnn_loss`` on the graph unpartitioned, in both forms.
* Permuting the edges within a partition leaves the loss as it was; every
  block aggregates through one ``ops.csr_segment_sum`` call.
"""

import dataclasses
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.config.base import get_arch as jget_arch
from repro.models import api as japi
from repro.models import gnn as jgnn
from repro.models import gnn_partitioned as jgp
from repro_torch.common.util import tree_leaves
from repro_torch.config.base import get_arch
from repro_torch.kernels import ops
from repro_torch.models import api, gnn
from repro_torch.models import gnn_partitioned as gp

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
TOL = dict(rtol=1e-4, atol=1e-5)
RANKS = 4
TIMEOUT_S = 240
#: the toy layout: node and edge slots a partition, halo slots a pair
NL, EL, S = 12, 40, 3


def _smoke(remat=False):
    return dataclasses.replace(get_arch("meshgraphnet").smoke_config,
                               remat=remat)


def _jcfg(cfg):
    return jgnn.GNNConfig(**dataclasses.asdict(cfg))


def _np_params(cfg):
    return jax.tree_util.tree_map(
        np.asarray, jgnn.init_gnn(_jcfg(cfg), jax.random.key(0)))


def _batch(cfg, n_parts: int, seed: int = 0) -> dict:
    """A random partitioned batch: destinations in [0, NL), sources in the
    extended range [0, NL + P * S), send slots in [0, NL); a fifth of the
    destinations, a tenth of the sources and a third of the send slots -1;
    about two thirds of the nodes unmasked."""
    rng = np.random.default_rng(seed)
    p = n_parts
    ed = rng.integers(0, NL, (p, EL)).astype(np.int32)
    ed[rng.random((p, EL)) < 0.2] = -1
    es = rng.integers(0, NL + p * S, (p, EL)).astype(np.int32)
    es[rng.random((p, EL)) < 0.1] = -1
    send = rng.integers(0, NL, (p, p, S)).astype(np.int32)
    send[rng.random((p, p, S)) < 0.3] = -1
    return {"node_feats": rng.normal(size=(p, NL, cfg.in_node_dim)
                                     ).astype(np.float32),
            "edge_src": es, "edge_dst": ed,
            "edge_feats": rng.normal(size=(p, EL, cfg.in_edge_dim)
                                     ).astype(np.float32),
            "send_idx": send,
            "node_targets": rng.normal(size=(p, NL, cfg.out_dim)
                                       ).astype(np.float32),
            "node_mask": rng.random((p, NL)) < 0.66}


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _port(cfg, jparams, batch, mesh=None):
    """(loss, grads as numpy leaves) of the port's partitioned loss."""
    params = gnn.params_from_numpy(cfg, jparams, "cpu")
    loss, _, grads = api.value_and_grad(gp.partitioned_loss(cfg, mesh),
                                        params, _tbatch(batch))
    return float(loss), [g.numpy() for g in tree_leaves(grads)]


def _assert_equal(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert len(got[1]) == len(want[1])
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        np.testing.assert_allclose(a, b, err_msg=f"leaf {i}", **TOL)


# -- the layout --------------------------------------------------------------


@pytest.mark.parametrize("n_parts", [4, 256])
@pytest.mark.parametrize("shape_name", [
    s.name for s in get_arch("meshgraphnet").shapes])
def test_input_specs_equal_the_reference(shape_name, n_parts):
    arch, jarch = get_arch("meshgraphnet"), jget_arch("meshgraphnet")
    cfg = api.resolve_config(arch.config, arch.shape(shape_name))
    jcfg = japi.resolve_config(jarch.config, jarch.shape(shape_name))
    mine = gp.partitioned_input_specs(cfg, arch.shape(shape_name), n_parts)
    want = jgp.partitioned_input_specs(jcfg, jarch.shape(shape_name),
                                       n_parts)
    assert list(mine) == list(want) == list(gp.KEYS)
    for k, (shape, dtype) in mine.items():
        assert shape == want[k].shape, k
        assert str(dtype).removeprefix("torch.") == str(want[k].dtype), k


# -- against the reference -----------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_one_partition_matches_the_reference(remat):
    cfg = _smoke(remat)
    jparams, batch = _np_params(cfg), _batch(cfg, 1)
    mesh = jax.make_mesh((1,), ("x",))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jgp.partitioned_loss(_jcfg(cfg), mesh), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, jparams),
            {k: jnp.asarray(v) for k, v in batch.items()})
    want = (float(jl), [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)])
    _assert_equal(_port(cfg, jparams, batch), want)


#: the reference's partitioned loss on a 4-device mesh, remat off and on,
#: on the batch and parameters of ``inputs.npz``
REFERENCE_P4 = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from repro.config.base import get_arch
from repro.models import gnn_partitioned as jgp

out = sys.argv[1]
data = dict(np.load(os.path.join(out, "inputs.npz")))
keys = [k for k in data if k.startswith("p/")]
batch = {k: jnp.asarray(v) for k, v in data.items() if not k.startswith("p/")}
mesh = jax.make_mesh((4,), ("x",), axis_types=(jax.sharding.AxisType.Auto,))
for remat in (False, True):
    cfg = dataclasses.replace(get_arch("meshgraphnet").smoke_config,
                              remat=remat)
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(
            __import__("repro.models.gnn", fromlist=["x"]).init_gnn(
                cfg, jax.random.key(0))),
        [jnp.asarray(data[k]) for k in keys])
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jgp.partitioned_loss(cfg, mesh), has_aux=True))(params, batch)
    np.savez(os.path.join(out, f"ref_{remat}.npz"), loss=np.asarray(loss),
             **{f"g{i:03d}": np.asarray(g)
                for i, g in enumerate(jax.tree_util.tree_leaves(grads))})
"""


@pytest.fixture(scope="module")
def p4(tmp_path_factory):
    """The P = 4 batch and parameters, and the reference's results on a
    4-device mesh (a process of its own): {"batch", "params", remat ->
    (loss, grads)}."""
    out = tmp_path_factory.mktemp("p4")
    cfg = _smoke()
    jparams, batch = _np_params(cfg), _batch(cfg, RANKS, seed=1)
    leaves = jax.tree_util.tree_leaves(jparams)
    np.savez(out / "inputs.npz", **batch,
             **{f"p/{i:03d}": v for i, v in enumerate(leaves)})
    proc = subprocess.run([sys.executable, "-c", REFERENCE_P4, str(out)],
                          env={**os.environ, "PYTHONPATH": SRC},
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = {"batch": batch, "params": jparams, "dir": out}
    for remat in (False, True):
        r = dict(np.load(out / f"ref_{remat}.npz"))
        res[remat] = (float(r.pop("loss")), [r[k] for k in sorted(r)])
    return res


@pytest.mark.parametrize("remat", [False, True])
def test_four_stacked_partitions_match_the_reference(p4, remat):
    _assert_equal(_port(_smoke(remat), p4["params"], p4["batch"]), p4[remat])


#: one gloo rank of the DeviceMesh form: its partition as the local shard
#: of DTensors sharded on dim 0 over a (2, 2) mesh, the parameters plain
#: tensors; rank 0 saves the loss and the gradients
WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard, distribute_tensor

from repro_torch.common.util import tree_leaves
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, gnn
from repro_torch.models import gnn_partitioned as gp
import pickle

rank, port, path, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                         sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
with open(path, "rb") as f:
    cfg, jparams, batch = pickle.load(f)
params = gnn.params_from_numpy(cfg, jparams, "cpu")
with make_host_mesh(model=2, device="cpu") as mesh:
    placed = {k: distribute_tensor(torch.from_numpy(v), mesh,
                                   [Shard(0), Shard(0)])
              for k, v in batch.items()}
    loss, _, grads = api.value_and_grad(gp.partitioned_loss(cfg, mesh),
                                        params, placed)
if rank == 0:
    np.savez(out, loss=loss.numpy(),
             **{f"g{i:03d}": g.numpy() for i, g in
                enumerate(tree_leaves(grads))})
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo(tmp_path, cfg, jparams, batch):
    """(loss, grads) of the DeviceMesh form on 4 gloo ranks."""
    import pickle

    path, out = tmp_path / "job.pkl", tmp_path / "mesh.npz"
    path.write_bytes(pickle.dumps((cfg, jparams, batch)))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(port), str(path), str(out)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * RANKS, logs[0][-3000:]
    r = dict(np.load(out))
    return float(r.pop("loss")), [r[k] for k in sorted(r)]


def test_four_gloo_ranks_match_the_reference(p4, tmp_path):
    got = _gloo(tmp_path, _smoke(), p4["params"], p4["batch"])
    _assert_equal(got, p4[False])


# -- owner-computes equals the whole graph ---------------------------------------


@pytest.fixture(scope="module")
def grid():
    """A 6 x 8 grid graph (radius^2 2: 8 in-edges inside the grid) in 4
    strips of 2 columns, and the SMOKE parameters."""
    cfg = _smoke()
    whole = chip_smoke.grid_graph(6, 8, 2, cfg.in_node_dim, cfg.in_edge_dim,
                                  cfg.out_dim, seed=3)
    parts, s = chip_smoke.strip_partition(whole, RANKS, nl=14, el=96)
    return whole, parts, s, _np_params(cfg)


def test_strip_partition_lays_out_the_halo(grid):
    whole, parts, s, _ = grid
    assert s == 6                         # one column of 6 rows a neighbour
    assert parts["send_idx"].shape == (RANKS, RANKS, s)
    # interior strips hear from both neighbours, the end strips from one
    heard = (parts["send_idx"] >= 0).any(axis=2)
    assert heard.sum(axis=0).tolist() == [1, 2, 2, 1]
    assert (parts["edge_dst"] >= 0).sum() == len(whole["edge_dst"])
    assert parts["node_mask"].sum() == len(whole["node_feats"])


@pytest.mark.parametrize("remat", [False, True])
def test_owner_computes_equals_the_whole_graph(grid, remat):
    whole, parts, _, jparams = grid
    cfg = _smoke(remat)
    params = gnn.params_from_numpy(cfg, jparams, "cpu")
    loss, _, grads = api.value_and_grad(
        lambda p, b: gnn.gnn_loss(cfg, p, b), params, _tbatch(whole))
    want = (float(loss), [g.numpy() for g in tree_leaves(grads)])
    _assert_equal(_port(cfg, jparams, parts), want)


def test_owner_computes_on_gloo_ranks_equals_the_whole_graph(grid, tmp_path):
    whole, parts, _, jparams = grid
    cfg = _smoke()
    params = gnn.params_from_numpy(cfg, jparams, "cpu")
    loss, _, grads = api.value_and_grad(
        lambda p, b: gnn.gnn_loss(cfg, p, b), params, _tbatch(whole))
    want = (float(loss), [g.numpy() for g in tree_leaves(grads)])
    _assert_equal(_gloo(tmp_path, cfg, jparams, parts), want)


def test_permuting_a_partitions_edges_leaves_the_loss(grid):
    _, parts, _, jparams = grid
    cfg = _smoke()
    params = gnn.params_from_numpy(cfg, jparams, "cpu")
    rng = np.random.default_rng(4)
    perm = dict(parts)
    for k in ("edge_src", "edge_dst", "edge_feats"):
        perm[k] = parts[k].copy()
    for p in range(RANKS):
        order = rng.permutation(parts["edge_dst"].shape[1])
        for k in ("edge_src", "edge_dst", "edge_feats"):
            perm[k][p] = parts[k][p][order]
    fn = gp.partitioned_loss(cfg)
    a = fn(params, _tbatch(parts))[0]
    b = fn(params, _tbatch(perm))[0]
    np.testing.assert_allclose(float(b), float(a), rtol=1e-5)


def test_each_block_aggregates_in_one_segment_sum(grid, monkeypatch):
    _, parts, _, jparams = grid
    cfg = _smoke()
    calls = []
    real = ops._segment_sum

    def spy(messages, dst_sorted, n):
        calls.append((dst_sorted.clone(), n))
        return real(messages, dst_sorted, n)

    monkeypatch.setattr(ops, "_segment_sum", spy)
    params = gnn.params_from_numpy(cfg, jparams, "cpu")
    with torch.no_grad():
        gp.partitioned_loss(cfg)(params, _tbatch(parts))
    assert len(calls) == cfg.n_layers
    for dst, n in calls:
        assert n == RANKS * parts["node_feats"].shape[1]
        real_dst = dst[dst >= 0]
        # sorted by (partition, destination), padding last
        assert torch.equal(real_dst, torch.sort(real_dst).values)
        assert (dst[len(real_dst):] < 0).all()


def test_a_mesh_holds_one_partition_a_rank(grid):
    """On a 1-rank mesh the loss takes one partition; four raise."""
    from repro_torch.launch.mesh import make_host_mesh

    _, parts, _, jparams = grid
    cfg = _smoke()
    params = gnn.params_from_numpy(cfg, jparams, "cpu")
    with make_host_mesh(device="cpu") as mesh:
        with pytest.raises(ValueError, match="one partition a rank"):
            gp.partitioned_loss(cfg, mesh)(params, _tbatch(parts))
        one = {k: v[:1] for k, v in _batch(cfg, 1).items()}
        got = gp.partitioned_loss(cfg, mesh)(params, _tbatch(one))[0]
    want = gp.partitioned_loss(cfg)(params, _tbatch(one))[0]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
