"""The LM path laid out over a mesh, against itself unsharded and against
the JAX package.

* gemma2-9b SMOKE's loss and every gradient, its parameters and tokens
  placed by ``distributed.sharding`` on a (2, 2) ("data", "model") mesh of
  4 gloo ranks (4 processes on the CPU) and run under the model's
  activation hints, equal the unsharded loss and gradients at rtol 1e-5 /
  atol 1e-6 (f32: the sharded products and reductions sum in other
  orders).
* ``moe_apply`` grouped by data shard (G = 2, under a policy over a mesh
  whose data axis is 2) equals the reference's at G = 2 (run in a process
  of its own with 4 placeholder CPU devices) at rtol 1e-5 / atol 1e-6, and
  at a capacity factor that drops tokens it differs from G = 1.
* One Adafactor step of gemma2-9b SMOKE's ``make_train_step`` with remat
  on equals the reference's: the loss at rtol 1e-5, every parameter at
  rtol 1e-5 / atol 1e-6.
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

from repro.config.base import get_arch as jget_arch
from repro.models import api as japi
from repro_torch.common.util import tree_flatten_with_path, tree_unflatten
from repro_torch.config.base import get_arch
from repro_torch.distributed.autoshard import activation_sharding, axis_size
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import api
from repro_torch.models import transformer as T

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
RANKS = 4
TIMEOUT_S = 240

#: one rank of the sharded run: gemma2-9b SMOKE's parameters (seed 0) and
#: 4 x 32 tokens (seed 1), placed by the sharding rules on a (2, 2) mesh;
#: loss and gradients, gathered whole, saved by rank 0
WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.common.util import tree_flatten_with_path, tree_unflatten
from repro_torch.config.base import get_arch
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
arch = get_arch("gemma2-9b")
cfg, shape = arch.smoke_config, arch.shape("train_4k")
params = api.model_api(cfg).init(torch.Generator().manual_seed(0), "cpu")
tokens = torch.from_numpy(np.random.default_rng(1).integers(
    0, cfg.vocab_size, size=(4, 32)).astype(np.int32))
with make_host_mesh(model=2, device="cpu") as mesh:
    paths, treedef = tree_flatten_with_path(params)
    specs = shd.spec_leaves(shd.param_specs(cfg, params, mesh))
    placed = tree_unflatten(treedef, [
        distribute_tensor(t, mesh, shd.to_placements(s, mesh))
        for (_, t), s in zip(paths, specs, strict=True)])
    bspec = shd.batch_specs(cfg, shape, {"tokens": (tuple(tokens.shape),
                                                    tokens.dtype)}, mesh)
    batch = {"tokens": distribute_tensor(
        tokens, mesh, shd.to_placements(bspec["tokens"], mesh))}
    with activation_sharding(mesh), implicit_replication():
        loss, _, grads = api.value_and_grad(api.model_api(cfg).loss, placed,
                                            batch)
    full = {"/".join(p): g.full_tensor().numpy()
            for p, g in tree_flatten_with_path(grads)[0]}
    full["__loss__"] = np.asarray(loss.full_tensor())
    sharded = sum(any(not p.is_replicate() for p in g.placements)
                  for _, g in tree_flatten_with_path(grads)[0])
if rank == 0:
    np.savez(out, __sharded__=sharded, **full)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_loss_and_gradients_equal_the_unsharded(tmp_path):
    out = tmp_path / "grads.npz"
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * RANKS, logs[0][-3000:]
    got = dict(np.load(out))

    cfg = get_arch("gemma2-9b").smoke_config
    params = api.model_api(cfg).init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32))
    loss, _, grads = api.value_and_grad(api.model_api(cfg).loss, params,
                                        {"tokens": tokens})
    np.testing.assert_allclose(got.pop("__loss__"), loss.numpy(), rtol=1e-5)
    assert int(got.pop("__sharded__")) >= 10     # most leaves are sharded
    flat = tree_flatten_with_path(grads)[0]
    assert sorted(got) == sorted("/".join(p) for p, _ in flat)
    for path, g in flat:
        np.testing.assert_allclose(got["/".join(path)], g.numpy(),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg="/".join(path))


#: the reference's ``moe_apply`` under ``activation_sharding`` on a (2, 2)
#: mesh of 4 placeholder CPU devices: G = 2 groups
REFERENCE_MOE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from repro.config.base import get_arch
from repro.distributed.autoshard import activation_sharding, axis_size
from repro.models import api as japi
from repro.models import transformer as JT

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for arch_id in ARCHS:
    for cf in FACTORS:
        cfg = get_arch(arch_id).smoke_config
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        params = japi.model_api(cfg).init(jax.random.key(6))
        p0 = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["mlp"])
        x = np.random.default_rng(7).normal(
            size=(80, cfg.d_model)).astype(np.float32)
        with activation_sharding(mesh):
            assert axis_size("dp") == 2
            y = jax.jit(lambda p, x: JT.moe_apply(p, x, cfg.moe,
                                                  cfg.activation))(
                p0, jnp.asarray(x))
        leaves = {jax.tree_util.keystr(k): np.asarray(v) for k, v
                  in jax.tree_util.tree_flatten_with_path(p0)[0]}
        np.savez(os.path.join(sys.argv[1], f"{arch_id}_{cf}.npz"),
                 __y__=np.asarray(y), __x__=x, **leaves)
"""
MOE_ARCHS = ("granite-moe-3b-a800m", "kimi-k2-1t-a32b")
FACTORS = (1.25, 0.25)


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    """The reference's outputs at G = 2 for every arch and factor, made
    in one process with 4 placeholder devices: {(arch, cf): npz path}."""
    out = tmp_path_factory.mktemp("moe")
    code = f"ARCHS, FACTORS = {MOE_ARCHS!r}, {FACTORS!r}\n" + REFERENCE_MOE
    proc = subprocess.run([sys.executable, "-c", code, str(out)],
                          env={**os.environ, "PYTHONPATH": SRC},
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {(a, cf): out / f"{a}_{cf}.npz" for a in MOE_ARCHS
            for cf in FACTORS}


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", FACTORS)
def test_moe_apply_in_data_groups_equals_the_reference(arch_id,
                                                       capacity_factor,
                                                       moe_reference):
    ref = dict(np.load(moe_reference[arch_id, capacity_factor]))
    want, x = ref.pop("__y__"), torch.from_numpy(ref.pop("__x__"))

    cfg = get_arch(arch_id).smoke_config
    moe = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    like = T._layer(T.init_lm(cfg, None, "meta")["blocks"], 0)["mlp"]
    paths, treedef = tree_flatten_with_path(like)
    p0 = tree_unflatten(treedef, [
        torch.from_numpy(ref["".join(f"['{k}']" for k in path)])
        for path, _ in paths])
    with fake_mesh((2, 2), ("data", "model")) as mesh, \
            activation_sharding(mesh):
        assert axis_size("dp") == 2
        got = T.moe_apply(p0, x, moe, cfg.activation)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    g1 = T.moe_apply(p0, x, moe, cfg.activation)          # G = 1
    if capacity_factor < 1:
        assert not np.allclose(g1.numpy(), want, rtol=1e-5, atol=1e-6)


def test_adafactor_step_with_remat_matches_reference():
    """One step of ``make_train_step`` with Adafactor (the full CONFIG's
    optimizer) and remat on, gemma2-9b SMOKE otherwise, from the same
    parameters on the same batch."""
    over = dict(remat=True, optimizer="adafactor")
    jcfg = dataclasses.replace(jget_arch("gemma2-9b").smoke_config, **over)
    cfg = dataclasses.replace(get_arch("gemma2-9b").smoke_config, **over)
    jparams = jax.jit(japi.model_api(jcfg).init)(jax.random.key(8))
    tokens = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    jstep, jopt = japi.make_train_step(jcfg)
    jp2, jst, jm = jax.jit(jstep)(jparams, jopt.init(jparams),
                                  {"tokens": jnp.asarray(tokens)})
    npp = jax.tree_util.tree_map(np.asarray, jparams)
    params = T.params_from_numpy(cfg, npp, "cpu")
    step, opt = api.make_train_step(cfg)
    assert opt.name == "adafactor"
    p2, st, m = step(params, opt.init(params),
                     {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    want = [np.asarray(v) for _, v in
            jax.tree_util.tree_flatten_with_path(jp2)[0]]
    flat = tree_flatten_with_path(p2)[0]
    assert len(flat) == len(want)
    for (path, a), w in zip(flat, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=1e-6,
                                   err_msg="/".join(path))
    assert int(st["count"]) == 1 == int(jst["count"])
