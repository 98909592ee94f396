"""The port's activation hints (``repro_torch.distributed.autoshard``) and
meshes (``repro_torch.launch.mesh``) against the JAX package's.

``Policy.resolve`` and ``axis_size`` give the reference's axes and sizes
for every role on both production meshes (shape-only, as the reference's
own sharding test takes them) and on a mesh without a pod axis.
``constrain`` returns the very object it was given outside a policy, and
a plain tensor inside one; on a ``DTensor`` it redistributes to the
roles' placements, skipping a dim its axes do not divide, and lays the
gradient out as the input was. The mesh contexts create and destroy the
default process group (the one-process device grid of
``core.distributed`` works after them), and only ``launch/mesh.py``
imports PyTorch's testing modules.
"""

import ast
import pathlib

import pytest
import torch

from repro.distributed import autoshard as jauto
from repro_torch.common.util import tree_leaves
from repro_torch.distributed import autoshard as auto
from repro_torch.distributed.sharding import Spec, to_placements
from repro_torch.launch.mesh import (fake_mesh, make_host_mesh,
                                     make_production_mesh)

REPO = pathlib.Path(__file__).resolve().parent.parent
ROLES = [None, "dp", "tp", "sp", "all"]


class FakeMesh:
    """Shape-only stand-in for a mesh: axis names and sizes."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 2}]


@pytest.mark.parametrize("seq_parallel", [True, False])
@pytest.mark.parametrize("shape", MESHES, ids=["16x16", "2x16x16", "4x2"])
def test_resolve_and_axis_size_equal_the_reference(shape, seq_parallel):
    mesh = FakeMesh(shape)
    jpol = jauto.Policy(mesh, seq_parallel=seq_parallel)
    pol = auto.Policy(mesh, seq_parallel=seq_parallel)
    for role in ROLES:
        assert pol.resolve(role) == jpol.resolve(role), role
    with pytest.raises(ValueError):
        pol.resolve("xp")
    with jauto.activation_sharding(mesh, seq_parallel), \
            auto.activation_sharding(mesh, seq_parallel):
        for role in ROLES[1:]:
            assert auto.axis_size(role) == jauto.axis_size(role), role
    assert auto.axis_size("dp") == 1 == jauto.axis_size("dp")


def test_resolve_reads_a_device_mesh_as_its_shape():
    with make_production_mesh(multi_pod=True) as mesh:
        pol = auto.Policy(mesh)
        jpol = jauto.Policy(FakeMesh(MESHES[1]))
        for role in ROLES:
            assert pol.resolve(role) == jpol.resolve(role), role
        assert auto.mesh_axes(mesh) == MESHES[1]


def test_constrain_outside_a_policy_returns_its_input():
    x = torch.randn(4, 6)
    assert auto.constrain(x, "dp", "tp") is x
    assert auto.constrain(x, "dp") is x        # no policy: not even checked


def test_constrain_inside_a_policy():
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    with fake_mesh((2, 4), ("data", "model")) as mesh, \
            auto.activation_sharding(mesh):
        plain = torch.randn(4, 8)
        assert auto.constrain(plain, "dp", "tp") is plain
        with pytest.raises(ValueError):
            auto.constrain(plain, "dp")
        x = DTensor.from_local(torch.empty(4, 6, device="meta"), mesh,
                               [Replicate(), Replicate()], run_check=False)
        y = auto.constrain(x, "dp", "tp")          # 6 % 4: dim 1 skipped
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert tuple(y.to_local().shape) == (2, 6)
        z = auto.constrain(y, None, None)
        assert tuple(z.placements) == (Replicate(), Replicate())
        w = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh,
                               [Partial(), Replicate()], run_check=False)
        assert tuple(auto.constrain(w, "dp", "tp").placements) == (
            Shard(0), Shard(1))


def test_constrain_lays_the_gradient_out_as_the_input_was():
    """The backward of a hint that changed nothing in the forward still
    redistributes the gradient to the input's layout (JAX's constraint
    constrains the cotangent too)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_mesh((2, 2), ("data", "model")) as mesh, \
            auto.activation_sharding(mesh):
        x = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               ).requires_grad_(True)
        y = auto.constrain(x, "dp", None)
        g = DTensor.from_local(torch.empty(4, 4, device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        (gx,) = torch.autograd.grad(y, x, g)
        assert tuple(gx.placements) == (Shard(0), Replicate())


def test_fake_meshes_destroy_their_process_group():
    import torch.distributed as dist

    from repro_torch.core.distributed import make_mesh

    for multi_pod, shape in [(False, (16, 16)), (True, (32, 16))]:
        with make_production_mesh(multi_pod=multi_pod) as mesh:
            assert tuple(mesh.shape) == shape     # pod x data on one dim
            assert dist.get_world_size() == 256 * (1 + multi_pod)
            with pytest.raises(RuntimeError):
                with fake_mesh((1, 1), ("data", "model")):
                    pass
        assert not dist.is_initialized()
    grid = make_mesh((1, 2), device="cpu")     # the one-process grid
    assert grid.shape == {"data": 1, "model": 2}
    assert auto.mesh_axes(grid) == grid.shape


def test_host_mesh_on_the_cpu():
    import torch.distributed as dist

    with make_host_mesh(device="cpu") as mesh:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.device_type == "cpu"
        assert to_placements(Spec("data", "model"), mesh)
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with make_host_mesh(model=2, device="cpu"):
            pass
    assert not dist.is_initialized()


def test_only_the_mesh_module_imports_torch_testing():
    port = REPO / "src" / "repro_torch"
    users = []
    for py in sorted(port.rglob("*.py")):
        for node in ast.walk(ast.parse(py.read_text(encoding="utf-8"))):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            if any(n.startswith("torch.testing") for n in names):
                users.append(str(py.relative_to(port)))
    assert users == ["launch/mesh.py"]


@pytest.mark.parametrize("arch_id", ["gemma2-9b", "granite-moe-3b-a800m"])
def test_hints_change_no_number_without_a_policy(arch_id, monkeypatch):
    """The models with their hints and with every hint taken out (each
    ``constrain`` the identity, each ``axis_size`` 1): the same loss and
    gradients, bit for bit, as the models computed before they had
    hints."""
    import numpy as np

    from repro_torch.config.base import get_arch
    from repro_torch.models import api
    from repro_torch.models import layers, transformer

    cfg = get_arch(arch_id).smoke_config
    params = api.model_api(cfg).init(torch.Generator().manual_seed(3), "cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(2, 24)).astype(np.int32))}
    loss_fn = api.model_api(cfg).loss
    loss, _, grads = api.value_and_grad(loss_fn, params, batch)
    for mod in (transformer, layers):
        monkeypatch.setattr(mod, "constrain", lambda x, *roles: x)
        monkeypatch.setattr(mod, "axis_size", lambda role: 1)
    bare, _, bare_grads = api.value_and_grad(loss_fn, params, batch)
    assert torch.equal(loss, bare)
    for g, b in zip(tree_leaves(grads), tree_leaves(bare_grads)):
        assert torch.equal(g, b)
