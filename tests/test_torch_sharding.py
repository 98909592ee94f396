"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's (``repro.distributed.sharding``).

For every arch and every shape it does not skip, on both production
meshes (16x16 and 2x16x16, shape-only as ``tests/test_sharding_specs.py``
takes them: the rules read only axis names and sizes), every parameter,
optimizer-state and batch leaf gets the reference's ``PartitionSpec``,
element for element. ``to_placements`` turns each parameter spec into the
DTensor placements whose local shards (``DTensor``'s own shard-shape rule,
on a ``fake`` 16x16 or 2x16x16 process group) are the global shape over
the axes ``sanitize`` left on each dim.
"""

import math

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.config.base import get_arch as jget_arch
from repro.config.base import list_archs as jlist_archs
from repro.distributed import sharding as jshd
from repro.models import api as japi
from repro_torch.common.util import tree_flatten_with_path
from repro_torch.config.base import get_arch, list_archs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.autoshard import mesh_axes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api


class FakeMesh:
    """Shape-only stand-in (sharding rules never touch devices)."""

    def __init__(self, multi_pod: bool):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})
        self.axis_names = tuple(self.shape)


def _ref_leaves(tree):
    """(path, spec elements) of a reference spec tree, in leaf order."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jshd._path_str(path), tuple(spec)) for path, spec in flat]


def _port_leaves(spec_tree):
    return [tuple(s) for s in shd.spec_leaves(spec_tree)]


def _assert_equal(ref, got, what):
    assert len(ref) == len(got), (what, len(ref), len(got))
    for (path, want), spec in zip(ref, got):
        assert spec == want, f"{what} {path}: {spec} != {want}"


def test_arch_registries_agree():
    assert sorted(list_archs()) == sorted(jlist_archs())


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch_id", sorted(jlist_archs()))
def test_specs_equal_the_reference(arch_id, multi_pod):
    mesh = FakeMesh(multi_pod)
    jarch, arch = jget_arch(arch_id), get_arch(arch_id)
    n_cells = 0
    for jshape, shape in zip(jarch.shapes, arch.shapes):
        assert jshape.name == shape.name
        if shape.skip_reason:
            continue
        n_cells += 1
        jcfg = japi.resolve_config(jarch.config, jshape)
        cfg = api.resolve_config(arch.config, shape)
        where = f"{arch_id}/{shape.name}"

        jparams = japi.abstract_params(jcfg)
        params = api.abstract_params(cfg)
        jp = jshd.param_specs(jcfg, jparams, mesh)
        p = shd.param_specs(cfg, params, mesh)
        _assert_equal(_ref_leaves(jp), _port_leaves(p), f"{where} params")
        assert ([("/".join(k)) for k, _ in tree_flatten_with_path(params)[0]]
                == [path for path, _ in _ref_leaves(jp)])

        jo = jshd.opt_specs(jp, japi.abstract_opt_state(jcfg, jparams))
        o = shd.opt_specs(p, api.abstract_opt_state(cfg, params))
        _assert_equal(_ref_leaves(jo), _port_leaves(o), f"{where} opt")

        jb = jshd.batch_specs(jcfg, jshape, japi.input_specs(jcfg, jshape),
                              mesh)
        b = shd.batch_specs(cfg, shape, api.input_specs(cfg, shape), mesh)
        _assert_equal(_ref_leaves(jb), _port_leaves(b), f"{where} batch")
    assert n_cells


def test_spec_stores_a_one_name_tuple_as_the_name():
    assert tuple(shd.Spec(("data",), None)) == tuple(P(("data",), None))
    assert tuple(shd.Spec(("pod", "data"), "model")) == \
        tuple(P(("pod", "data"), "model"))
    assert shd.Spec() == () == tuple(P())


def test_sanitize_drops_what_the_axes_do_not_divide():
    mesh = FakeMesh(True)
    spec = shd.Spec("model", ("pod", "data"))
    for shape in [(49155, 1536), (4096, 64), (48, 32)]:
        assert tuple(shd.sanitize(spec, shape, mesh)) == tuple(
            jshd.sanitize(P("model", ("pod", "data")), shape, mesh))


def test_to_placements_orders_the_axes_as_jax_does():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh(True)
    assert shd.to_placements(shd.Spec(None, ("pod", "data"), "model"),
                             mesh) == (Shard(1), Shard(1), Shard(2))
    assert shd.to_placements(shd.Spec("model", None), mesh) == (
        Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError):
        shd.to_placements(shd.Spec(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        shd.to_placements(shd.Spec("model", "model"), mesh)

    class Merged(FakeMesh):           # pod and data laid on one mesh dim
        axis_groups = (("pod", "data"), ("model",))

    merged = Merged(True)
    assert shd.to_placements(shd.Spec(None, ("pod", "data"), "model"),
                             merged) == (Shard(1), Shard(2))
    assert shd.to_placements(shd.Spec(("pod", "data", "model")),
                             merged) == (Shard(0), Shard(0))
    with pytest.raises(ValueError):
        shd.to_placements(shd.Spec("data"), merged)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_placements_give_the_local_shards_sanitize_implies(multi_pod):
    """Every parameter and optimizer leaf of every arch's full config: the
    local shard DTensor computes for the placements equals the global
    shape divided, dim by dim, by the axes its sanitized spec keeps."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    n = 0
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        sizes = mesh_axes(mesh)
        for arch_id in sorted(list_archs()):
            cfg = get_arch(arch_id).config
            params = api.abstract_params(cfg)
            pspecs = shd.param_specs(cfg, params, mesh)
            opt = api.abstract_opt_state(cfg, params)
            trees = [(params, pspecs), (opt, shd.opt_specs(pspecs, opt))]
            for tree, specs in trees:
                leaves = [t for _, t in tree_flatten_with_path(tree)[0]]
                for t, spec in zip(leaves, shd.spec_leaves(specs),
                                   strict=True):
                    want = list(t.shape)
                    for d, axes in enumerate(spec):
                        if axes is not None:
                            group = (axes if isinstance(axes, tuple)
                                     else (axes,))
                            want[d] //= math.prod(sizes[a] for a in group)
                    local, _ = compute_local_shape_and_global_offset(
                        t.shape, mesh, shd.to_placements(spec, mesh))
                    assert list(local) == want, (arch_id, spec, t.shape)
                    n += 1
    assert n > 100


def test_a_size_one_axis_shards_nothing():
    from torch.distributed.tensor import Replicate, Shard

    class OneByOne:
        shape = {"data": 1, "model": 4}
        axis_names = ("data", "model")

    assert shd.to_placements(shd.Spec("data", "model"), OneByOne()) == (
        Replicate(), Shard(1))
