"""Activation sharding hints (port of ``repro.distributed.autoshard``).

Model code names the layout of an activation by *role*, one per dim:

  dp  -> ("pod", "data") (whichever the mesh has)   batch-ish dims
  tp  -> "model"                                     tensor-parallel dims
  sp  -> "model" when sequence parallel, else none   the residual stream
  all -> every axis of the mesh

Outside an ``activation_sharding(mesh)`` context ``constrain`` returns the
very object it was given and ``axis_size`` is 1, so the models stay
mesh-agnostic and compute exactly what they compute without hints. Inside
one, ``constrain`` redistributes a ``DTensor`` to the placements the roles
name (the counterpart of ``jax.lax.with_sharding_constraint``); a plain
tensor passes through, since it is replicated where it meets a DTensor
(``implicit_replication``). A dim that its axes do not divide is left
unconstrained, as the reference leaves it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional

import torch

_POLICY: Optional["Policy"] = None


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's order, of a torch ``DeviceMesh``
    (its ``mesh_dim_names`` and ``shape``, or the ``axis_sizes`` of a mesh
    that merges axes: :func:`mesh_groups`) or of a shape-only stand-in
    with ``axis_names`` and a ``shape`` mapping (the sharding rules need
    no devices)."""
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is not None:
        return dict(sizes)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def mesh_groups(mesh) -> tuple[tuple[str, ...], ...]:
    """For each dim of the mesh, the axis names that lie on it, major
    first: one name a dim, but where the mesh merges axes that every spec
    names together (``axis_groups``: the multi-pod mesh lays pod and data
    on one dim)."""
    groups = getattr(mesh, "axis_groups", None)
    if groups is not None:
        return tuple(groups)
    return tuple((a,) for a in mesh_axes(mesh))


@dataclasses.dataclass(frozen=True)
class Policy:
    mesh: Any
    seq_parallel: bool = True

    def resolve(self, role):
        """``(axes, size)`` of a role: the axis name (or tuple of names, in
        the mesh's order) it shards over and their product."""
        sizes = mesh_axes(self.mesh)
        if role is None:
            return None, 1
        if role == "dp":
            axes = tuple(a for a in sizes if a in ("pod", "data"))
            size = math.prod(sizes[a] for a in axes)
            return (axes if len(axes) > 1 else axes[0]), size
        if role == "tp":
            return "model", sizes["model"]
        if role == "sp":
            # the sequence-parallel residual stream (Megatron-SP): the
            # per-layer carry shards its sequence dim over the model axis
            if self.seq_parallel:
                return "model", sizes["model"]
            return None, 1
        if role == "all":
            axes = tuple(sizes)
            return axes, math.prod(sizes.values())
        raise ValueError(role)


def sharded() -> bool:
    """Whether an ``activation_sharding`` policy is active."""
    return _POLICY is not None


def axis_size(role: str) -> int:
    """Size of a role's axis group under the active policy (1 if none)."""
    if _POLICY is None:
        return 1
    return _POLICY.resolve(role)[1]


@contextlib.contextmanager
def activation_sharding(mesh, seq_parallel: bool = True):
    global _POLICY
    prev = _POLICY
    _POLICY = Policy(mesh, seq_parallel=seq_parallel)
    try:
        yield
    finally:
        _POLICY = prev


def constrain_like(x: torch.Tensor, ref: torch.Tensor):
    """``x`` laid out as ``ref`` is: ``x`` itself outside a policy or
    where either is not a DTensor; else ``x`` redistributed to ``ref``'s
    placements (a gradient reduced to its parameter's layout, where
    GSPMD reduce-scatters it by propagation)."""
    if _POLICY is None:
        return x
    from torch.distributed.tensor import DTensor

    if not (isinstance(x, DTensor) and isinstance(ref, DTensor)):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def constrain(x: torch.Tensor, *roles):
    """Lay ``x`` out by role names: ``x`` itself when no policy is active
    or ``x`` is not a DTensor; else ``x`` redistributed over its mesh to
    the placements of the roles (a dim its axes do not divide is left
    replicated)."""
    if _POLICY is None:
        return x
    if x.ndim != len(roles):
        raise ValueError(f"{len(roles)} roles for a tensor of shape "
                         f"{tuple(x.shape)}")
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import Spec, to_placements

    if not isinstance(x, DTensor):
        return x
    spec = []
    for dim, role in zip(x.shape, roles):
        axes, size = _POLICY.resolve(role)
        if role is not None and dim % size != 0:
            axes = None   # skip non-divisible constraints (e.g. 24 heads/16)
        spec.append(axes)
    # redistributed even where it is laid out so already: the backward
    # then lays the gradient out as x was, as the reference's constraint
    # constrains the cotangent too
    return x.redistribute(x.device_mesh,
                          to_placements(Spec(*spec), x.device_mesh))
