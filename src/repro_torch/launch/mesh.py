"""Mesh construction (port of ``repro.launch.mesh``).

Each mesh is a context: it creates the default process group on entry and
destroys it on exit, so a dry run leaves nothing behind in the process
that ran it (the one-process device grid of ``core.distributed`` needs no
process group and works as before).

* :func:`make_production_mesh` is the production mesh, (16, 16) = 256
  ranks a pod or (2, 16, 16) = 512 over two pods (pod and data on one
  mesh dim of 32), over PyTorch's ``fake``
  process group: this process is rank 0 of a world whose other ranks do
  not exist and whose collectives move nothing. It is the counterpart of
  the reference's 512 placeholder devices: it lets the dry run place
  tensors by the sharding rules and count a step's work on one chip.
* :func:`make_host_mesh` is a mesh over the real devices: the card by
  default (NCCL), the CPU (gloo) when the caller asks. In a process that
  already belongs to a group (one rank of a multi-process run) it uses
  that group and leaves it open.

The fake process group is a testing module of PyTorch's
(``torch.testing._internal.distributed.fake_pg``); this file is the only
one of the port that imports it.
"""

from __future__ import annotations

import contextlib
import math
import socket
from typing import Iterator


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...],
              axis_names: tuple[str, ...]) -> Iterator:
    """A ``DeviceMesh`` of ``shape`` over a ``fake`` process group of
    prod(shape) ranks, this process rank 0; the group is destroyed on
    exit. Raises if a default process group already exists."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # registers the "fake" backend and provides its store
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; a fake "
                           "mesh needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(axis_names))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False) -> Iterator:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod (a context:
    ``with make_production_mesh() as mesh``). The multi-pod mesh's axes
    are ("pod", "data", "model") of (2, 16, 16), laid on a (32, 16) mesh
    whose first dim merges pod and data (``axis_groups``,
    ``axis_sizes``): every spec names the two together (the dp role), and
    DTensor's sharding search grows steeply with a mesh's dims (a
    2x2x2 mesh cost it over 60x a 2x2 one's time on one cell)."""
    if not multi_pod:
        with fake_mesh((16, 16), ("data", "model")) as mesh:
            yield mesh
        return
    with fake_mesh((32, 16), ("pod_data", "model")) as mesh:
        mesh.axis_groups = (("pod", "data"), ("model",))
        mesh.axis_sizes = {"pod": 2, "data": 16, "model": 16}
        yield mesh


@contextlib.contextmanager
def make_host_mesh(model: int = 1, device: str = "cuda") -> Iterator:
    """A ("data", "model") mesh over the world's ranks, ``model`` of them
    to a model group (a context). Outside a process group it makes one of
    this process alone, on ``device``: ``"cuda"`` (NCCL, the card) by
    default or ``"cpu"`` (gloo), and destroys it on exit."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    own = not dist.is_initialized()
    if own:
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: no CUDA device; pass "
                               "device='cpu' for a CPU mesh")
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    try:
        n = dist.get_world_size()
        if n % model:
            raise ValueError(f"{n} ranks do not split into model groups of "
                             f"{model}")
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        yield init_device_mesh(dev, (n // model, model),
                               mesh_dim_names=("data", "model"))
    finally:
        if own:
            dist.destroy_process_group()
