"""Dry-run implementation (port of ``repro.launch.dryrun_lib``).

One cell = (architecture x input shape x mesh). For each cell the step
function the shape kind dictates gets its parameters, optimizer state and
inputs as ``DTensor``s on the mesh, placed by ``distributed.sharding``,
each a ``meta`` tensor that holds a chip's local shard (shapes, no data).
The step runs once under the model's activation hints, ``DTensor``'s
implicit replication of plain tensors, ``CommDebugMode`` and the op
counter (:mod:`repro_torch.launch.op_analysis`): success proves the
distribution config is coherent; the counts feed the roofline. On meta
tensors every ``ops`` entry takes its plain version (a kernel never sees a
meta tensor), which each record states.
"""

from __future__ import annotations

import dataclasses
import math
import time
import traceback

import torch

from repro_torch.config.base import (ArchDef, GNNConfig, LMConfig,
                                     RecsysConfig, ShapeSpec, get_arch,
                                     list_archs)
from repro_torch.common.util import tree_flatten_with_path, tree_unflatten
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.autoshard import activation_sharding, mesh_axes
from repro_torch.launch import roofline as rl
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import api as mapi
from repro_torch.models.transformer import KVCache

KERNELS_NOTE = ("plain versions: the step ran on meta tensors, so every ops "
                "entry took its plain PyTorch version and no kernel ran")


def gnn_model_flops(cfg: GNNConfig, shape: ShapeSpec) -> float:
    n, e = mapi._gnn_block_sizes(shape)
    dh = cfg.d_hidden
    mlp2 = lambda din: din * dh + dh * dh  # 2-layer MLP MACs per row
    per_layer = e * mlp2(3 * dh) + n * mlp2(2 * dh)
    enc = n * mlp2(shape.get("d_feat", cfg.in_node_dim)) + e * mlp2(cfg.in_edge_dim)
    dec = n * mlp2(dh)
    macs = cfg.n_layers * per_layer + enc + dec
    return 6.0 * macs  # fwd+bwd ~= 3x fwd, 2 flops/MAC


def recsys_model_flops(cfg: RecsysConfig, shape: ShapeSpec) -> float:
    b = shape.get("batch", 1)
    dims = [cfg.n_sparse * cfg.embed_dim + cfg.n_dense] + list(cfg.mlp_dims) + [1]
    if cfg.model == "dien":
        dims[0] += cfg.gru_dim + cfg.embed_dim
        gru = cfg.seq_len * 2 * 3 * (cfg.embed_dim + cfg.gru_dim) * cfg.gru_dim
    else:
        gru = 0
    if cfg.model == "bst":
        dims[0] += (cfg.seq_len + 1) * cfg.embed_dim
    macs = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1)) + gru
    mult = 6.0 if shape.kind == "recsys_train" else 2.0
    flops = mult * b * macs
    if shape.kind == "recsys_retrieval":
        flops += 2.0 * b * shape["n_candidates"] * cfg.embed_dim
    return flops


def model_flops(cfg, shape: ShapeSpec) -> float:
    cfg = mapi.resolve_config(cfg, shape)
    if isinstance(cfg, LMConfig):
        return rl.lm_model_flops(cfg, shape)
    if isinstance(cfg, GNNConfig):
        return gnn_model_flops(cfg, shape)
    return recsys_model_flops(cfg, shape)


def batch_key(shape: ShapeSpec) -> str:
    """The name of a shape's batch: an LM's ``global_batch``, else
    ``batch``."""
    return "global_batch" if "global_batch" in shape.params else "batch"


# ---------------------------------------------------------------------------


def _place(shape, dtype, spec: shd.Spec, mesh):
    """A DTensor of global ``shape`` placed by ``spec`` on ``mesh``, its
    local shard a meta tensor."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    sizes = mesh_axes(mesh)
    local = list(shape)
    for d, axes in enumerate(spec):
        if axes is not None:
            group = axes if isinstance(axes, tuple) else (axes,)
            local[d] //= math.prod(sizes[a] for a in group)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh,
        shd.to_placements(spec, mesh), run_check=False,
        shape=torch.Size(shape), stride=stride)


def _place_tree(tree, spec_tree, mesh):
    """Every leaf of a tree of tensors (meta, global shapes) placed by the
    spec tree that mirrors it."""
    paths, treedef = tree_flatten_with_path(tree)
    specs = shd.spec_leaves(spec_tree)
    return tree_unflatten(treedef, [
        _place(t.shape, t.dtype, s, mesh)
        for (_, t), s in zip(paths, specs, strict=True)])


def _place_inputs(specs: dict, spec_tree: dict, mesh) -> dict:
    """``input_specs``' ``(shape, dtype)`` pairs (a decode cache a
    ``KVCache`` of them) placed by their specs."""
    out = {}
    for name, s in specs.items():
        sp = spec_tree[name]
        if isinstance(s, KVCache):
            out[name] = KVCache(*(_place(*pair, spec, mesh)
                                  for pair, spec in zip(s, sp)))
        else:
            out[name] = _place(*s, sp, mesh)
    return out


def build_cell(arch: ArchDef, shape: ShapeSpec, mesh, smoke: bool = False):
    """Returns (step_fn, args: tuple) with every argument placed on the
    mesh, ready to run (the arch's smoke config where ``smoke``)."""
    cfg = mapi.resolve_config(arch.smoke_config if smoke else arch.config,
                              shape)
    specs = mapi.input_specs(cfg, shape)
    params_spec = mapi.abstract_params(cfg)
    p_specs = shd.param_specs(cfg, params_spec, mesh)
    params = _place_tree(params_spec, p_specs, mesh)
    batch = _place_inputs(specs, shd.batch_specs(cfg, shape, specs, mesh),
                          mesh)

    if shape.kind in ("train", "graph_full", "graph_minibatch",
                      "graph_batched", "recsys_train"):
        step, _ = mapi.make_train_step(cfg)
        opt_spec = mapi.abstract_opt_state(cfg, params_spec)
        opt = _place_tree(opt_spec, shd.opt_specs(p_specs, opt_spec), mesh)
        return step, (params, opt, batch)

    if shape.kind == "prefill":
        return mapi.make_prefill_step(cfg), (params, batch["tokens"])

    if shape.kind == "decode":
        return (mapi.make_decode_step(cfg),
                (params, batch["cache"], batch["token"]))

    if shape.kind == "recsys_serve":
        return mapi.make_serve_step(cfg), (params, batch)

    if shape.kind == "recsys_retrieval":
        return mapi.make_retrieval_step(cfg), (params, batch)

    raise ValueError(shape.kind)


def run_cell(arch_id: str, shape_name: str, mesh, mesh_name: str,
             overrides: dict | None = None, smoke: bool = False) -> dict:
    """One cell's record: ``status`` ``ok`` (with the memory and roofline
    figures), ``skip`` (a documented skip) or ``fail`` (the error and the
    operator that raised: dry-run failures are findings). ``overrides``
    replaces some of the shape's sizes (its batch, its ``seq_len``);
    ``smoke`` runs the arch's smoke config."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.distributed.tensor.debug import CommDebugMode

    arch = get_arch(arch_id)
    shape = arch.shape(shape_name)
    if overrides:
        shape = dataclasses.replace(shape,
                                    params={**shape.params, **overrides})
    cell = f"{arch_id}{'-smoke' if smoke else ''}/{shape_name}/{mesh_name}"
    if shape.skip_reason:
        return {"cell": cell, "status": "skip", "reason": shape.skip_reason}
    t0 = time.perf_counter()
    counter = OpCounter()
    try:
        with activation_sharding(mesh):
            fn, args = build_cell(arch, shape, mesh, smoke)
            t_place = time.perf_counter() - t0
            counter.track(args)
            with implicit_replication(), CommDebugMode() as comm, counter:
                out = fn(*args)
            del out, args
        t_run = time.perf_counter() - t0 - t_place
        cost = counter.cost
        chips = math.prod(mesh_axes(mesh).values())
        cfg = arch.smoke_config if smoke else arch.config
        roof = rl.analyze(cell, cost, chips,
                          model_flops=model_flops(cfg, shape))
        return {
            "cell": cell, "status": "ok",
            "place_s": round(t_place, 2), "run_s": round(t_run, 2),
            "shape": dict(shape.params),
            "memory_analysis": {
                "argument_size_in_bytes": int(cost.arg_bytes),
                "temp_size_in_bytes": int(cost.peak_bytes - cost.arg_bytes),
                "peak_size_in_bytes": int(cost.peak_bytes)},
            "comm_counts": {str(k): v for k, v in
                            comm.get_comm_counts().items()},
            "kernels": KERNELS_NOTE,
            "roofline": roof.to_dict(),
        }
    except Exception as e:  # noqa: BLE001 -- dry-run failures are findings
        return {"cell": cell, "status": "fail",
                "op": counter.failed_op or counter.last_op,
                "error": f"{type(e).__name__}: {e}"[:2000],
                "trace": traceback.format_exc()[-6000:],
                "elapsed_s": round(time.perf_counter() - t0, 2)}


def all_cells() -> list[tuple[str, str]]:
    out = []
    for aid in list_archs():
        for s in get_arch(aid).shapes:
            out.append((aid, s.name))
    return out
