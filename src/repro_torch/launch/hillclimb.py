"""Hillclimb variant runner (port of ``repro.launch.hillclimb``): runs the
optimized variants of two chosen cells next to their baselines on the
16x16 production mesh (``launch/mesh.py``'s ``fake`` group of 256 ranks)
and prints their roofline deltas.

  gnn:       meshgraphnet/ogb_products baseline (edge-parallel, node
             states over the data axis, each block's aggregate reduced)
             vs halo-partitioned owner-computes (``models/gnn_partitioned``)
  retrieval: wide-deep/retrieval_cand baseline f32 scoring vs scoring from
             int8-stored candidates (+ the top-k of the gathered scores)

Each variant's step runs once on ``meta`` ``DTensor``s under the op
counter (``dryrun_lib.measure``, as a cell runs); each prints the
reference's line and returns its record.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --which gnn,retrieval
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch
import torch.nn.functional as F

CHIPS = 256
HALO_PER_PAIR = 16
#: the retrieval variant's k
TOP_K = 100


def _line(rec: dict) -> str:
    """The reference's line of a record: the three terms, useful FLOPs,
    a chip's temporary bytes and collective bytes (GiB)."""
    name = rec["cell"]
    if rec["status"] != "ok":
        return (f"{name:42s} {rec['status']} {rec.get('op')}: "
                f"{rec.get('error', '')[:300]}")
    r = rec["roofline"]
    temp = rec["memory_analysis"]["temp_size_in_bytes"]
    return (f"{name:42s} tC={r['t_compute_s']:8.4f} "
            f"tM={r['t_memory_s']:8.4f} tN={r['t_collective_s']:8.4f} "
            f"useful={r['useful_flops_fraction']:6.3f} "
            f"mem={temp / 2**30:7.2f}GiB "
            f"coll/chip={r['coll_bytes_per_chip'] / 2**30:.2f}GiB")


def _report(rec: dict, name: str) -> dict:
    rec = {**rec, "cell": name}
    print(_line(rec), flush=True)
    return rec


def _replicated(tree, mesh):
    """Every leaf of a tree of meta tensors as a replicated ``DTensor``."""
    from repro_torch.common.util import (tree_flatten_with_path,
                                         tree_unflatten)
    from repro_torch.distributed.sharding import Spec
    from repro_torch.launch.dryrun_lib import _place

    paths, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, [
        _place(t.shape, t.dtype, Spec(*([None] * t.ndim)), mesh)
        for _, t in paths])


def run_gnn() -> list[dict]:
    """meshgraphnet/ogb_products on 16x16: the baseline cell, then the
    halo-partitioned train step (``CHIPS`` partitions, ``HALO_PER_PAIR``
    halo slots a pair, the config's optimizer). Returns both records."""
    from repro_torch.config.base import get_arch
    from repro_torch.distributed.autoshard import constrain_like
    from repro_torch.distributed.sharding import Spec
    from repro_torch.common.util import (tree_flatten_with_path,
                                         tree_leaves, tree_unflatten)
    from repro_torch.launch.dryrun_lib import (_place, measure, model_flops,
                                               run_cell)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import api as mapi
    from repro_torch.models.gnn_partitioned import (partitioned_input_specs,
                                                    partitioned_loss)
    from repro_torch.training.optimizer import make_optimizer

    arch = get_arch("meshgraphnet")
    shape = arch.shape("ogb_products")
    mf = model_flops(arch.config, shape)
    with make_production_mesh(multi_pod=False) as mesh:
        base = _report(run_cell(arch.arch_id, shape.name, mesh,
                                "single_pod_16x16"),
                       "gnn/ogb_products BASELINE")

        # --- halo-partitioned owner-computes variant ---------------------
        cfg = mapi.resolve_config(arch.config, shape)
        specs = partitioned_input_specs(cfg, shape, CHIPS,
                                        halo_per_pair=HALO_PER_PAIR)
        loss_fn = partitioned_loss(cfg, mesh)
        opt = make_optimizer(cfg.optimizer)
        axes = tuple(mesh.mesh_dim_names)

        def train_step(params, opt_state, batch):
            _, metrics, grads = mapi.value_and_grad(loss_fn, params, batch)
            flat, treedef = tree_flatten_with_path(grads)
            grads = tree_unflatten(treedef, [
                constrain_like(g, p)
                for (_, g), p in zip(flat, tree_leaves(params))])
            params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, metrics

        def build():
            params_spec = mapi.abstract_params(cfg)
            opt_spec = mapi.abstract_opt_state(cfg, params_spec)
            batch = {k: _place(s, dt, Spec(axes, *([None] * (len(s) - 1))),
                               mesh) for k, (s, dt) in specs.items()}
            return train_step, (_replicated(params_spec, mesh),
                                _replicated(opt_spec, mesh), batch)

        halo = _report(measure("gnn/ogb_products HALO-PARTITIONED", build,
                                mesh, mf),
                       "gnn/ogb_products HALO-PARTITIONED")
    return [base, halo]


def retrieve_int8(codes: torch.Tensor, scale: torch.Tensor, q: torch.Tensor,
                  cand_ids: torch.Tensor, k: int = TOP_K):
    """The int8-stored retrieval step: scores q . (codes * scale), the rows
    and q rounded to bf16 and their products summed in f32 (bf16 values
    multiply exactly in f32), then the k best candidates by a stable
    descending sort (ties to the lower position, as ``lax.top_k``), their
    ids looked up in ``cand_ids``. -> (f32[B, k], ids [B, k])."""
    bf = torch.bfloat16
    x = codes.to(bf) * scale[:, None].to(bf)
    scores = q.to(bf).to(torch.float32) @ x.to(torch.float32).T
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    # a lookup into the id column: sharded, each chip takes the winners it
    # holds and the rest are summed in (XLA's gather of the k ids)
    return vals, F.embedding(idx, cand_ids[:, None])[..., 0]


def run_retrieval() -> list[dict]:
    """wide-deep/retrieval_cand on 16x16: the baseline cell, then the
    int8-stored variant (codes, scales and candidate ids sharded over
    ``model``, the query replicated). Returns both records."""
    from repro_torch.config.base import get_arch
    from repro_torch.distributed.sharding import Spec
    from repro_torch.launch.dryrun_lib import _place, measure, run_cell
    from repro_torch.launch.mesh import make_production_mesh

    arch = get_arch("wide-deep")
    shape = arch.shape("retrieval_cand")
    with make_production_mesh(multi_pod=False) as mesh:
        base = _report(run_cell(arch.arch_id, shape.name, mesh,
                                "single_pod_16x16"),
                       "recsys/retrieval_cand BASELINE")

        # --- int8-stored candidates + top-k of the gathered scores -------
        d = arch.config.embed_dim
        n_cand = shape["n_candidates"]

        def build():
            args = (_place((n_cand, d), torch.int8, Spec("model", None),
                           mesh),
                    _place((n_cand,), torch.float32, Spec("model"), mesh),
                    _place((1, d), torch.float32, Spec(None, None), mesh),
                    _place((n_cand,), torch.int32, Spec("model"), mesh))
            return retrieve_int8, args

        opt = _report(measure("recsys/retrieval_cand INT8-STORED", build,
                               mesh, 2.0 * n_cand * d),
                      "recsys/retrieval_cand INT8-STORED")
    return [base, opt]


VARIANTS = {"gnn": run_gnn, "retrieval": run_retrieval}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", default="gnn,retrieval")
    ap.add_argument("--out", default=None,
                    help="also write every record to this JSON file")
    args = ap.parse_args(argv)
    recs = []
    for w in args.which.split(","):
        t0 = time.perf_counter()
        recs += VARIANTS[w]()
        print(f"[{w} done in {time.perf_counter() - t0:.0f}s]", flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(recs, indent=2))
    return 1 if any(r["status"] != "ok" for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
