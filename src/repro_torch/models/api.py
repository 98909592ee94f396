"""Family-dispatch model API (port of ``repro.models.api``) for the GNN
and recsys families.

    api = model_api(arch.config)
    params = api.init(generator, device)          (device "meta": shapes only)
    step, opt = make_train_step(cfg)              (params, opt, batch) -> ...
    serve = make_serve_step(cfg)                  (params, batch) -> logits
    specs = input_specs(cfg, shape)               (shape, dtype) per input
    batch = make_batch(cfg, shape, generator, device)       (recsys)

A step takes and returns plain trees of tensors. The LM family
(``transformer.py``, ``LMConfig``) waits for its slice of the port; its
entry points raise, naming it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.util import (round_up, tree_flatten_with_path,
                                     tree_unflatten)
from repro_torch.config.base import GNNConfig, RecsysConfig, ShapeSpec
from repro_torch.models import gnn, recsys
from repro_torch.training.optimizer import make_optimizer

_LM = "the LM slice of the port (transformer.py, LMConfig)"


class ModelAPI(NamedTuple):
    init: Callable                       # (generator, device) -> params
    loss: Callable                       # (params, batch) -> (loss, metrics)
    family: str


def model_api(cfg) -> ModelAPI:
    if isinstance(cfg, GNNConfig):
        return ModelAPI(init=functools.partial(gnn.init_gnn, cfg),
                        loss=functools.partial(gnn.gnn_loss, cfg),
                        family="gnn")
    if isinstance(cfg, RecsysConfig):
        return ModelAPI(init=functools.partial(recsys.init_recsys, cfg),
                        loss=functools.partial(recsys.recsys_loss, cfg),
                        family="recsys")
    raise TypeError(f"the port has no model API for {type(cfg).__name__} "
                    f"yet: it waits for {_LM}")


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def value_and_grad(loss_fn, params, batch):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch)``: the
    gradient of the loss with respect to every leaf of ``params``, as a
    tree of the same structure. ``params`` is not modified."""
    paths, treedef = tree_flatten_with_path(params)
    leaves = [p.detach().requires_grad_(True) for _, p in paths]
    loss, metrics = loss_fn(tree_unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(treedef, list(grads)))


def make_train_step(cfg, lr: float | None = None):
    """``(train_step, opt)``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, one backward pass and one update."""
    api = model_api(cfg)
    opt = make_optimizer(getattr(cfg, "optimizer", "adamw"), lr)

    def train_step(params, opt_state, batch):
        _, metrics, grads = value_and_grad(api.loss, params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, metrics

    return train_step, opt


def make_eval_step(cfg):
    api = model_api(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        return api.loss(params, batch)[1]

    return eval_step


def make_decode_step(cfg):
    raise NotImplementedError(f"the decode step waits for {_LM}")


def make_prefill_step(cfg):
    raise NotImplementedError(f"the prefill step waits for {_LM}")


def make_serve_step(cfg: RecsysConfig):
    """(params, batch) -> CTR logits f32[B]: ``recsys_forward`` without
    autograd."""
    @torch.no_grad()
    def serve(params, batch):
        return recsys.recsys_forward(cfg, params, batch)
    return serve


def make_retrieval_step(cfg: RecsysConfig, k: int = 100):
    """(params, batch) -> (scores f32[B, k], candidate ids [B, k]) of the k
    best candidates. The top-k is a stable descending sort, so among equal
    scores the lower candidate position comes first, as ``lax.top_k``."""
    def retrieve(params, batch):
        scores = recsys.retrieval_scores(cfg, params, batch)
        vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        return vals, batch["candidates"][idx]
    return retrieve


def _pad512(x: int) -> int:
    """Pad flat node and edge counts to a multiple of 512 (the reference's
    rule, so that every mesh axis divides them; padding is -1-masked in
    the model)."""
    return round_up(x, 512)


def _gnn_block_sizes(shape: ShapeSpec) -> tuple[int, int]:
    """(n_nodes_pad, n_edges_pad) for each GNN shape kind."""
    if shape.kind == "graph_full":
        return _pad512(shape["n_nodes"]), _pad512(shape["n_edges"])
    if shape.kind == "graph_minibatch":
        b = shape["batch_nodes"]
        f1, f2 = shape.get("fanout1", 15), shape.get("fanout2", 10)
        n = b * (1 + f1 + f1 * f2)
        e = b * (f1 + f1 * f2)
        return _pad512(n), _pad512(e)
    if shape.kind == "graph_batched":
        g = shape["batch"]
        return _pad512(g * shape["n_nodes"]), _pad512(g * shape["n_edges"])
    raise ValueError(shape.kind)


def resolve_config(cfg, shape: ShapeSpec):
    """Shape-dependent config fields (a GNN's input feature width comes
    from the dataset, i.e. the shape)."""
    if isinstance(cfg, GNNConfig):
        return dataclasses.replace(
            cfg, in_node_dim=shape.get("d_feat", cfg.in_node_dim))
    return cfg


def input_specs(cfg, shape: ShapeSpec) -> dict[str, tuple[tuple, torch.dtype]]:
    """Step inputs of one (arch, shape) cell as ``(shape, dtype)`` pairs:
    the ``graph_*`` kinds, and ``recsys_train`` / ``recsys_serve`` /
    ``recsys_retrieval``."""
    if isinstance(cfg, GNNConfig):
        n, e = _gnn_block_sizes(shape)
        d_feat = shape.get("d_feat", cfg.in_node_dim)
        return {"node_feats": ((n, d_feat), torch.float32),
                "edge_src": ((e,), torch.int32),
                "edge_dst": ((e,), torch.int32),
                "edge_feats": ((e, cfg.in_edge_dim), torch.float32),
                "node_targets": ((n, cfg.out_dim), torch.float32),
                "node_mask": ((n,), torch.bool)}
    if not isinstance(cfg, RecsysConfig):
        raise TypeError(f"the port has no input specs for "
                        f"{type(cfg).__name__} yet: it waits for {_LM}")
    if shape.kind not in ("recsys_train", "recsys_serve", "recsys_retrieval"):
        raise ValueError(f"a recsys config has no shape kind {shape.kind!r}")
    hot = max(cfg.multi_hot_sizes) if cfg.multi_hot_sizes else 1
    b = shape.get("batch", 1)
    specs = {"dense": ((b, cfg.n_dense), torch.float32),
             "sparse": ((b, cfg.n_sparse, hot), torch.int32)}
    if cfg.seq_len:
        specs["seq"] = ((b, cfg.seq_len), torch.int32)
        specs["target_item"] = ((b,), torch.int32)
    if shape.kind == "recsys_train":
        specs["labels"] = ((b,), torch.float32)
    if shape.kind == "recsys_retrieval":
        specs["candidates"] = ((shape["n_candidates"],), torch.int32)
    return specs


def abstract_params(cfg) -> Any:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    allocation."""
    return model_api(cfg).init(None, "meta")


def abstract_opt_state(cfg, params_spec) -> Any:
    """The optimizer state of ``params_spec`` (on its device: ``meta``
    for :func:`abstract_params`'s tree)."""
    return make_optimizer(getattr(cfg, "optimizer", "adamw")).init(
        params_spec)


def make_batch(cfg: RecsysConfig, shape: ShapeSpec, gen: torch.Generator,
               device) -> dict[str, Any]:
    """A random batch to :func:`input_specs`, drawn from ``gen`` on
    ``device``: dense features from N(0, 1); each field's ids uniform over
    its vocabulary, positions past the field's bag size -1; sequence and
    target items over the item table; labels 0 or 1 with even odds;
    candidates over the table that ``retrieval_scores`` scores (the item
    table, else field 0's)."""
    specs = input_specs(cfg, shape)
    b, n_fields, hot = specs["sparse"][0]
    sizes = cfg.multi_hot_sizes or (1,) * n_fields
    sparse = torch.stack(
        [torch.randint(0, cfg.field_vocabs[f], (b, hot), generator=gen,
                       device=device, dtype=torch.int32)
         for f in range(n_fields)], dim=1)
    pos = torch.arange(hot, device=device)
    sparse = torch.where(pos[None, None, :] < torch.tensor(
        sizes, device=device)[None, :, None], sparse, -1)
    batch = {"dense": torch.randn(specs["dense"][0], generator=gen,
                                  device=device),
             "sparse": sparse}
    if cfg.seq_len:
        batch["seq"] = torch.randint(0, cfg.item_vocab, specs["seq"][0],
                                     generator=gen, device=device,
                                     dtype=torch.int32)
        batch["target_item"] = torch.randint(
            0, cfg.item_vocab, specs["target_item"][0], generator=gen,
            device=device, dtype=torch.int32)
    if "labels" in specs:
        batch["labels"] = torch.randint(
            0, 2, specs["labels"][0], generator=gen, device=device,
            dtype=torch.int32).to(torch.float32)
    if "candidates" in specs:
        rows = cfg.item_vocab if cfg.seq_len else cfg.field_vocabs[0]
        batch["candidates"] = torch.randint(
            0, rows, specs["candidates"][0], generator=gen, device=device,
            dtype=torch.int32)
    return batch
