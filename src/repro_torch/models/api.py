"""Family-dispatch model API for the recsys family (port of the recsys
parts of ``repro.models.api``).

    api = model_api(arch.config)
    params = api.init(generator, device)
    step = make_retrieval_step(cfg, k=100)       (params, batch) -> (vals, ids)
    specs = input_specs(cfg, shape)              (shape, dtype) per input
    batch = make_batch(cfg, shape, generator, device)

``loss`` and the train step wait for the training slice; the LM and GNN
families for theirs.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.config.base import RecsysConfig, ShapeSpec
from repro_torch.models import recsys


class ModelAPI(NamedTuple):
    init: Callable                       # (generator, device) -> params


def model_api(cfg) -> ModelAPI:
    if isinstance(cfg, RecsysConfig):
        return ModelAPI(init=functools.partial(recsys.init_recsys, cfg))
    raise TypeError(f"the port has no model API for {type(cfg).__name__} yet")


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


def input_specs(cfg, shape: ShapeSpec) -> dict[str, tuple[tuple, torch.dtype]]:
    """Step inputs of one (arch, shape) cell as ``(shape, dtype)`` pairs,
    for the ``recsys_serve`` and ``recsys_retrieval`` kinds."""
    if not isinstance(cfg, RecsysConfig):
        raise TypeError(f"the port has no input specs for "
                        f"{type(cfg).__name__} yet")
    if shape.kind not in ("recsys_serve", "recsys_retrieval"):
        raise ValueError(f"shape kind {shape.kind!r} waits for its slice of "
                         f"the port (serve and retrieval only)")
    hot = max(cfg.multi_hot_sizes) if cfg.multi_hot_sizes else 1
    b = shape.get("batch", 1)
    specs = {"dense": ((b, cfg.n_dense), torch.float32),
             "sparse": ((b, cfg.n_sparse, hot), torch.int32)}
    if cfg.seq_len:
        specs["seq"] = ((b, cfg.seq_len), torch.int32)
        specs["target_item"] = ((b,), torch.int32)
    if shape.kind == "recsys_retrieval":
        specs["candidates"] = ((shape["n_candidates"],), torch.int32)
    return specs


def make_batch(cfg: RecsysConfig, shape: ShapeSpec, gen: torch.Generator,
               device) -> dict[str, Any]:
    """A random batch to :func:`input_specs`, drawn from ``gen`` on
    ``device``: dense features from N(0, 1); each field's ids uniform over
    its vocabulary, positions past the field's bag size -1; sequence and
    target items over the item table; candidates over the table that
    ``retrieval_scores`` scores (the item table, else field 0's)."""
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
    if "candidates" in specs:
        rows = cfg.item_vocab if cfg.seq_len else cfg.field_vocabs[0]
        batch["candidates"] = torch.randint(
            0, rows, specs["candidates"][0], generator=gen, device=device,
            dtype=torch.int32)
    return batch
