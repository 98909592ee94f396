"""RecSys parameter trees and the retrieval step (port of
``repro.models.recsys``).

The full parameter tree of all four models (Wide&Deep, DeepFM, DIEN, BST)
and ``retrieval_scores``: one user query, scored by max inner product
against ``n_candidates`` item embeddings through ``ops.distance_matrix``
(the CUDA distance kernel on the card). Plain functions on a tree of
tensors, as in the JAX module. The JAX module's ``constrain`` sharding
hints are the identity on one card; the sharding slice brings them back.
``recsys_forward`` and ``recsys_loss`` come with the ranking and training
slices.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.config.base import RecsysConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def _field_tables(cfg: RecsysConfig, gen, dim, device) -> tuple:
    return tuple(L.embed_init(gen, (cfg.field_vocabs[i], dim),
                              cfg.param_dtype, device)
                 for i in range(cfg.n_sparse))


def init_recsys(cfg: RecsysConfig, gen: torch.Generator | None,
                device) -> dict[str, Any]:
    """The model's parameter tree on ``device`` (random from ``gen``; on
    the ``"meta"`` device only shapes, and ``gen`` may be None)."""
    dt = cfg.param_dtype
    d = cfg.embed_dim
    params: dict[str, Any] = {"tables": _field_tables(cfg, gen, d, device)}

    mlp_in = cfg.n_sparse * d + cfg.n_dense
    if cfg.model == "wide_deep":
        params["wide"] = _field_tables(cfg, gen, 1, device)
        params["wide_dense"] = L.dense_init(gen, (cfg.n_dense, 1), dt, device)
    elif cfg.model == "deepfm":
        params["fm_linear"] = _field_tables(cfg, gen, 1, device)
    elif cfg.model == "dien":
        params["item_table"] = L.embed_init(gen, (cfg.item_vocab, d), dt,
                                            device)
        g = cfg.gru_dim
        params["gru"] = _gru_init(gen, d, g, dt, device)
        params["augru"] = _gru_init(gen, g, g, dt, device)
        params["attn"] = L.dense_init(gen, (g + d, 1), dt, device)
        mlp_in += g + d
    elif cfg.model == "bst":
        params["item_table"] = L.embed_init(gen, (cfg.item_vocab, d), dt,
                                            device)
        params["pos_embed"] = L.embed_init(gen, (cfg.seq_len + 1, d), dt,
                                           device)
        nb = cfg.n_blocks
        params["blocks"] = {
            "wq": L.dense_init(gen, (nb, d, d), dt, device),
            "wk": L.dense_init(gen, (nb, d, d), dt, device),
            "wv": L.dense_init(gen, (nb, d, d), dt, device),
            "wo": L.dense_init(gen, (nb, d, d), dt, device),
            "ln1": L.layernorm_init(d, dt, device, layers=nb),
            "ffn": L.gated_mlp_init(gen, d, 4 * d, dt, device, layers=nb),
            "ln2": L.layernorm_init(d, dt, device, layers=nb),
        }
        mlp_in += (cfg.seq_len + 1) * d
    else:
        raise ValueError(cfg.model)

    dims = [mlp_in] + list(cfg.mlp_dims) + [1]
    params["mlp"] = L.mlp_stack_init(gen, dims, dt, device)
    return params


def _gru_init(gen, d_in, d_h, dt, device) -> dict:
    return {"wx": L.dense_init(gen, (d_in, 3 * d_h), dt, device),
            "wh": L.dense_init(gen, (d_h, 3 * d_h), dt, device),
            "b": torch.zeros((3 * d_h,), dtype=getattr(torch, dt),
                             device=device)}


def params_from_numpy(cfg: RecsysConfig, tree, device) -> dict[str, Any]:
    """The JAX package's parameter tree, as numpy arrays (or anything
    ``np.asarray`` takes), as the port's tree of tensors on ``device``.

    Tuples stay tuples and dicts stay dicts. Every leaf's shape and the
    tree's structure are checked against :func:`init_recsys`'s tree.
    """
    return _carry(tree, init_recsys(cfg, None, "meta"), torch.device(device),
                  "params")


def _carry(node, like, device: torch.device, path: str):
    if isinstance(like, Mapping):
        if not isinstance(node, Mapping) or set(node) != set(like):
            raise ValueError(f"{path}: expected keys {sorted(like)}, got "
                             f"{sorted(node) if isinstance(node, Mapping) else type(node)}")
        return {k: _carry(node[k], like[k], device, f"{path}[{k!r}]")
                for k in like}
    if isinstance(like, tuple):
        if not isinstance(node, (tuple, list)) or len(node) != len(like):
            raise ValueError(f"{path}: expected a tuple of {len(like)}")
        return tuple(_carry(n, lk, device, f"{path}[{i}]")
                     for i, (n, lk) in enumerate(zip(node, like)))
    arr = np.asarray(node)
    if arr.shape != tuple(like.shape):
        raise ValueError(f"{path}: shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    return torch.tensor(arr, dtype=like.dtype, device=device)


def _sparse_embeddings(cfg: RecsysConfig, tables, sparse) -> torch.Tensor:
    """sparse int32[B, F, hot] -> [B, F, D] via per-field EmbeddingBag."""
    outs = []
    for f in range(cfg.n_sparse):
        hot = cfg.multi_hot_sizes[f] if cfg.multi_hot_sizes else 1
        ids = sparse[:, f, :hot]
        if hot == 1:
            outs.append(L.embedding_lookup(tables[f], ids[:, 0]))
        else:
            outs.append(L.embedding_bag(tables[f], ids, mode="sum"))
    return torch.stack(outs, dim=1)


def retrieval_scores(cfg: RecsysConfig, params, batch) -> torch.Tensor:
    """retrieval_cand: score each user query against the candidate items.

    The query embedding is the mean of the sparse-field embeddings; scores
    are inner products with the candidate item embeddings, computed as
    ``-ops.distance_matrix(q, cand_emb, metric="dot")``. f32[B, n_cand].
    """
    cdt = getattr(torch, cfg.compute_dtype)
    cand = batch["candidates"]                     # int32[n_cand]
    table = params.get("item_table", params["tables"][0])
    cand_emb = L.embedding_lookup(table, cand).to(cdt)
    dense = batch["dense"].to(cdt)
    emb = _sparse_embeddings(cfg, params["tables"], batch["sparse"])
    q = emb.mean(dim=1).to(cdt) + 0.0 * dense.sum(dim=-1, keepdim=True)
    d = ops.distance_matrix(q, cand_emb, metric="dot")     # [B, n_cand]
    return -d                                               # similarity
