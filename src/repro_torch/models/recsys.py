"""RecSys ranking models and the retrieval step (port of
``repro.models.recsys``): Wide&Deep, DeepFM, DIEN, BST.

Shared substrate: per-field embedding tables with an EmbeddingBag for
multi-hot fields, a feature interaction per model, and an MLP tower:

  wide-deep  interaction = concat  (+ linear "wide" path over sparse ids)
  deepfm     interaction = FM: 0.5 * ((sum v)^2 - sum v^2)
  dien       interaction = GRU over behavior seq + AUGRU attention to target
  bst        interaction = transformer block over [behavior seq; target]

``recsys_forward`` gives CTR logits, ``recsys_loss`` the stable binary
cross-entropy, and ``retrieval_scores`` scores one user query by max inner
product against ``n_candidates`` item embeddings through
``ops.distance_matrix`` (the CUDA distance kernel on the card). Plain
functions on a tree of tensors, as in the JAX module; DIEN's two scans and
BST's stack of blocks are Python loops over the time steps and blocks.
The sharding hints (``autoshard.constrain``) are the reference's; outside
an ``activation_sharding`` policy they are the identity.

Batches: {"dense": f32[B, n_dense], "sparse": int32[B, n_sparse, hot]
(-1 pad), "seq": int32[B, T] (dien/bst), "target_item": int32[B],
"labels": f32[B]}: a binary CTR target.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.config.base import RecsysConfig
from repro_torch.distributed.autoshard import constrain
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


def _gru_cell(p: dict, h: torch.Tensor, x: torch.Tensor,
              att: torch.Tensor | None = None) -> torch.Tensor:
    """One GRU step in the reference's layout: ``wx`` [d_in, 3g] and
    ``wh`` [g, 3g] hold the reset, update and candidate gates side by
    side, one bias ``b`` on the input side, ``n = tanh(nx + r * nh)``.
    ``att`` (AUGRU) scales the update gate by the attention score (DIEN's
    attentional update gate)."""
    gx = x @ p["wx"] + p["b"]
    gh = h @ p["wh"]
    rx, zx, nx = gx.chunk(3, dim=-1)
    rh, zh, nh = gh.chunk(3, dim=-1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    if att is not None:
        z = z * att[:, None]
    return (1.0 - z) * n + z * h


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
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bf16: exact in f32
        arr = arr.astype(np.float32)
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


def _block(blocks: dict, i: int) -> dict:
    """Block ``i`` of a tree whose leaves carry a leading blocks axis."""
    return {k: _block(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in blocks.items()}


def _dien(cfg: RecsysConfig, params, batch, cdt) -> list[torch.Tensor]:
    """DIEN's features: the last AUGRU state and the target's embedding.
    A GRU runs over the behavior sequence; a softmax over its T states of
    their attention to the target weighs the AUGRU's update gate."""
    xe = L.embedding_lookup(params["item_table"], batch["seq"]).to(cdt)
    te = L.embedding_lookup(params["item_table"],
                            batch["target_item"]).to(cdt)
    b, t = xe.shape[:2]
    h = torch.zeros((b, cfg.gru_dim), dtype=cdt, device=xe.device)
    hs = []
    for x in xe.unbind(1):
        h = _gru_cell(params["gru"], h, x).to(cdt)
        hs.append(h)
    # B leads, so that the product's flattened rows keep B's sharding
    # (a DTensor cannot unflatten [T * B] with B sharded inside it)
    att_in = torch.cat([torch.stack(hs, dim=1),
                        te[:, None].expand(b, t, te.shape[-1])], dim=-1)
    scores = torch.softmax((att_in @ params["attn"].to(cdt))[..., 0],
                           dim=1)                             # [B, T]
    h = torch.zeros((b, cfg.gru_dim), dtype=cdt, device=xe.device)
    for x, a in zip(hs, scores.unbind(1)):
        h = _gru_cell(params["augru"], h, x, att=a).to(cdt)
    return [h, te]


def _bst(cfg: RecsysConfig, params, batch, cdt) -> list[torch.Tensor]:
    """BST's features: the blocks' output over [behavior seq; target],
    flattened. Each block: LN, q/k/v, ``mha`` with all positions visible,
    ``wo``, residual; LN, swiglu MLP, residual."""
    ids = torch.cat([batch["seq"], batch["target_item"][:, None]], dim=1)
    xe = L.embedding_lookup(params["item_table"], ids)
    b, t1 = ids.shape
    x = xe.to(cdt) + params["pos_embed"][None, :t1].to(cdt)
    hd = cfg.embed_dim // cfg.n_heads
    mask = torch.ones((b, t1, t1), dtype=torch.bool, device=x.device)
    blocks = params["blocks"]
    for i in range(blocks["wq"].shape[0]):
        p = _block(blocks, i)
        h = L.layernorm(p["ln1"], x)
        q = (h @ p["wq"]).reshape(b, t1, cfg.n_heads, hd)
        k = (h @ p["wk"]).reshape(b, t1, cfg.n_heads, hd)
        v = (h @ p["wv"]).reshape(b, t1, cfg.n_heads, hd)
        a = (L.mha(q, k, v, mask).reshape(b, t1, -1) @ p["wo"]).to(cdt)
        x = x + a
        h = L.layernorm(p["ln2"], x)
        x = x + L.gated_mlp(p["ffn"], h, "swiglu").to(cdt)
    return [x.reshape(b, -1)]


def recsys_forward(cfg: RecsysConfig, params, batch) -> torch.Tensor:
    """-> CTR logits f32[B]."""
    cdt = getattr(torch, cfg.compute_dtype)
    dense = batch["dense"].to(cdt)
    sparse = batch["sparse"]
    b = dense.shape[0]
    emb = constrain(_sparse_embeddings(cfg, params["tables"], sparse),
                    "dp", None, None).to(cdt)
    feats = [emb.reshape(b, -1), dense]
    extra_logit = 0.0

    if cfg.model == "wide_deep":
        wide = _sparse_embeddings(cfg, params["wide"], sparse)  # [B, F, 1]
        extra_logit = (wide.sum(dim=(1, 2))
                       + (dense @ params["wide_dense"].to(cdt))[:, 0])
    elif cfg.model == "deepfm":
        sum_v = emb.sum(dim=1)
        fm = 0.5 * (sum_v * sum_v - (emb * emb).sum(dim=1)).sum(dim=-1)
        lin = _sparse_embeddings(cfg, params["fm_linear"], sparse)
        extra_logit = fm + lin.sum(dim=(1, 2))
    elif cfg.model == "dien":
        feats += _dien(cfg, params, batch, cdt)
    elif cfg.model == "bst":
        feats += _bst(cfg, params, batch, cdt)

    z = constrain(torch.cat(feats, dim=-1), "dp", None)
    logit = L.mlp_stack(params["mlp"], z)[:, 0]
    return (logit + extra_logit).to(torch.float32)


def recsys_loss(cfg: RecsysConfig, params,
                batch) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean binary cross-entropy of the logits against ``labels``, in the
    stable form ``max(l, 0) - l * y + log1p(exp(-|l|))``."""
    logits = recsys_forward(cfg, params, batch)
    y = batch["labels"].to(torch.float32)
    loss = torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y + torch.log1p(torch.exp(-logits.abs())))
    return loss, {"loss": loss}


def retrieval_scores(cfg: RecsysConfig, params, batch) -> torch.Tensor:
    """retrieval_cand: score each user query against the candidate items.

    The query embedding is the mean of the sparse-field embeddings; scores
    are inner products with the candidate item embeddings, computed as
    ``-ops.distance_matrix(q, cand_emb, metric="dot")``. f32[B, n_cand].
    """
    cdt = getattr(torch, cfg.compute_dtype)
    cand = batch["candidates"]                     # int32[n_cand]
    table = params.get("item_table", params["tables"][0])
    cand_emb = constrain(L.embedding_lookup(table, cand), "tp",
                         None).to(cdt)
    dense = batch["dense"].to(cdt)
    emb = _sparse_embeddings(cfg, params["tables"], batch["sparse"])
    q = emb.mean(dim=1).to(cdt) + 0.0 * dense.sum(dim=-1, keepdim=True)
    d = constrain(ops.distance_matrix(q, cand_emb, metric="dot"),
                  None, "tp")                              # [B, n_cand]
    return -d                                               # similarity
