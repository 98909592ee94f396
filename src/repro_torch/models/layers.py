"""Shared layers in functional form (port of the parts of
``repro.models.layers`` that the recsys models and the GNN need).

Parameters are plain dicts and tuples of tensors. Every init takes an
explicit ``torch.Generator`` and a device; on the ``"meta"`` device it
allocates nothing, which gives a tree's shapes. The forward layers keep
the reference's arithmetic: ``mha`` is plain einsums with f32 logits
(not ``F.scaled_dot_product_attention``, which takes neither a soft cap
nor the reference's masking constant), and a product of two dtypes runs in
their promoted dtype, as ``jnp`` promotes. ``rmsnorm``, ``rope``,
``chunked_mha`` and ``attention_mask`` come with the LM slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=device) * s
            ).to(_dtype(dtype))


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * 0.02
            ).to(_dtype(dtype))


def layernorm_init(dim, dtype, device, layers=None) -> dict:
    shape = (dim,) if layers is None else (layers, dim)
    return {"scale": torch.ones(shape, dtype=_dtype(dtype), device=device),
            "bias": torch.zeros(shape, dtype=_dtype(dtype), device=device)}


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: statistics in f32 (biased variance),
    ``(x - mu) * rsqrt(var + eps) * scale + bias``, cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = (y * params["scale"].to(torch.float32)
         + params["bias"].to(torch.float32))
    return y.to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two (``jnp``'s ``@``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(x / cap)`` in f32, cast
    back to x's dtype; the identity for ``cap <= 0``."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: torch.Tensor, *, logit_cap: float = 0.0,
        scale: float | None = None) -> torch.Tensor:
    """q: [B, Sq, H, hd], k/v: [B, Skv, KV, hd] (GQA: H = KV * groups);
    mask: bool [B, Sq, Skv], broadcast over heads. The logits are an f32
    einsum times ``scale`` (1/sqrt(hd) by default), soft-capped, set to
    -1e30 where ``mask`` is false, and soft-maxed in f32; the weights are
    cast to q's dtype before they weigh v. -> [B, Sq, H, hd]."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kvh, groups, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = softcap(logits, logit_cap)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(b, sq, h, hd)


def gated_mlp_init(gen: torch.Generator, d, f, dtype, device,
                   layers=None) -> dict:
    pre = () if layers is None else (layers,)
    return {"wi": dense_init(gen, pre + (d, 2 * f), dtype, device),
            "wo": dense_init(gen, pre + (f, d), dtype, device)}


def gated_mlp(params: dict, x: torch.Tensor,
              activation: str = "swiglu") -> torch.Tensor:
    """``(act(x @ wi_gate) * (x @ wi_up)) @ wo``: ``wi`` holds the gate
    and the up projection side by side; the activation (SiLU for swiglu,
    tanh-approximated GELU for geglu) runs in f32 and is cast back to x's
    dtype."""
    gate, up = matmul(x, params["wi"]).chunk(2, dim=-1)
    if activation == "swiglu":
        act = F.silu(gate.to(torch.float32)).to(x.dtype)
    elif activation == "geglu":
        act = F.gelu(gate.to(torch.float32), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(activation)
    return matmul(act * up, params["wo"])


def mlp_stack_init(gen: torch.Generator, dims, dtype, device,
                   bias=True) -> dict:
    """Plain MLP: dims = [in, h1, ..., out]."""
    layers = []
    for i in range(len(dims) - 1):
        p = {"w": dense_init(gen, (dims[i], dims[i + 1]), dtype, device)}
        if bias:
            p["b"] = torch.zeros((dims[i + 1],), dtype=_dtype(dtype),
                                 device=device)
        layers.append(p)
    return {"layers": tuple(layers)}


def mlp_stack(params: dict, x: torch.Tensor, act=torch.relu,
              final_act: bool = False) -> torch.Tensor:
    """Dense layers ``x @ w + b``, ``act`` after each but the last (and
    after the last too with ``final_act``)."""
    n = len(params["layers"])
    for i, p in enumerate(params["layers"]):
        x = matmul(x, p["w"])
        if "b" in p:
            x = x + p["b"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """table [V, D]; ids [B, hot] with -1 padding -> [B, D] (sum or mean
    over each bag's valid ids; an empty bag gives zeros)."""
    valid = ids >= 0
    rows = torch.where(valid[..., None], table[ids.clamp(min=0)], 0)
    out = rows.sum(dim=1)
    if mode == "mean":
        cnt = valid.sum(dim=1).to(rows.dtype)
        out = out / cnt.clamp(min=1)[:, None]
    elif mode != "sum":
        raise ValueError(mode)
    return out


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-hot lookup with -1 -> zeros."""
    out = table[ids.clamp(min=0)]
    return torch.where((ids >= 0)[..., None], out, 0)
