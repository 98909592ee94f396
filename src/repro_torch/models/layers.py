"""Shared layers in functional form (port of the parts of
``repro.models.layers`` that the recsys init and retrieval step and the
GNN need).

Parameters are plain dicts and tuples of tensors. Every init takes an
explicit ``torch.Generator`` and a device; on the ``"meta"`` device it
allocates nothing, which gives a tree's shapes. The other forward layers
(``rmsnorm``, ``mha``, ``gated_mlp``, ``mlp_stack``, ``rope``) come with
the ranking and LM slices.
"""

from __future__ import annotations

import math

import torch


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


def gated_mlp_init(gen: torch.Generator, d, f, dtype, device,
                   layers=None) -> dict:
    pre = () if layers is None else (layers,)
    return {"wi": dense_init(gen, pre + (d, 2 * f), dtype, device),
            "wo": dense_init(gen, pre + (f, d), dtype, device)}


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
