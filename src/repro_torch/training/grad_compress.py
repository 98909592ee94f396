"""Gradient compression for the data-parallel all-reduce, with error
feedback (port of ``repro.training.grad_compress``).

Two standard compressors, both with error-feedback residual accumulation
(Seide et al. 2014; Karimireddy et al. 2019), so that compression error
does not bias convergence:

  int8    per-tensor symmetric int8 quantization (4x fewer bytes than
          f32, 2x fewer than bf16)
  topk    keep the largest-|g| fraction of each tensor, carry the rest in
          the residual

In training the pair wraps the gradient between the backward pass and the
optimizer; on a data-parallel job the compressed form is what crosses the
interconnect. ``torch.round`` rounds half to even, as ``jnp.round`` does;
the top-k is a stable descending sort of |g|, so among equal magnitudes
the lower index wins, as with ``lax.top_k``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.common.util import tree_flatten_with_path, tree_unflatten


class CompressorState(NamedTuple):
    residual: Any


def init_state(params: Any) -> CompressorState:
    paths, treedef = tree_flatten_with_path(params)
    return CompressorState(residual=tree_unflatten(treedef, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for _, p in paths]))


def _int8_compress(g: torch.Tensor):
    amax = torch.max(torch.abs(g))
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _topk_compress(g: torch.Tensor, frac: float):
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    idx = torch.sort(torch.abs(flat), descending=True, stable=True
                     ).indices[:k]
    return flat[idx], idx


def _topk_decompress(vals: torch.Tensor, idx: torch.Tensor,
                     shape) -> torch.Tensor:
    flat = torch.zeros(math.prod(shape), dtype=torch.float32,
                       device=vals.device)
    return flat.index_copy(0, idx, vals).reshape(shape)


@torch.no_grad()
def compress_grads(grads: Any, state: CompressorState, method: str = "int8",
                   topk_frac: float = 0.01):
    """``(decompressed_grads, new_state, wire_bytes, dense_bytes)``.

    The decompressed gradients are what the optimizer consumes (what every
    replica would hold after the compressed all-reduce); the residual
    keeps what compression dropped (error feedback)."""
    dense_bytes = 0
    wire_bytes = 0
    new_resid = []
    out = []
    paths, treedef = tree_flatten_with_path(grads)
    rflat = [r for _, r in tree_flatten_with_path(state.residual)[0]]
    for (_, g), r in zip(paths, rflat):
        gf = g.to(torch.float32) + r
        dense_bytes += g.numel() * 4
        if method == "int8":
            q, scale = _int8_compress(gf)
            dec = _int8_decompress(q, scale)
            wire_bytes += q.numel() * 1 + 4
        elif method == "topk":
            vals, idx = _topk_compress(gf, topk_frac)
            dec = _topk_decompress(vals, idx, gf.shape)
            wire_bytes += vals.numel() * 4 + idx.numel() * 4
        elif method == "none":
            dec = gf
            wire_bytes += g.numel() * 4
        else:
            raise ValueError(method)
        new_resid.append(gf - dec)
        out.append(dec.to(g.dtype))
    return (tree_unflatten(treedef, out),
            CompressorState(residual=tree_unflatten(treedef, new_resid)),
            wire_bytes, dense_bytes)
