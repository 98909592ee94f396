"""Shared layers in functional form (port of ``repro.models.layers``:
what the LM family, the recsys models and the GNN need).

Parameters are plain dicts and tuples of tensors. Every init takes an
explicit ``torch.Generator`` and a device; on the ``"meta"`` device it
allocates nothing, which gives a tree's shapes. The forward layers keep
the reference's arithmetic: ``mha`` and ``chunked_mha`` are plain einsums
with f32 logits (not ``F.scaled_dot_product_attention``, which takes
neither a soft cap nor the reference's masking constant), and a product of
two dtypes runs in their promoted dtype, as ``jnp`` promotes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.autoshard import (axis_size, constrain,
                                               local_shard, sharded,
                                               split_dims)


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


def rmsnorm_init(dim, dtype, device, layers=None) -> dict:
    shape = (dim,) if layers is None else (layers, dim)
    return {"scale": torch.zeros(shape, dtype=_dtype(dtype), device=device)}


def rmsnorm(params: dict, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the (1 + scale) parameterization (gemma's): the mean
    square in f32, ``x * rsqrt(ms + eps) * (1 + scale)``, cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


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


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, halves rotated: x [..., S, H, hd], positions
    [..., S] (int). The frequencies ``theta ** (-arange(half) / half)``
    and the angles ``position * freq`` are f32, as the reference forms
    them; the rotation runs in the promoted dtype of x and f32, cast back
    to x's dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freq   # [..., S, half]
    ang = ang[..., :, None, :]                               # [..., S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(x / cap)`` in f32, cast
    back to x's dtype; the identity for ``cap <= 0``."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                   causal: bool, window) -> torch.Tensor:
    """[..., Sq, Skv] boolean: ``q - kv < window`` (and ``>= 0`` when
    causal); layers with unrestricted attention pass a huge window."""
    diff = q_pos[..., :, None] - kv_pos[..., None, :]
    mask = diff < window
    if causal:
        mask &= diff >= 0
    return mask


def _group_heads(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """q [B, S, H, hd] -> [B, S, KV, H / KV, hd]. Under a sharding policy
    q's heads are first gathered over the model axis where the KV heads
    do not divide it (a DTensor splits no sharded dim unevenly); without
    one a plain reshape."""
    b, s, h, hd = q.shape
    if kvh % axis_size("tp"):
        q = constrain(q, "dp", None, None, None)
    return q.reshape(b, s, kvh, h // kvh, hd)


def _merged_heads(out: torch.Tensor, kvh: int) -> torch.Tensor:
    """The attention output [B, S, H, hd], merged from its KV groups, kept
    with its heads gathered where :func:`_group_heads` gathered them, so
    the backward splits no sharded dim either."""
    if kvh % axis_size("tp"):
        out = constrain(out, "dp", None, None, None)
    return out


def _on_shards(fn, q, k, v, rows, **kw) -> torch.Tensor:
    """``fn(q, k, v, *rows, **kw)`` on each chip's own batch rows and KV
    heads, where a sharding policy splits k [B, S, KV, hd] over both, as
    GSPMD partitions a product batched over two sharded dims:
    attention mixes neither rows nor heads, so the shards' outputs laid
    out as q is are the output. ``rows`` are [B, ...] tensors (a mask,
    positions). (``DTensor`` 2.11 flattens no two sharded dims, which the
    einsums' batched products do.)"""
    from torch.distributed.tensor import DTensor

    mesh = k.device_mesh
    q, k, v = (constrain(t, "dp", None, "tp", None) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(),
             *(local_shard(r, mesh, "dp", *(None,) * (r.ndim - 1))
               for r in rows), **kw)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: torch.Tensor, *, logit_cap: float = 0.0,
        scale: float | None = None) -> torch.Tensor:
    """q: [B, Sq, H, hd], k/v: [B, Skv, KV, hd] (GQA: H = KV * groups);
    mask: bool [B, Sq, Skv], broadcast over heads. The logits are an f32
    einsum times ``scale`` (1/sqrt(hd) by default), soft-capped, set to
    -1e30 where ``mask`` is false, and soft-maxed in f32; the weights are
    cast to q's dtype before they weigh v. -> [B, Sq, H, hd]."""
    if split_dims(k) == {0, 2}:
        return _on_shards(mha, q, k, v, (mask,), logit_cap=logit_cap,
                          scale=scale)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = _group_heads(q, kvh)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = softcap(logits, logit_cap)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return _merged_heads(out.reshape(b, sq, h, hd), kvh)


def chunked_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
                window, logit_cap: float = 0.0, chunk: int = 512,
                scale: float | None = None) -> torch.Tensor:
    """Online-softmax (flash-style) attention over KV chunks of ``chunk``
    rows: O(Sq * chunk) scores instead of O(Sq * Skv). q: [B, Sq, H, hd],
    k/v: [B, Skv, KV, hd], q_pos [B, Sq], kv_pos [B, Skv] -> [B, Sq, H, hd].

    The reference's loop: KV padded to whole chunks at position -1 (never
    valid); q times ``scale`` in the promoted dtype of q and f32 (the
    reference's numpy scale promotes a bf16 q); f32 logits, soft-capped,
    set to -1e30 where masked; running max, numerator and denominator in
    f32; the probabilities cast to k's dtype before they weigh v; the
    output ``num / max(den, 1e-30)`` in q's dtype. With grad enabled each
    chunk runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint(step)``): the backward recomputes a chunk's
    probabilities instead of keeping them."""
    if split_dims(k) == {0, 2}:
        return _on_shards(chunked_mha, q, k, v, (q_pos, kv_pos),
                          causal=causal, window=window, logit_cap=logit_cap,
                          chunk=chunk, scale=scale)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    scale_ = scale if scale is not None else 1.0 / math.sqrt(hd)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    qdt = torch.promote_types(q.dtype, torch.float32)
    qg = _group_heads(q, kvh).to(qdt) * scale_
    qp = q_pos[:, None, None, :, None]

    def step(m, num, den, kc, vc, pc):
        logits = torch.einsum("bqkgh,bskh->bkgqs", qg,
                              kc.to(torch.float32))
        logits = softcap(logits, logit_cap)
        pcb = pc[:, None, None, None, :]
        diff = qp - pcb
        mask = (pcb >= 0) & (diff < window)
        if causal:
            mask &= diff >= 0
        logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        pv = torch.einsum("bkgqs,bskh->bkgqh",
                          p.to(kc.dtype).to(torch.float32),
                          vc.to(torch.float32))
        num = num * alpha[..., None] + pv
        den = den * alpha + p.sum(dim=-1)
        return m_new, num, den

    m = torch.full((b, kvh, groups, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    num = torch.zeros((b, kvh, groups, sq, hd), dtype=torch.float32,
                      device=q.device)
    den = torch.zeros((b, kvh, groups, sq), dtype=torch.float32,
                      device=q.device)
    remat = torch.is_grad_enabled()
    for c in range(n_chunks):
        rows = slice(c * chunk, (c + 1) * chunk)
        xs = (k[:, rows], v[:, rows], kv_pos[:, rows])
        if remat:
            m, num, den = checkpoint(step, m, num, den, *xs,
                                     use_reentrant=False)
        else:
            m, num, den = step(m, num, den, *xs)
    out = (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
    return _merged_heads(out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd),
                         kvh)


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
    gate_up = matmul(x, params["wi"])
    if gate_up.ndim == 3:
        gate_up = constrain(gate_up, "dp", None, "tp")
    gate, up = gate_up.chunk(2, dim=-1)
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
    rows = torch.where(valid[..., None], _take(table, ids.clamp(min=0)), 0)
    out = rows.sum(dim=1)
    if mode == "mean":
        cnt = valid.sum(dim=1).to(rows.dtype)
        out = out / cnt.clamp(min=1)[:, None]
    elif mode != "sum":
        raise ValueError(mode)
    return out


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids >= 0. Under a sharding policy the rows are
    taken by ``F.embedding`` (the same rows), whose backward DTensor
    shards where it has no rule for ``table[ids]``'s (2.11's fails on a
    batch of bags too), from the table gathered over the data axes as
    FSDP gathers a weight before its use (its vocabulary stays sharded
    over model; a lookup into a table whose width shares the ids' data
    axes masks the wrong rows). Where the model axis does not divide the
    vocabulary (granite's 49,155) the ids are gathered instead and each
    chip takes every id's slice of its own columns: DTensor 2.11's
    backward of a whole-table gather fails at full size."""
    if not sharded():
        return table[ids]
    from torch.distributed.tensor import DTensor, Replicate

    if (table.shape[0] % axis_size("tp") == 0
            or not isinstance(ids, DTensor)):
        return F.embedding(ids, constrain(table, "tp", None))
    mesh = ids.device_mesh
    return F.embedding(ids.redistribute(mesh, [Replicate()] * mesh.ndim),
                       table)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-hot lookup with -1 -> zeros."""
    return torch.where((ids >= 0)[..., None], _take(table, ids.clamp(min=0)),
                       0)
