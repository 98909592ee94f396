"""Decoder-only transformer LM family (port of ``repro.models.transformer``).

Covers the five LM architectures from one config surface: GQA/MQA + RoPE
(+ optional QKV bias: qwen1.5), GeGLU/SwiGLU, tied embeddings with
optional sqrt(d) scaling (gemma), alternating local (sliding-window) /
global attention + attention and final logit soft-capping + sandwich norms
(gemma2), and token-choice top-k MoE with shared experts and
capacity-bounded sort-based dispatch (kimi-k2, granite).

The parameters keep the reference's stacked layout (a leading ``L`` axis
on every block leaf), so a checkpoint's leaf keys and a tree carried from
the JAX package are one to one; the layers run as a Python loop over that
axis (the reference scans it). The attention is plain einsums with f32
logits (``layers.mha`` / ``layers.chunked_mha``); no kernel of the port
lies on this path. The reference's sharding hints (``autoshard.constrain``
on the embeddings, the residual stream, q/k/v, the logits and the MoE
dispatch) are kept: outside an ``activation_sharding`` policy they return
their input, so the numbers are those of the unhinted model; under one
(the dry run's ``DTensor``s) they lay the activations out as GSPMD would.

Three entry points per the shape kinds:
  lm_loss      -- training forward + next-token cross entropy
  prefill      -- build a KV cache from a prompt (chunked attention from
                  8192 tokens)
  decode_step  -- one token against the KV cache, which it updates in
                  place (the reference returns a new cache)
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.device import resolve_device
from repro_torch.config.base import LMConfig, MoEConfig
from repro_torch.distributed.autoshard import (axis_size, constrain,
                                               sharded, split_dims)
from repro_torch.models import layers as L
from repro_torch.models.recsys import _carry

NEG_INF = -1e30
GLOBAL_WINDOW = 1 << 30   # "no window" sentinel for global-attention layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _stacked(gen, shape, dtype, device) -> torch.Tensor:
    """``dense_init`` of a leaf with a leading layer axis, drawn one layer
    at a time so that the f32 draw before the cast is one layer's, not the
    whole stack's (gemma2-9b's ``wi`` would be a 17.3 GB f32 transient)."""
    out = torch.empty(shape, dtype=L._dtype(dtype), device=device)
    for i in range(shape[0] if device.type != "meta" else 0):
        out[i] = L.dense_init(gen, shape[1:], dtype, device)
    return out


def init_lm(cfg: LMConfig, gen: torch.Generator | None = None,
            device=None) -> dict[str, Any]:
    """The model's parameter tree on ``device`` (the CUDA card by default),
    random from ``gen``: the reference's tree, leaf names, shapes and
    dtypes. On the ``"meta"`` device it holds only shapes, and ``gen`` may
    be None."""
    device = torch.device(device or "cuda")
    if device.type != "meta":
        device = resolve_device(device)
    dt = cfg.param_dtype
    d, h, kv, hd, nl = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.n_layers)

    def dense(*shape, dtype=dt):
        return _stacked(gen, shape, dtype, device)

    attn = {"wq": dense(nl, d, h * hd), "wk": dense(nl, d, kv * hd),
            "wv": dense(nl, d, kv * hd), "wo": dense(nl, h * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd),
                            ("bv", kv * hd)):
            attn[name] = torch.zeros((nl, width), dtype=L._dtype(dt),
                                     device=device)

    if cfg.moe is None:
        mlp = {"wi": dense(nl, d, 2 * cfg.d_ff), "wo": dense(nl, cfg.d_ff, d)}
    else:
        e = cfg.moe
        mlp = {"router": dense(nl, d, e.n_experts, dtype="float32"),
               "wi": dense(nl, e.n_experts, d, 2 * e.d_ff_expert),
               "wo": dense(nl, e.n_experts, e.d_ff_expert, d)}
        if e.n_shared_experts:
            f = e.n_shared_experts * e.d_ff_expert
            mlp["shared"] = {"wi": dense(nl, d, 2 * f), "wo": dense(nl, f, d)}

    block = {"attn_norm": L.rmsnorm_init(d, dt, device, layers=nl),
             "mlp_norm": L.rmsnorm_init(d, dt, device, layers=nl),
             "attn": attn, "mlp": mlp}
    if cfg.post_norms:
        block["attn_post_norm"] = L.rmsnorm_init(d, dt, device, layers=nl)
        block["mlp_post_norm"] = L.rmsnorm_init(d, dt, device, layers=nl)

    params = {"embed": L.embed_init(gen, (cfg.vocab_size, d), dt, device),
              "blocks": block,
              "final_norm": L.rmsnorm_init(d, dt, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (d, cfg.vocab_size), dt, device)
    return params


def params_from_numpy(cfg: LMConfig, tree, device) -> dict[str, Any]:
    """The JAX package's parameter tree, as numpy arrays (or anything
    ``np.asarray`` takes; bf16 leaves too), as the port's tree of tensors
    on ``device``; every leaf's shape and the structure are checked
    against :func:`init_lm`'s tree."""
    return _carry(tree, init_lm(cfg, None, "meta"), torch.device(device),
                  "params")


def layer_windows(cfg: LMConfig) -> list[int]:
    """Per-layer sliding-window sizes (GLOBAL_WINDOW = unrestricted).

    gemma2 alternates local (even layers, window 4096) and global."""
    if cfg.attn_pattern == "local_global":
        return [cfg.local_window if i % 2 == 0 else GLOBAL_WINDOW
                for i in range(cfg.n_layers)]
    return [GLOBAL_WINDOW] * cfg.n_layers


def _layer(blocks: Mapping, i: int) -> dict:
    """Layer ``i`` of the stacked block tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, capacity-bounded sort-based dispatch)
# ---------------------------------------------------------------------------


def moe_capacity(moe: MoEConfig, tokens: int) -> int:
    """Slots an expert takes from ``tokens`` tokens: ceil(T k / E x cf),
    rounded up to a multiple of 8, at least 8."""
    cap = int(np.ceil(tokens * moe.top_k / moe.n_experts
                      * moe.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_dispatch(router: torch.Tensor, xg: torch.Tensor, moe: MoEConfig):
    """The routing tables of tokens xg [G, Tl, d]: ``(slot_tok, slot_gate)``,
    [G, E, C] each, the token in each expert's slot (-1 empty) and its
    gate. Each token picks its top-k experts by router logit (f32; a
    stable descending sort, so ties go to the lower expert as in
    ``lax.top_k``), gates are the softmax of those k logits, and each
    expert fills its C slots with the (token, choice) pairs that chose it
    in token order (a stable sort, as ``jnp.argsort``); pairs beyond C are
    dropped."""
    g, tl, _ = xg.shape
    e, k = moe.n_experts, moe.top_k
    cap = moe_capacity(moe, tl)
    dev = xg.device
    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32),
                          router.to(torch.float32))
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]   # [G, Tl, k]
    gates = torch.softmax(top_vals, dim=-1)

    e_flat = top_idx.reshape(g, tl * k)
    t_flat = torch.arange(tl, device=dev)[:, None].expand(tl, k).reshape(
        1, tl * k).expand(g, tl * k)
    g_flat = gates.reshape(g, tl * k)
    order = torch.sort(e_flat, dim=-1, stable=True).indices
    se = torch.gather(e_flat, -1, order)
    st = torch.gather(t_flat, -1, order)
    sg = torch.gather(g_flat, -1, order)
    idx = torch.arange(tl * k, device=dev)[None].expand(g, tl * k)
    # each pair's rank in its expert's run of the sorted pairs: its index
    # less the run's start, the count of the pairs of lower experts (the
    # reference's cummax over run starts; DTensor 2.11 has no rule for
    # cummax, nor for the ``!=`` that finds the starts)
    counts = se.new_zeros((g, e)).scatter_add(1, se, torch.ones_like(se))
    rank = idx - torch.gather(torch.cumsum(counts, dim=1) - counts, 1, se)
    keep = rank < cap

    # the reference's .at[...].set(mode="drop") as a sum into zeros,
    # batched over G along dim 1 (a DTensor shards it on G): a kept pair
    # owns its slot, and a dropped one adds 0 into its expert's slot 0, so
    # every sum is exact. The tokens are stored as t + 1 (0 is empty).
    slot = (se * cap + torch.where(keep, rank, 0))
    slot_tok = se.new_zeros((g, e * cap)).scatter_add(
        1, slot, torch.where(keep, st + 1, 0)) - 1
    slot_gate = sg.new_zeros((g, e * cap)).scatter_add(
        1, slot, torch.where(keep, sg, 0.0))
    # the gates' gradient comes back laid out as the experts' outputs are
    # (capacity split over the model axis where E does not divide it): it
    # is gathered over C before the backward flattens [E, C]
    return (slot_tok.reshape(g, e, cap),
            constrain(slot_gate.reshape(g, e, cap), "dp", None, None))


def _experts(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each expert's product: x [G, E, C, k] times w [E, k, n] -> [G, E,
    C, n]. Where a sharding policy splits x over G and C (E does not
    divide the model axis: granite's 40 on 16) each chip multiplies its
    own slots by the whole w, as GSPMD gathers it, and w's gradient is
    the chips' sum: the einsum would flatten G with C, two split dims,
    which DTensor 2.11 refuses."""
    if split_dims(x) != {0, 2}:
        return torch.einsum("gecd,edf->gecf", x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    if isinstance(w, DTensor):
        # summed over the mesh dims that split the slots
        w = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial() if isinstance(q, Shard)
                             else Replicate() for q in x.placements])
    out = torch.einsum("gecd,edf->gecf", x.to_local(), w)
    return DTensor.from_local(out, mesh, x.placements, run_check=False)


def _combine(ye: torch.Tensor, slot_tok: torch.Tensor,
             tl: int) -> torch.Tensor:
    """The experts' outputs ye [G, E, C, d] summed into each group's
    tokens, [G, Tl + 1, d]: the reference's vmapped
    ``.at[...].add(mode="drop")``, one sum along dim 1 batched over G;
    empty slots add into row Tl, which the caller cuts off. Where ye is
    split over G and C each chip sums its own slots into its group's
    rows, the sum ``Partial`` over the model axis (DTensor 2.11 flattens
    no [E, C] with C split)."""
    d = ye.shape[-1]
    dest = torch.where(slot_tok >= 0, slot_tok, tl)

    def add(y, dst):
        g = y.shape[0]
        return y.new_zeros((g, tl + 1, d)).scatter_add(
            1, dst.reshape(g, -1, 1).expand(-1, -1, d), y.reshape(g, -1, d))

    if split_dims(ye) != {0, 2}:
        return add(ye, dest)
    from torch.distributed.tensor import DTensor, Partial, Shard

    out = add(ye.to_local(), constrain(dest, "dp", None, "tp").to_local())
    return DTensor.from_local(
        out, ye.device_mesh,
        [Partial() if isinstance(q, Shard) and q.dim == 2 else q
         for q in ye.placements], run_check=False)


def moe_apply(p, x: torch.Tensor, moe: MoEConfig,
              activation: str) -> torch.Tensor:
    """x: [T, d] -> [T, d]. Token-choice top-k, sort-based dispatch into
    [E, C] slots (:func:`moe_dispatch`); tokens beyond capacity are
    dropped (GShard, cf=1.25).

    Dispatch is grouped by data shard, as the reference groups it: G is
    ``axis_size("dp")`` under an ``activation_sharding`` policy (1 without
    one, or where G does not divide T), and each group routes only its own
    tokens with a per-group capacity, so no dispatch tensor leaves its
    shard. On CUDA the combine's ``scatter_add`` is atomic: the order in
    which a token's k expert outputs are summed varies from run to run."""
    t, d = x.shape
    e = moe.n_experts
    g = axis_size("dp")
    if t % g:
        g = 1
    tl = t // g                                  # tokens per group
    xg = constrain(x.reshape(g, tl, d), "dp", None, None)
    slot_tok, slot_gate = moe_dispatch(p["router"], xg, moe)

    cap = slot_tok.shape[-1]
    rows = slot_tok.clamp(min=0).reshape(g, e * cap, 1).expand(-1, -1, d)
    xe = torch.where((slot_tok >= 0)[..., None],
                     torch.gather(xg, 1, rows).reshape(g, e, cap, d),
                     0)                                       # [G, E, C, d]
    # experts over model (EP), groups over data. When E doesn't divide the
    # model axis (granite: 40/16), shard capacity over model instead.
    ec = (("dp", "tp") if e % max(axis_size("tp"), 1) == 0
          else ("dp", None, "tp"))
    spec = (ec + (None,) * (4 - len(ec)))[:3] + (None,)
    xe = constrain(xe, *spec)
    dt = torch.promote_types(xe.dtype, p["wi"].dtype)
    gate_up = constrain(_experts(xe.to(dt), p["wi"].to(dt)), *spec)
    gate, up = gate_up.chunk(2, dim=-1)
    if activation == "swiglu":
        act = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype)
    else:
        act = torch.nn.functional.gelu(gate.to(torch.float32),
                                       approximate="tanh").to(x.dtype)
    h = act * up
    dt = torch.promote_types(h.dtype, p["wo"].dtype)
    ye = constrain(_experts(h.to(dt), p["wo"].to(dt)), *spec)
    ye = ye * slot_gate[..., None].to(ye.dtype)

    out = constrain(_combine(ye, slot_tok, tl)[:, :tl], "dp", None,
                    None).reshape(t, d)
    if "shared" in p:
        out = out + L.gated_mlp(p["shared"], x, activation)
    return out


# ---------------------------------------------------------------------------
# transformer blocks
# ---------------------------------------------------------------------------


def _embed(cfg: LMConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the compute dtype, times sqrt(d_model) rounded
    to the compute dtype where the config scales them."""
    cdt = L._dtype(cfg.compute_dtype)
    x = L.embedding_lookup(params["embed"], tokens).to(cdt)
    if cfg.embedding_scale:
        s = torch.tensor(np.sqrt(cfg.d_model), dtype=cdt)
        x = x * s.item()
    return x


def _head(cfg: LMConfig, params, x: torch.Tensor,
          roles: tuple = ()) -> torch.Tensor:
    """Final norm, the (tied) head in the compute dtype (its logits laid
    out by ``roles`` where given), the final soft cap; logits f32."""
    cdt = L._dtype(cfg.compute_dtype)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = L.matmul(x, head.to(cdt))
    if roles:
        logits = constrain(logits, *roles)
    return L.softcap(logits, cfg.final_logit_softcap).to(torch.float32)


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n * hd] -> [B, S, n, hd]. Under a sharding policy the flat
    width is first gathered over the model axis where n heads do not
    divide it (a DTensor splits no sharded dim unevenly, where GSPMD
    reshards by itself); without one a plain reshape."""
    if n % axis_size("tp"):
        t = constrain(t, "dp", None, None)
    return t.reshape(*t.shape[:-1], n, hd)


def _merged(t: torch.Tensor) -> torch.Tensor:
    """[B, S, n, hd] -> [B, S, n * hd], :func:`_heads`' inverse. Where n
    heads do not divide the model axis the flat width is kept whole under
    a sharding policy, so that its gradient, which the output projection
    sends back split over the model axis, is gathered before the backward
    splits it into n heads."""
    out = t.reshape(*t.shape[:2], -1)
    if t.shape[2] % axis_size("tp"):
        out = constrain(out, "dp", None, None)
    return out


def _qkv(cfg: LMConfig, p, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.matmul(x, p["wq"])
    k = L.matmul(x, p["wk"])
    v = L.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(_heads(q, h, hd), "dp", None, "tp", None)
    k = constrain(_heads(k, kv, hd), "dp", None, "tp", None)
    v = constrain(_heads(v, kv, hd), "dp", None, "tp", None)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out_and_mlp(cfg: LMConfig, p, x: torch.Tensor,
                      attn: torch.Tensor) -> torch.Tensor:
    """The residual after the attention output ``attn`` [B, S, H * hd]:
    the output projection, the post-attention norm, the MLP (or MoE)
    sub-block, the post-MLP norm."""
    # the sub-blocks' outputs are kept whole in S, so that their gradients,
    # laid out as the sequence-sharded residual's, are gathered before the
    # products' backward flattens [B, S]
    a = constrain(L.matmul(attn, p["attn"]["wo"]), "dp", None, None)
    if cfg.post_norms:
        a = L.rmsnorm(p["attn_post_norm"], a, cfg.norm_eps)
    x = x + a
    h = constrain(L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps), "dp", None, None)
    if cfg.moe is None:
        m = L.gated_mlp(p["mlp"], h, cfg.activation)
    else:
        b, s, d = h.shape
        m = moe_apply(p["mlp"], h.reshape(b * s, d), cfg.moe,
                      cfg.activation).reshape(b, s, d)
    m = constrain(m, "dp", None, None)
    if cfg.post_norms:
        m = L.rmsnorm(p["mlp_post_norm"], m, cfg.norm_eps)
    return x + m


def _block(cfg: LMConfig, p, x: torch.Tensor, positions: torch.Tensor,
           window: int, chunked: bool):
    """One layer with full-sequence causal attention (within ``window``):
    -> (x', k, v), k and v this layer's [B, S, KV, hd] for a cache."""
    b, s, _ = x.shape
    # the sequence re-gathered before the projections (Megatron-SP): a
    # product flattens [B, S] and a DTensor flattens no sharded S
    h = constrain(L.rmsnorm(p["attn_norm"], x, cfg.norm_eps), "dp", None, None)
    q, k, v = _qkv(cfg, p["attn"], h, positions)
    if chunked:
        attn = L.chunked_mha(q, k, v, positions, positions, causal=True,
                             window=window,
                             logit_cap=cfg.attn_logit_softcap)
    else:
        mask = L.attention_mask(positions, positions, causal=True,
                                window=window)
        attn = L.mha(q, k, v, mask, logit_cap=cfg.attn_logit_softcap)
    return _attn_out_and_mlp(cfg, p, x, _merged(attn)), k, v


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def lm_forward(cfg: LMConfig, params, tokens: torch.Tensor,
               chunked: bool | None = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (f32). Chunked attention by
    default from 2048 tokens; with ``cfg.remat`` and grad enabled each
    layer runs under ``torch.utils.checkpoint``."""
    b, s = tokens.shape
    chunked = (s >= 2048) if chunked is None else chunked
    x = constrain(_embed(cfg, params, tokens), "dp", None, None)
    positions = _positions(b, s, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, w in enumerate(layer_windows(cfg)):
        p = _layer(params["blocks"], i)
        # the residual carry is sequence-sharded over the model axis
        # ("sp"), so the per-layer saved activations are 1/TP the size
        x = constrain(x, "dp", "sp", None)
        if remat:
            x = checkpoint(_block, cfg, p, x, positions, w, chunked,
                           use_reentrant=False)[0]
        else:
            x = _block(cfg, p, x, positions, w, chunked)[0]
    x = constrain(x, "dp", None, None)
    return _head(cfg, params, x, ("dp", None, "tp"))


def lm_loss(cfg: LMConfig, params,
            batch) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token cross entropy. batch: {"tokens": int32[B, S]} ->
    ``(loss, {"loss", "ppl"})``: the mean over B x (S - 1) positions of
    ``logsumexp(logits) - logits[target]``. With the vocabulary sharded
    over a model axis (under a sharding policy) the target logit is a
    masked sum over the vocabulary, as the reference takes it, which
    reduces over the shards where a gather would gather them; the two
    give the same number."""
    tokens = batch["tokens"]
    logits = lm_forward(cfg, params, tokens)[:, :-1]        # [B, S-1, V]
    targets = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    if axis_size("tp") > 1:
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        tgt = torch.where(targets[..., None] == vocab, logits, 0.0).sum(-1)
    else:
        tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    loss = (lse - tgt).mean()
    return loss, {"loss": loss, "ppl": torch.exp(loss)}


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor       # [L, B, S_max, KV, hd]
    v: torch.Tensor       # [L, B, S_max, KV, hd]
    length: torch.Tensor  # int32 0-dim, on the cache's device: tokens cached


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device=None) -> KVCache:
    """An empty cache of ``max_len`` positions in the compute dtype on
    ``device`` (the CUDA card by default)."""
    device = resolve_device(device)
    cdt = L._dtype(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cdt, device=device),
                   v=torch.zeros(shape, dtype=cdt, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(cfg: LMConfig, params, cache: KVCache,
                token: torch.Tensor) -> tuple[KVCache, torch.Tensor]:
    """One-token decode. token: int32[B] -> (cache, logits f32[B, V]).

    Attention runs over the full cached prefix (masked beyond ``length``;
    local layers also masked to their sliding window). Unlike the
    reference, the step writes the new K/V into ``cache`` in place, layer
    by layer, and advances ``cache.length`` in place: the cache returned
    is the one given. The position, the masks and the write index are
    formed from the ``length`` tensor on the device, so the step never
    reads it on the host."""
    b = token.shape[0]
    pos = cache.length
    positions = pos.expand(b, 1)
    x = _embed(cfg, params, token[:, None])
    s_max = cache.k.shape[2]
    kv_pos = torch.arange(s_max, dtype=torch.int32, device=token.device)
    diff = pos - kv_pos                                     # [s_max]
    seen = kv_pos <= pos
    masks = {}
    write = pos.reshape(1).long()
    for i, w in enumerate(layer_windows(cfg)):
        if w not in masks:
            masks[w] = (seen & (diff < w)).expand(b, 1, s_max)
        p = _layer(params["blocks"], i)
        h = L.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        q, k1, v1 = _qkv(cfg, p["attn"], h, positions)
        ck, cv = cache.k[i], cache.v[i]
        if sharded():
            # a DTensor's in-place index_copy_ into a sharded view of the
            # cache relabels the view's layout without moving its data; a
            # masked select written back keeps it (and reads and writes
            # the whole cache, where index_copy_ writes one position)
            at = (kv_pos == pos)[None, :, None, None]
            ck.copy_(torch.where(at, k1.to(ck.dtype), ck))
            cv.copy_(torch.where(at, v1.to(cv.dtype), cv))
        else:
            ck.index_copy_(1, write, k1.to(ck.dtype))
            cv.index_copy_(1, write, v1.to(cv.dtype))
        attn = L.mha(q, ck, cv, masks[w], logit_cap=cfg.attn_logit_softcap)
        x = _attn_out_and_mlp(cfg, p, x, _merged(attn))
    cache.length.add_(1)
    return cache, _head(cfg, params, x)[:, 0]


def prefill(cfg: LMConfig, params, tokens: torch.Tensor,
            max_len: int | None = None) -> tuple[KVCache, torch.Tensor]:
    """Prompt -> KV cache of ``max_len`` positions (default S) + the
    last position's logits f32[B, V]. tokens int32[B, S]. Chunked
    attention from 8192 tokens. The cache holds K in K's dtype and V cast
    to it, zero past S, as the reference pads it."""
    b, s = tokens.shape
    max_len = max_len or s
    x = _embed(cfg, params, tokens)
    positions = _positions(b, s, tokens.device)
    chunked = s >= 8192
    remat = cfg.remat and torch.is_grad_enabled()
    ck = cv = None
    for i, w in enumerate(layer_windows(cfg)):
        p = _layer(params["blocks"], i)
        if remat:
            x, k1, v1 = checkpoint(_block, cfg, p, x, positions, w, chunked,
                                   use_reentrant=False)
        else:
            x, k1, v1 = _block(cfg, p, x, positions, w, chunked)
        if ck is None:
            shape = (cfg.n_layers, b, max_len) + tuple(k1.shape[2:])
            # new_zeros: a DTensor k1 (a sharded dry run) makes a DTensor
            ck = k1.new_zeros(shape)
            cv = k1.new_zeros(shape)
        ck[i, :, :s] = k1
        cv[i, :, :s] = v1.to(k1.dtype)
    logits = _head(cfg, params, x[:, -1])
    length = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return KVCache(k=ck, v=cv, length=length), logits
