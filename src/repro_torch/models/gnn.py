"""MeshGraphNet (Pfaff et al., arXiv:2010.03409), encode-process-decode
(port of ``repro.models.gnn``).

15 processor blocks; per block: an edge update MLP(e, h_src, h_dst), then
a node update MLP(h, sum of incoming messages), both residual, each MLP
ending in a LayerNorm. The aggregation is a segment sum over the edge
list, and here it is ``ops.csr_segment_sum``: kernel 7
(``csrc/segment_sum.cu``) on the card, its plain version on the CPU,
differentiable through ``ops.SegmentSum`` (backward: a gather). The
kernel wants destination-sorted edges, so :func:`gnn_forward` sorts the
edges once per call; predictions are per node, so the order of the edges
cannot show in them.

Graphs are flat tensors: node_feats [N, Fn], edge_src / edge_dst int32[E],
edge_feats [E, Fe], with -1 padding for both nodes and edges. Parameters
are the reference's tree (dicts and tuples of tensors; the processor's
weights stacked on a leading ``[L, ...]`` axis), so a checkpoint's leaf
keys are the reference's.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.device import resolve_device
from repro_torch.config.base import GNNConfig
from repro_torch.distributed.autoshard import constrain
from repro_torch.kernels import ops
from repro_torch.kernels.segment_sum import PAD_SENTINEL
from repro_torch.models import layers as L
from repro_torch.models.recsys import _carry


def _mlp_init(gen, dims, dtype, device, layer_norm=True, layers=None):
    """MLP over ``dims`` (mlp_layers hidden layers) with an optional output
    LayerNorm; ``layers`` stacks ``layers`` of them on a leading axis."""
    pre = () if layers is None else (layers,)
    p = {"w": tuple(L.dense_init(gen, pre + (dims[i], dims[i + 1]), dtype,
                                 device)
                    for i in range(len(dims) - 1)),
         "b": tuple(torch.zeros(pre + (dims[i + 1],), dtype=L._dtype(dtype),
                                device=device)
                    for i in range(len(dims) - 1))}
    if layer_norm:
        p["ln"] = L.layernorm_init(dims[-1], dtype, device, layers=layers)
    return p


def _mlp(p, x, eps=1e-5):
    n = len(p["w"])
    for i in range(n):
        # JAX's promotion: bf16 activations against f32 weights give f32
        x = L.matmul(x, p["w"][i]) + p["b"][i]
        if i < n - 1:
            x = torch.relu(x)
    if "ln" in p:
        x = L.layernorm(p["ln"], x, eps)
    return x


def init_gnn(cfg: GNNConfig, gen: torch.Generator | None = None,
             device=None) -> dict[str, Any]:
    """The model's parameter tree on ``device`` (the CUDA card by default:
    see ``resolve_device``), random from ``gen`` (a generator on that
    device). On the ``"meta"`` device it holds only shapes, and ``gen``
    may be None."""
    if torch.device(device or "cuda").type != "meta":
        device = resolve_device(device)
    dt = cfg.param_dtype
    dh = cfg.d_hidden
    hidden = [dh] * cfg.mlp_layers
    return {
        "node_enc": _mlp_init(gen, [cfg.in_node_dim] + hidden + [dh], dt,
                              device),
        "edge_enc": _mlp_init(gen, [cfg.in_edge_dim] + hidden + [dh], dt,
                              device),
        # the processor blocks' weights: a leading L axis
        "edge_mlp": _mlp_init(gen, [3 * dh] + hidden + [dh], dt, device,
                              layers=cfg.n_layers),
        "node_mlp": _mlp_init(gen, [2 * dh] + hidden + [dh], dt, device,
                              layers=cfg.n_layers),
        "decoder": _mlp_init(gen, [dh] + hidden + [cfg.out_dim], dt, device,
                             layer_norm=False),
    }


def params_from_numpy(cfg: GNNConfig, tree, device) -> dict[str, Any]:
    """The JAX package's parameter tree, as numpy arrays (or anything
    ``np.asarray`` takes), as the port's tree of tensors on ``device``;
    every leaf's shape and the structure are checked against
    :func:`init_gnn`'s tree."""
    return _carry(tree, init_gnn(cfg, None, "meta"), torch.device(device),
                  "params")


def _layer(p, i: int):
    """Layer ``i`` of a stacked MLP tree."""
    if isinstance(p, dict):
        return {k: _layer(v, i) for k, v in p.items()}
    if isinstance(p, tuple):
        return tuple(_layer(v, i) for v in p)
    return p[i]


def gnn_forward(cfg: GNNConfig, params, batch) -> torch.Tensor:
    """batch: node_feats [N, Fn], edge_src / edge_dst int32[E] (-1 pad),
    edge_feats [E, Fe]. Returns per-node predictions f32[N, out_dim].

    Dtypes follow JAX's promotion: a bf16 ``compute_dtype`` rounds the
    input features and each aggregate, but a product with f32 weights is
    f32, so under f32 parameters (every config's) the node and edge states
    and the messages are f32. Kernel 7 and its plain version sum in f32 and
    the sum is then cast to the compute dtype, as the TPU kernel does;
    ``jax.ops.segment_sum`` sums in the messages' dtype, so the two differ
    only for bf16 messages (bf16 parameters). The mean's counts are exact
    integers, where the reference counts in the compute dtype. Under ``cfg.remat`` each
    block runs under ``torch.utils.checkpoint``, so the backward runs its
    forward again (and kernel 7 with it). Each block lays its node states
    out over the data axes (``autoshard.constrain``), as the reference
    does; outside an ``activation_sharding`` policy that is the identity."""
    cdt = L._dtype(cfg.compute_dtype)
    nf = batch["node_feats"].to(cdt)
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = nf.shape[0]
    e_ok = (src >= 0) & (dst >= 0)
    # destination order, padding last: what kernel 7 takes
    order = torch.sort(torch.where(e_ok, dst, PAD_SENTINEL),
                       stable=True).indices
    src, dst, e_ok = src[order], dst[order], e_ok[order]
    ef = batch["edge_feats"][order].to(cdt)
    s_safe = src.clamp(min=0).long()
    d_gather = dst.clamp(min=0).long()
    d_seg = torch.where(e_ok, dst, -1)      # -1: dropped by the segment sum
    cnt = None
    if cfg.aggregator == "mean":
        cnt = torch.bincount(torch.where(e_ok, dst, n).long(),
                             minlength=n + 1)[:n].clamp(min=1)
    elif cfg.aggregator != "sum":
        raise ValueError(f"unknown aggregator {cfg.aggregator!r}")

    h = _mlp(params["node_enc"], nf)
    e = _mlp(params["edge_enc"], ef)

    def block(i: int, h: torch.Tensor, e: torch.Tensor):
        # the node-state carry shards over dp so the saved activations of
        # the blocks stay sharded
        h = constrain(h, "dp", None)
        msg_in = torch.cat([e, h[s_safe], h[d_gather]], dim=-1)
        e = e + _mlp(_layer(params["edge_mlp"], i), msg_in)
        agg = ops.csr_segment_sum(torch.where(e_ok[:, None], e, 0), d_seg, n)
        if cnt is not None:
            agg = agg / cnt[:, None]
        h = h + _mlp(_layer(params["node_mlp"], i),
                     torch.cat([h, agg.to(cdt)], dim=-1))
        return h, e

    for i in range(cfg.n_layers):
        if cfg.remat and torch.is_grad_enabled():
            h, e = checkpoint(block, i, h, e, use_reentrant=False)
        else:
            h, e = block(i, h, e)
    return _mlp(params["decoder"], h).to(torch.float32)


def gnn_loss(cfg: GNNConfig, params, batch) -> tuple[torch.Tensor, dict]:
    """MSE on (optionally masked) node targets: ``(loss, {"loss": loss})``."""
    pred = gnn_forward(cfg, params, batch)
    tgt = batch["node_targets"].to(torch.float32)
    mask = batch.get("node_mask")
    err = (pred - tgt) ** 2
    if mask is not None:
        w = mask.to(torch.float32)[:, None]
        loss = (err * w).sum() / torch.clamp(w.sum() * err.shape[-1],
                                             min=1.0)
    else:
        loss = err.mean()
    return loss, {"loss": loss}
