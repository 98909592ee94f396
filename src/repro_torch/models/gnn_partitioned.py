"""Halo-partitioned message passing, owner-computes (port of
``repro.models.gnn_partitioned``).

Edge-parallel message passing (``models/gnn.py`` under a sharding policy)
keeps every node state on every chip and reduces the whole [N, d_hidden]
aggregate each block, so its collective bytes grow with N whatever the
partition. Mesh-like graphs (MeshGraphNet's own domain) split into parts
with small boundaries, so the production layout is owner-computes:

  * the nodes are split into P partitions (one a chip over every mesh
    axis); a chip owns its nodes' states and every edge whose destination
    it owns;
  * each block, a chip sends only the boundary ("halo") rows its peers
    need: a send buffer [P, S, d] -> all-to-all -> the received halo, so a
    block moves P * S * d a chip instead of N * d.

The shapes are uniform (S halo slots a pair of partitions, -1 padded), so
one program serves any partitioning; its quality only changes S.

:func:`partitioned_loss` holds the partitions in one of two ways, which
differ only in the exchange and in the two sums of the loss:

  * over a torch ``DeviceMesh`` (the ``fake`` group of the dry run; gloo
    or NCCL ranks): every input a ``DTensor`` sharded on dim 0 over every
    mesh dim (or this rank's [1, ...] shard as a plain tensor), the
    counterpart of ``shard_map``; the exchange is the differentiable
    all-to-all of ``_functional_collectives`` over the mesh's flattened
    group, the sums are all-reduces;
  * ``mesh=None``: the stacked [P, ...] inputs on one device, all P
    partitions stepped by one process (``core/distributed.py``'s one-card
    grid is the precedent); the exchange is ``send.transpose(0, 1)``.

Either way one body computes the loss of the partitions it holds, and each
block aggregates their edges with one ``ops.csr_segment_sum`` call: kernel
7 on the card. The edges are sorted by (partition, destination) once a
call, padding last, as ``models/gnn.py`` sorts them.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.util import (cdiv, tree_flatten_with_path,
                                     tree_unflatten)
from repro_torch.config.base import GNNConfig
from repro_torch.kernels import ops
from repro_torch.kernels.segment_sum import PAD_SENTINEL
from repro_torch.models import layers as L
from repro_torch.models.gnn import _layer, _mlp

#: the batch's entries, in the reference's order
KEYS = ("node_feats", "edge_src", "edge_dst", "edge_feats", "send_idx",
        "node_targets", "node_mask")


def partitioned_input_specs(cfg: GNNConfig, shape, n_parts: int,
                            halo_per_pair: int = 16) -> dict:
    """``(shape, dtype)`` of each input of the partitioned layout, a
    leading P dim on each (the reference's seven entries)."""
    from repro_torch.models.api import _gnn_block_sizes

    n, e = _gnn_block_sizes(shape)
    nl, el = cdiv(n, n_parts), cdiv(e, n_parts)
    d_feat = shape.get("d_feat", cfg.in_node_dim)
    f32, i32 = torch.float32, torch.int32
    return {
        "node_feats": ((n_parts, nl, d_feat), f32),
        "edge_src": ((n_parts, el), i32),      # 0..nl+P*S-1 (ext index)
        "edge_dst": ((n_parts, el), i32),      # 0..nl-1, -1 pad
        "edge_feats": ((n_parts, el, cfg.in_edge_dim), f32),
        "send_idx": ((n_parts, n_parts, halo_per_pair), i32),
        "node_targets": ((n_parts, nl, cfg.out_dim), f32),
        "node_mask": ((n_parts, nl), torch.bool),
    }


def _local_loss(cfg: GNNConfig, params, nf, es, ed, ef, send_idx, targets,
                mask, exchange, psum) -> torch.Tensor:
    """The loss of G held partitions: nf [G, nl, Fn], es / ed [G, el],
    ef [G, el, Fe], send_idx [G, P, S], targets [G, nl, out], mask
    [G, nl]. ``exchange`` maps the send buffers [G, P, S, dh] to the
    received halos (the same shape; ``recv[g, q]`` is what partition q
    sent to g) and ``psum`` sums a scalar over every partition."""
    g, nl = nf.shape[:2]
    el = es.shape[1]
    n_peer, s = send_idx.shape[1:]
    n_ext = nl + n_peer * s
    dev = nf.device
    cdt = L._dtype(cfg.compute_dtype)

    # one order for the edges of all G partitions: by partition, then
    # destination, padding last: what kernel 7 takes
    e_ok = ed >= 0
    node0 = torch.arange(g, device=dev)[:, None] * nl
    order = torch.sort(torch.where(e_ok, ed + node0, PAD_SENTINEL).reshape(-1),
                       stable=True).indices
    part = torch.div(order, el, rounding_mode="floor")
    src, dst = es.reshape(-1)[order], ed.reshape(-1)[order]
    ok = e_ok.reshape(-1)[order]
    ef = ef.reshape(g * el, -1)[order].to(cdt)
    # the rows each edge reads: h_ext's at its source, h's at its
    # destination. A padding edge's message never reaches the loss, so its
    # rows are spread over the table (the reference reads row 0): the
    # gathers' backward adds the rows of one index one after another
    spread = torch.arange(g * el, device=dev)
    s_ext = torch.where(ok, part * n_ext + src.clamp(min=0),
                        spread % (g * n_ext)).long()
    d_own = torch.where(ok, part * nl + dst.clamp(min=0),
                        spread % (g * nl)).long()
    d_seg = torch.where(ok, part * nl + dst, -1)         # -1: dropped
    send_ok = (send_idx >= 0)[..., None]
    send_rows = torch.where(
        send_idx >= 0, node0[:, :, None] + send_idx,
        torch.arange(send_idx.numel(), device=dev).reshape(send_idx.shape)
        % (g * nl)).long()

    h = _mlp(params["node_enc"], nf.reshape(g * nl, -1).to(cdt))
    e = _mlp(params["edge_enc"], ef)
    dh = h.shape[-1]

    def block(i: int, h: torch.Tensor, e: torch.Tensor):
        # the halo exchange: each partition's boundary rows to its peers
        send = torch.where(send_ok, h[send_rows], 0)     # [G, P, S, dh]
        recv = exchange(send)
        h_ext = torch.cat([h.reshape(g, nl, dh),
                           recv.reshape(g, n_peer * s, dh)],
                          dim=1).reshape(g * n_ext, dh)
        msg_in = torch.cat([e, h_ext[s_ext], h[d_own]], dim=-1)
        e = e + _mlp(_layer(params["edge_mlp"], i), msg_in)
        agg = ops.csr_segment_sum(torch.where(ok[:, None], e, 0), d_seg,
                                  g * nl)
        h = h + _mlp(_layer(params["node_mlp"], i),
                     torch.cat([h, agg.to(cdt)], dim=-1))
        return h, e

    for i in range(cfg.n_layers):
        if cfg.remat and torch.is_grad_enabled():
            h, e = checkpoint(block, i, h, e, use_reentrant=False)
        else:
            h, e = block(i, h, e)
    pred = _mlp(params["decoder"], h).to(torch.float32)
    w = mask.reshape(-1).to(torch.float32)[:, None]
    tgt = targets.reshape(g * nl, -1).to(torch.float32)
    se = psum(((pred - tgt) ** 2 * w).sum())
    cnt = psum(w.sum() * pred.shape[-1])
    return se / torch.clamp(cnt, min=1.0)


class _AllReduceSum(torch.autograd.Function):
    """A scalar summed over the group. Every rank computes the same loss
    from the sum, so the gradient of each rank's term is the sum's own:
    the backward is the identity."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def _mesh_group(mesh):
    """The process group over every rank of ``mesh``, in the mesh's
    row-major order: the order in which a ``DTensor`` sharded on dim 0
    over every mesh dim lays out its partitions."""
    return (mesh if mesh.ndim == 1 else mesh._flatten()).get_group()


def _local_shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's partition of a batch entry: the local shard of a
    ``DTensor`` laid out on dim 0 over every mesh dim (redistributed so
    first where it is not), or a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    want = [Shard(0)] * mesh.ndim
    if list(x.placements) != want:
        x = x.redistribute(mesh, want)
    return x.to_local()


def _local_param(p: torch.Tensor, mesh) -> torch.Tensor:
    """A parameter as a local tensor whose gradient is this rank's part
    of the sum over ranks: a ``DTensor``'s gradient comes back
    ``Partial`` (a train step reduces it to the parameter's layout), a
    plain tensor's reduced over the ranks (an all-reduce)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    rep = [Replicate()] * mesh.ndim
    if not isinstance(p, DTensor):
        p = DTensor.from_local(p, mesh, rep, run_check=False)
    elif list(p.placements) != rep:
        p = p.redistribute(mesh, rep)
    return p.to_local(grad_placements=[Partial()] * mesh.ndim)


def partitioned_loss(cfg: GNNConfig, mesh=None):
    """``loss_fn(params, batch) -> (loss, {"loss": loss})``: owner-computes
    message passing over the partitions of ``batch`` (the entries of
    :func:`partitioned_input_specs`), ``params`` ``models.gnn.init_gnn``'s
    tree. The loss is the masked squared error summed over every
    partition, over the summed count.

    ``mesh`` a ``DeviceMesh``: one partition a rank, P the mesh's size
    (see the module's docstring). ``mesh=None``: the stacked [P, ...]
    inputs on one device."""

    def loss_fn(params, batch):
        if mesh is None:
            loss = _local_loss(cfg, params, *(batch[k] for k in KEYS),
                               exchange=lambda send: send.transpose(0, 1),
                               psum=lambda x: x)
            return loss, {"loss": loss}
        from torch.distributed import _functional_collectives as funcol

        group = _mesh_group(mesh)
        local = [_local_shard(batch[k], mesh) for k in KEYS]
        n_parts = local[KEYS.index("send_idx")].shape[1]
        if local[0].shape[0] != 1 or n_parts != mesh.size():
            raise ValueError(
                f"a mesh of {mesh.size()} ranks holds one partition a "
                f"rank: got {local[0].shape[0]} here of {n_parts}")

        def exchange(send):
            _, p, s, dh = send.shape
            # the result waits for the collective where it is first read
            recv = funcol.all_to_all_single_autograd(
                send.reshape(p * s, dh), None, None, group)
            return recv.reshape(1, p, s, dh)

        paths, treedef = tree_flatten_with_path(params)
        p_local = tree_unflatten(treedef, [_local_param(p, mesh)
                                           for _, p in paths])
        loss = _local_loss(cfg, p_local, *local, exchange=exchange,
                           psum=lambda x: _AllReduceSum.apply(x, group))
        return loss, {"loss": loss}

    return loss_fn

