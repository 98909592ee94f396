"""Plain PyTorch versions of the port's kernels (the correctness contracts).

Each function here computes what its CUDA kernel computes, with the same
elementwise forms as ``repro/kernels/ref.py``. The CPU path of the
dispatch layer (``kernels/ops.py``) runs them, the CPU tests hold them
against the reference package, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""

from __future__ import annotations

import torch


def gather_distance(q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """f32[k]: dist(q, vectors[ids]); ids < 0 -> +inf, ids clamped to n-1."""
    return gather_distance_batch(q[None, :], vectors, ids[None, :], metric)[0]


def gather_distance_batch(Q: torch.Tensor, vectors: torch.Tensor,
                          ids: torch.Tensor, metric: str) -> torch.Tensor:
    """f32[b, k]: dist(Q[b], vectors[ids[b]]); ids < 0 -> +inf.

    ids are clamped into ``[0, n-1]`` before the gather (ids >= n read row
    n-1, as the reference's clamping gather does).
    """
    safe = ids.clamp(0, vectors.shape[0] - 1).long()
    return _dist_rows(Q, vectors[safe].to(torch.float32), ids, metric)


def quantized_gather_distance(q: torch.Tensor, codes: torch.Tensor,
                              scale: torch.Tensor, ids: torch.Tensor,
                              metric: str) -> torch.Tensor:
    """f32[k]: dist(q, scale[ids] * codes[ids]); ids < 0 -> +inf."""
    return quantized_gather_distance_batch(q[None, :], codes, scale,
                                           ids[None, :], metric)[0]


def quantized_gather_distance_batch(Q: torch.Tensor, codes: torch.Tensor,
                                    scale: torch.Tensor, ids: torch.Tensor,
                                    metric: str) -> torch.Tensor:
    """f32[b, k]: dist(Q[b], scale[ids[b]] * codes[ids[b]]); ids < 0 ->
    +inf, ids clamped into ``[0, n-1]``.

    Each gathered row is dequantized first (an f32 product per element),
    then the same distance form as :func:`gather_distance_batch`.
    """
    safe = ids.clamp(0, codes.shape[0] - 1).long()
    rows = (codes[safe].to(torch.float32)
            * scale[safe].to(torch.float32)[..., None])          # [b, k, d]
    return _dist_rows(Q, rows, ids, metric)


def _dist_rows(Q: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
               metric: str) -> torch.Tensor:
    """dist(Q[b], rows[b, j]) over gathered f32 rows [b, k, d]; ids < 0 ->
    +inf."""
    Qf = Q.to(torch.float32)[:, None, :]
    if metric == "l2":
        diff = rows - Qf
        d = torch.sum(diff * diff, dim=-1)
    elif metric == "cos":
        d = 1.0 - torch.sum(rows * Qf, dim=-1)
    elif metric == "dot":
        d = -torch.sum(rows * Qf, dim=-1)
    else:
        raise ValueError(metric)
    return torch.where(ids >= 0, d, torch.inf)


def distance_matrix(Q: torch.Tensor, X: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """f32[b, n]: all-pairs distances (``repro/kernels/ref.py::
    distance_matrix``): l2 ||q||^2 + ||x||^2 - 2 q.x, cos 1 - q.x, dot
    -q.x, products in f32."""
    Qf = Q.to(torch.float32)
    Xf = X.to(torch.float32)
    dots = Qf @ Xf.T
    if metric == "l2":
        return (torch.sum(Qf * Qf, -1)[:, None]
                + torch.sum(Xf * Xf, -1)[None, :] - 2.0 * dots)
    if metric == "cos":
        return 1.0 - dots
    if metric == "dot":
        return -dots
    raise ValueError(metric)


def quantized_distance_matrix(Q: torch.Tensor, codes: torch.Tensor,
                              scale: torch.Tensor,
                              metric: str) -> torch.Tensor:
    """f32[b, n]: distances to x = scale * codes, dequantized first and then
    :func:`distance_matrix` (as the reference does)."""
    X = codes.to(torch.float32) * scale[:, None].to(torch.float32)
    return distance_matrix(Q, X, metric)


def csr_segment_sum(messages: torch.Tensor, dst_sorted: torch.Tensor,
                    n: int) -> torch.Tensor:
    """f32[n, d]: out[v] = sum of messages whose destination is v.

    Entries with a destination outside ``[0, n)`` (-1 padding, the
    sentinel) are dropped: they are summed into a row n that is sliced
    off, as the reference's ``segment_sum`` over n + 1 segments does.

    ``DTensor`` messages (the dry run's) are summed by :func:`_sharded`.
    """
    if type(messages) is not torch.Tensor and _is_dtensor(messages):
        return _sharded(messages, dst_sorted, n)
    safe = torch.where((dst_sorted >= 0) & (dst_sorted < n), dst_sorted, n)
    out = messages.new_zeros((n + 1, messages.shape[1]), dtype=torch.float32)
    out.index_add_(0, safe.long(), messages.to(torch.float32))
    return out[:n]


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: the rows of ``table`` [n, d] at int64 ``idx`` [E].
    Where ``idx`` is a ``DTensor`` (the dry run's edges, laid out over the
    chips), each chip takes its own indices' rows from the table gathered
    whole (GSPMD's replicated nodes), the rows laid out as ``idx`` is; the
    table's gradient comes back ``Partial``, each chip's rows' part.
    (``DTensor`` 2.11 has no rule for an index sharded over two mesh
    dims.)"""
    if type(idx) is torch.Tensor or not _is_dtensor(idx):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = idx.device_mesh
    rep = [Replicate()] * mesh.ndim
    if isinstance(table, DTensor):
        whole = table.redistribute(mesh, rep).to_local(
            grad_placements=[Partial()] * mesh.ndim)
    else:
        whole = table
    rows = whole[idx.to_local()]
    shape = torch.Size((idx.shape[0],) + tuple(table.shape[1:]))
    stride = tuple(int(torch.Size(shape[i + 1:]).numel())
                   for i in range(len(shape)))
    return DTensor.from_local(rows, mesh, idx.placements, run_check=False,
                              shape=shape, stride=stride)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sharded(messages, dst_sorted, n: int):
    """The segment sum of ``DTensor`` messages, as GSPMD partitions a
    scatter-add: each chip sums its own rows into an [n, d] aggregate,
    and the aggregate is ``Partial`` (summed over the chips) on each mesh
    dim that splits the rows, Shard(k) where the messages are (a feature
    dim), else as the messages are. The destinations are laid out as the
    rows first. (``DTensor`` has no rule for ``index_add_``.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = messages.device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in messages.placements]
    if list(dst_sorted.placements) != rows:
        dst_sorted = dst_sorted.redistribute(mesh, rows)
    local = csr_segment_sum(messages.to_local(), dst_sorted.to_local(), n)
    out = [Partial() if p == Shard(0) else p for p in messages.placements]
    d = messages.shape[1]
    return DTensor.from_local(local, mesh, out, run_check=False,
                              shape=torch.Size((n, d)), stride=(d, 1))
