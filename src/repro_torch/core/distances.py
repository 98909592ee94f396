"""Distance functions (port of ``repro.core.distances``).

All distances are smaller-is-closer:
  l2   -- squared Euclidean distance
  cos  -- 1 - dot over vectors normalized at ingest
  dot  -- negative inner product

``point_dist`` is an elementwise product plus a last-axis sum, the one
reduction form of the port's plain path (the reference keeps one form so
its single-query and batched engines agree bitwise). The search engines
reach distances through the gather-distance entries of
``repro_torch.kernels.ops`` (f32 or int8), which run the CUDA kernels for
CUDA tensors and the same elementwise forms (``kernels/ref.py``) for CPU
tensors; the functions here serve the build's pruning, the exact re-rank
and the oracles.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import QuantizedStore

VALID_METRICS = ("l2", "cos", "dot")


def validate_metric(metric: str) -> None:
    if metric not in VALID_METRICS:
        raise ValueError(f"unknown metric {metric!r}; valid: {VALID_METRICS}")


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def point_dist(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """dist(q[..., d], x[..., d]) -> [...] (q broadcasts against x)."""
    if metric == "l2":
        diff = x - q
        return torch.sum(diff * diff, dim=-1)
    if metric == "cos":
        return 1.0 - torch.sum(x * q, dim=-1)
    if metric == "dot":
        return -torch.sum(x * q, dim=-1)
    raise ValueError(metric)


def gather_rows(vectors: torch.Tensor | QuantizedStore,
                ids: torch.Tensor) -> torch.Tensor:
    """f32 rows ``vectors[ids]`` with ids clamped into ``[0, n-1]`` (the
    reference's gather clamps out-of-range ids; torch indexing would raise).

    For a :class:`QuantizedStore` each gathered row is dequantized,
    ``codes[ids] * scale[ids]``: elementwise what a gather from
    ``dequantize(store)`` gives, with no ``[n, d]`` f32 buffer made.
    """
    safe = ids.clamp(0, vectors.shape[0] - 1).long()
    if isinstance(vectors, QuantizedStore):
        return (vectors.codes[safe].to(torch.float32)
                * vectors.scale[safe][..., None])
    return vectors[safe]


def gathered_dist(q: torch.Tensor, vectors: torch.Tensor | QuantizedStore,
                  ids: torch.Tensor, metric: str) -> torch.Tensor:
    """dist(q, vectors[ids]) with ids < 0 padding -> +inf."""
    d = point_dist(q, gather_rows(vectors, ids), metric)
    return torch.where(ids >= 0, d, torch.inf)


def gathered_dist_batch(Q: torch.Tensor,
                        vectors: torch.Tensor | QuantizedStore,
                        ids: torch.Tensor, metric: str) -> torch.Tensor:
    """Rowwise gather+distance: dist(Q[b], vectors[ids[b]]) -> f32[B, K]."""
    d = point_dist(Q[:, None, :], gather_rows(vectors, ids), metric)
    return torch.where(ids >= 0, d, torch.inf)


def dist_matrix(Q: torch.Tensor, X: torch.Tensor, metric: str) -> torch.Tensor:
    """All-pairs distances: Q[..., b, d], X[..., n, d] -> [..., b, n].

    L2 uses the matmul decomposition ||q||^2 + ||x||^2 - 2 q.x, as the
    reference does. Leading dims batch (one matrix per build lane).
    """
    dots = Q @ X.transpose(-1, -2)
    if metric == "l2":
        qq = torch.sum(Q * Q, dim=-1)[..., :, None]
        xx = torch.sum(X * X, dim=-1)[..., None, :]
        return qq + xx - 2.0 * dots
    if metric == "cos":
        return 1.0 - dots
    if metric == "dot":
        return -dots
    raise ValueError(metric)


def brute_force_topk(Q: torch.Tensor, X: torch.Tensor, k: int, metric: str,
                     mask: torch.Tensor | None = None):
    """Exact (filtered) kNN oracle. mask: bool[n] selected set; None = all.

    Returns (dists[b, k], ids[b, k]) ascending; ties keep the lower index
    first (a stable sort, as ``lax.top_k`` orders them); unselected rows
    never appear (padded with +inf / -1 when |S| < k).
    """
    d = dist_matrix(Q, X, metric)
    if mask is not None:
        d = torch.where(mask[None, :], d, torch.inf)
    dists, idx = torch.sort(d, dim=1, stable=True)
    dists, idx = dists[:, :k], idx[:, :k]
    ids = torch.where(torch.isfinite(dists), idx, -1).to(torch.int32)
    return dists, ids
