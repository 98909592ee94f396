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
