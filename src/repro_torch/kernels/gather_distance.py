"""Wrapper of the CUDA gather + distance kernel (``csrc/gather_distance.cu``).

Replaces the TPU kernels ``repro/kernels/gather_distance.py::
gather_distance_batch_pallas`` (:func:`gather_distance_batch`) and
``gather_distance_pallas`` (:func:`gather_distance`, a one-lane launch of
the same kernel). The kernel runs in two schedules, which :func:`plan`
picks by grid size: ``"tiled"`` (a block per lane and tile of 64
candidates) where that grid fills the card, ``"spread"`` (a warp per
candidate) below it. Both sum a row in one order, so the single-query
oracle and the batched engine agree bit for bit; the source note in the
``.cu`` file gives the kernel's bound and design. The plain PyTorch
versions are ``kernels/ref.py::gather_distance_batch`` and
``gather_distance``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`gather_distance_batch` in this process
LAUNCHES = 0
#: one-lane launches made by :func:`gather_distance` in this process
ONE_LANE_LAUNCHES = 0
#: the launches of both entries, by schedule
PATH_LAUNCHES = {"tiled": 0, "spread": 0}

#: the least share of the card's SMs that the tiled grid must have blocks
#: for. On an H100 (cold rows, d = 960; PERF.md) the spread schedule is
#: faster for one lane (3.15x at K = 64) and ties the tiled one at B = 1024
#: (1.01x at K = 64); the tiled one is faster at the build's full morsels
#: (1.10-1.11x at B = 2048, K = 40 to 72; 1.31x at B = 65,536, K = 72).
#: At the SM count the batched search (B = 1024) and the full morsels run
#: tiled
TILED_MIN_SHARE = 1.0


def _kernel():
    return _build.bind("gather_distance", "navix_gather_distance_batch_f32",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7)


def plan(bsz: int, k: int, d: int, sm_count: int,
         *ptrs: int) -> tuple[str, bool]:
    """(schedule, 16-byte loads) of a launch over Q[bsz, d] and ids[bsz, k]
    on a card of ``sm_count`` SMs: ``_build.schedule`` at
    :data:`TILED_MIN_SHARE`; 16-byte loads when d % 4 == 0 and every
    pointer in ``ptrs`` (Q's, the vectors') is 16-byte aligned."""
    vec = d % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    return _build.schedule(bsz, k, sm_count, TILED_MIN_SHARE), vec


def gather_distance_batch(Q: torch.Tensor, vectors: torch.Tensor,
                          ids: torch.Tensor, metric: str) -> torch.Tensor:
    """f32[B, K] = dist(Q[b], vectors[ids[b, j]]) on the CUDA device.

    Q f32[B, d], vectors f32[n, d], ids int32[B, K], all contiguous and on
    one CUDA device; ids < 0 give +inf, ids >= n read row n-1. Launches on
    the current stream and raises if the launch fails.
    """
    global LAUNCHES
    out, launched = _launch(Q, vectors, ids, metric)
    LAUNCHES += launched
    return out


def gather_distance(q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """f32[K] = dist(q, vectors[ids[j]]): one lane of the batched kernel."""
    global ONE_LANE_LAUNCHES
    if q.ndim != 1 or ids.ndim != 1:
        raise ValueError("expected q[d] and ids[K]")
    out, launched = _launch(q[None, :], vectors, ids[None, :], metric)
    ONE_LANE_LAUNCHES += launched
    return out[0]


def _launch(Q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor,
            metric: str, schedule: str | None = None
            ) -> tuple[torch.Tensor, bool]:
    """Check the inputs, launch the kernel on the schedule :func:`plan`
    picks (or on ``schedule``, which only measurements name); (out,
    whether it launched)."""
    _build.check_cuda_inputs("gather_distance_batch", Q=Q, vectors=vectors,
                             ids=ids)
    if Q.dtype != torch.float32 or vectors.dtype != torch.float32:
        raise TypeError(f"Q and vectors must be float32, got {Q.dtype} and "
                        f"{vectors.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if Q.ndim != 2 or vectors.ndim != 2 or ids.ndim != 2:
        raise ValueError("expected Q[B, d], vectors[n, d], ids[B, K]")
    (bsz, d), (n, dv), (bi, k) = Q.shape, vectors.shape, ids.shape
    if dv != d or bi != bsz:
        raise ValueError(f"shape mismatch: Q{tuple(Q.shape)}, "
                         f"vectors{tuple(vectors.shape)}, ids{tuple(ids.shape)}")
    if n == 0 or d == 0:
        raise ValueError("vectors must hold at least one row of width > 0")
    if max(bsz, k, n, d) > _build.INT32_MAX:
        raise ValueError("a dimension exceeds the kernel's int32 range")
    if metric not in _build.METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")
    out = torch.empty((bsz, k), dtype=torch.float32, device=Q.device)
    if bsz == 0 or k == 0:
        return out, False
    picked, vec = plan(bsz, k, d, _build.sm_count(Q.device), Q.data_ptr(),
                       vectors.data_ptr())
    schedule = schedule or picked
    _build.launch("gather_distance_batch", _kernel(), Q.device, Q.data_ptr(),
                  vectors.data_ptr(), ids.data_ptr(), out.data_ptr(), bsz, k,
                  n, d, _build.METRIC_CODE[metric], _build.SCHEDULE_CODE[schedule],
                  int(vec))
    PATH_LAUNCHES[schedule] += 1
    return out, True
