"""Wrapper of the CUDA int8 gather + distance kernel
(``csrc/quantized_gather_distance.cu``).

Replaces the TPU kernels ``repro/kernels/gather_distance.py::
quantized_gather_distance_batch_pallas`` (:func:`quantized_gather_distance_batch`)
and ``quantized_gather_distance_pallas`` (:func:`quantized_gather_distance`,
a one-lane launch of the same kernel). As for the f32 kernel, :func:`plan`
picks the ``"tiled"`` schedule where its grid has blocks for 3/4 of the
card's SMs and the ``"spread"`` one (a warp per candidate) below; both sum
a row in one order, so the single-query oracle and the batched engine
agree bit for bit. The source note in the ``.cu`` file gives the kernel's bound and
design. The plain PyTorch versions are
``kernels/ref.py::quantized_gather_distance_batch`` and
``quantized_gather_distance``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`quantized_gather_distance_batch` in this
#: process
LAUNCHES = 0
#: one-lane launches made by :func:`quantized_gather_distance` in this process
ONE_LANE_LAUNCHES = 0
#: the launches of both entries, by schedule
PATH_LAUNCHES = {"tiled": 0, "spread": 0}

#: codes a 16-byte load carries (``kChunk`` in the source)
CHUNK = 16
#: the least share of the card's SMs that the tiled grid must have blocks
#: for (see ``_build.schedule``): on an H100 at K = 64 the spread schedule
#: was about 1.2x faster at B = 64 and the tiled one about 1.2x faster at
#: B = 128 (cold rows, PERF.md), so the switch sits between them
TILED_MIN_SHARE = 0.75


def _kernel():
    return _build.bind("quantized_gather_distance",
                       "navix_quantized_gather_distance_batch",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7)


def plan(bsz: int, k: int, d: int, sm_count: int,
         *ptrs: int) -> tuple[str, bool]:
    """(schedule, 16-byte loads) of a launch over Q[bsz, d] and ids[bsz, k]
    on a card of ``sm_count`` SMs: ``_build.schedule`` at
    :data:`TILED_MIN_SHARE`; 16-byte loads when d % 16 == 0 and every
    pointer in ``ptrs`` (Q's, the codes') is 16-byte aligned."""
    vec = d % CHUNK == 0 and all(p % 16 == 0 for p in ptrs)
    return _build.schedule(bsz, k, sm_count, TILED_MIN_SHARE), vec


def quantized_gather_distance_batch(Q: torch.Tensor, codes: torch.Tensor,
                                    scale: torch.Tensor, ids: torch.Tensor,
                                    metric: str) -> torch.Tensor:
    """f32[B, K] = dist(Q[b], scale[id] * codes[id]), id = ids[b, j], on the
    CUDA device.

    Q f32[B, d], codes int8[n, d], scale f32[n], ids int32[B, K], all
    contiguous and on one CUDA device; ids < 0 give +inf, ids >= n read row
    n-1. Launches on the current stream and raises if the launch fails.
    """
    global LAUNCHES
    out, launched = _launch(Q, codes, scale, ids, metric)
    LAUNCHES += launched
    return out


def quantized_gather_distance(q: torch.Tensor, codes: torch.Tensor,
                              scale: torch.Tensor, ids: torch.Tensor,
                              metric: str) -> torch.Tensor:
    """f32[K] = dist(q, scale[id] * codes[id]): one lane of the batched
    kernel."""
    global ONE_LANE_LAUNCHES
    if q.ndim != 1 or ids.ndim != 1:
        raise ValueError("expected q[d] and ids[K]")
    out, launched = _launch(q[None, :], codes, scale, ids[None, :], metric)
    ONE_LANE_LAUNCHES += launched
    return out[0]


def _launch(Q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
            ids: torch.Tensor, metric: str, schedule: str | None = None
            ) -> tuple[torch.Tensor, bool]:
    """Check the inputs, launch the kernel on the schedule :func:`plan`
    picks (or on ``schedule``, which only measurements name); (out,
    whether it launched)."""
    if Q.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"Q and scale must be float32, got {Q.dtype} and "
                        f"{scale.dtype}")
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    _build.check_cuda_inputs("quantized_gather_distance_batch", Q=Q,
                             codes=codes, scale=scale, ids=ids)
    if Q.ndim != 2 or codes.ndim != 2 or scale.ndim != 1 or ids.ndim != 2:
        raise ValueError("expected Q[B, d], codes[n, d], scale[n], ids[B, K]")
    (bsz, d), (n, dc), (bi, k) = Q.shape, codes.shape, ids.shape
    if dc != d or bi != bsz or scale.shape[0] != n:
        raise ValueError(f"shape mismatch: Q{tuple(Q.shape)}, "
                         f"codes{tuple(codes.shape)}, "
                         f"scale{tuple(scale.shape)}, ids{tuple(ids.shape)}")
    if n == 0 or d == 0:
        raise ValueError("codes must hold at least one row of width > 0")
    if max(bsz, k, n, d) > _build.INT32_MAX:
        raise ValueError("a dimension exceeds the kernel's int32 range")
    if metric not in _build.METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")
    out = torch.empty((bsz, k), dtype=torch.float32, device=Q.device)
    if bsz == 0 or k == 0:
        return out, False
    picked, vec = plan(bsz, k, d, _build.sm_count(Q.device), Q.data_ptr(),
                       codes.data_ptr())
    schedule = schedule or picked
    _build.launch("quantized_gather_distance_batch", _kernel(), Q.device,
                  Q.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                  ids.data_ptr(), out.data_ptr(), bsz, k, n, d,
                  _build.METRIC_CODE[metric],
                  _build.SCHEDULE_CODE[schedule], int(vec))
    PATH_LAUNCHES[schedule] += 1
    return out, True
