"""Dispatch layer (port of ``repro.kernels.ops``): routes by the tensor's
device.

A CUDA tensor launches the hand-written CUDA kernel or the call raises.
A CPU tensor runs the kernel's plain PyTorch version (``kernels/ref.py``);
tensors lie on the CPU only when a caller asked for ``device="cpu"``.
There is no other path. The single-query entries are one-lane launches of
the batched kernels, so the single-query oracle and the batched engine
sum in one order on either device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import gather_distance as f32_kernel
from repro_torch.kernels import quantized_gather_distance as int8_kernel
from repro_torch.kernels import ref


def _device(name: str, *tensors: torch.Tensor) -> str:
    """The one device type of ``tensors``; raises when they differ or when
    the port has no path for it."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"the inputs of {name} lie on different devices "
                         f"({', '.join(str(t.device) for t in tensors)})")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no {name} path for device {dev}")
    return dev.type


def gather_distance_batch(Q: torch.Tensor, vectors: torch.Tensor,
                          ids: torch.Tensor, metric: str = "l2"
                          ) -> torch.Tensor:
    """Batched fused gather+distance: dist(Q[b], vectors[ids[b]]). f32[B, K].

    ids < 0 -> +inf; ids are clamped into [0, n-1] before any read.
    """
    if _device("gather_distance_batch", Q, vectors, ids) == "cuda":
        return f32_kernel.gather_distance_batch(
            Q.contiguous(), vectors, ids.contiguous(), metric)
    return ref.gather_distance_batch(Q, vectors, ids, metric)


def gather_distance(q: torch.Tensor, vectors: torch.Tensor,
                    ids: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Single-query fused gather+distance: dist(q, vectors[ids]). f32[K]."""
    if _device("gather_distance", q, vectors, ids) == "cuda":
        return f32_kernel.gather_distance(q.contiguous(), vectors,
                                          ids.contiguous(), metric)
    return ref.gather_distance(q, vectors, ids, metric)


def quantized_gather_distance_batch(Q: torch.Tensor, codes: torch.Tensor,
                                    scale: torch.Tensor, ids: torch.Tensor,
                                    metric: str = "l2") -> torch.Tensor:
    """Batched int8 gather+distance: dist(Q[b], scale[ids[b]] *
    codes[ids[b]]). f32[B, K]; the int8-resident engine's primitive."""
    if _device("quantized_gather_distance_batch", Q, codes, scale,
               ids) == "cuda":
        return int8_kernel.quantized_gather_distance_batch(
            Q.contiguous(), codes, scale, ids.contiguous(), metric)
    return ref.quantized_gather_distance_batch(Q, codes, scale, ids, metric)


def quantized_gather_distance(q: torch.Tensor, codes: torch.Tensor,
                              scale: torch.Tensor, ids: torch.Tensor,
                              metric: str = "l2") -> torch.Tensor:
    """Single-query int8 gather+distance: dist(q, scale[ids] * codes[ids]).
    f32[K]."""
    if _device("quantized_gather_distance", q, codes, scale, ids) == "cuda":
        return int8_kernel.quantized_gather_distance(
            q.contiguous(), codes, scale, ids.contiguous(), metric)
    return ref.quantized_gather_distance(q, codes, scale, ids, metric)
