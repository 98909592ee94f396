"""Dispatch layer (port of ``repro.kernels.ops``): routes by the tensor's
device.

A CUDA tensor launches the hand-written CUDA kernel or the call raises.
A CPU tensor runs the kernel's plain PyTorch version (``kernels/ref.py``);
tensors lie on the CPU only when a caller asked for ``device="cpu"``.
There is no other path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import gather_distance, ref


def gather_distance_batch(Q: torch.Tensor, vectors: torch.Tensor,
                          ids: torch.Tensor, metric: str = "l2"
                          ) -> torch.Tensor:
    """Batched fused gather+distance: dist(Q[b], vectors[ids[b]]). f32[B, K].

    ids < 0 -> +inf; ids are clamped into [0, n-1] before any read.
    """
    dev = vectors.device
    if Q.device != dev or ids.device != dev:
        raise ValueError(f"Q, vectors and ids lie on different devices "
                         f"({Q.device}, {dev}, {ids.device})")
    if dev.type == "cuda":
        return gather_distance.gather_distance_batch(
            Q.contiguous(), vectors, ids.contiguous(), metric)
    if dev.type == "cpu":
        return ref.gather_distance_batch(Q, vectors, ids, metric)
    raise ValueError(f"no gather_distance_batch path for device {dev}")
