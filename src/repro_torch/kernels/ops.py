"""Dispatch layer (port of ``repro.kernels.ops``): routes by the tensor's
device.

A CUDA tensor launches the hand-written CUDA kernel or the call raises.
A CPU tensor runs the kernel's plain PyTorch version (``kernels/ref.py``);
tensors lie on the CPU only when a caller asked for ``device="cpu"``.
Under a sharding policy (``autoshard.activation_sharding``: the dry
run's) a ``meta`` tensor, which holds shapes without data, takes the
plain version too, which computes only its output's shape. There is no
other path. The single-query entries are one-lane launches of
the batched kernels, so the single-query oracle and the batched engine
sum in one order on either device.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.autoshard import sharded
from repro_torch.kernels import distance_matrix as matrix_kernel
from repro_torch.kernels import gather_distance as f32_kernel
from repro_torch.kernels import quantized as int8_matrix_kernel
from repro_torch.kernels import quantized_gather_distance as int8_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as segment_kernel


def _device(name: str, *tensors: torch.Tensor) -> str:
    """The one device type of ``tensors``; raises when they differ or when
    the port has no path for it."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"the inputs of {name} lie on different devices "
                         f"({', '.join(str(t.device) for t in tensors)})")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu") and not (dev.type == "meta"
                                                and sharded()):
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


def distance_matrix(Q: torch.Tensor, X: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """All-pairs distances dist(Q[b], X[n]). f32[b, n]; Q and X are taken
    as f32."""
    if _device("distance_matrix", Q, X) == "cuda":
        return matrix_kernel.distance_matrix(
            Q.to(torch.float32).contiguous(),
            X.to(torch.float32).contiguous(), metric)
    return ref.distance_matrix(Q, X, metric)


def quantized_distance_matrix(Q: torch.Tensor, codes: torch.Tensor,
                              scale: torch.Tensor,
                              metric: str = "l2") -> torch.Tensor:
    """Distances against int8 codes with per-row scales. f32[b, n]."""
    if _device("quantized_distance_matrix", Q, codes, scale) == "cuda":
        return int8_matrix_kernel.quantized_distance_matrix(
            Q.to(torch.float32).contiguous(), codes.contiguous(),
            scale.to(torch.float32).contiguous(), metric)
    return ref.quantized_distance_matrix(Q, codes, scale, metric)


def csr_segment_sum(messages: torch.Tensor, dst_sorted: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Sorted segment sum -> f32[n, d]. messages[E, d] of any float type
    (summed in f32), dst_sorted[E] ascending; -1 padding is allowed only
    where it sorts as if it were +inf (callers put it at the end): it is
    mapped to ``PAD_SENTINEL``.

    Differentiable in ``messages``: when they require a gradient the call
    goes through :class:`SegmentSum`, whose forward is this same dispatch
    and whose backward is a gather."""
    if messages.requires_grad:
        return SegmentSum.apply(messages, dst_sorted, n)
    return _segment_sum(messages, dst_sorted, n)


def _segment_sum(messages: torch.Tensor, dst_sorted: torch.Tensor,
                 n: int) -> torch.Tensor:
    if _device("csr_segment_sum", messages, dst_sorted) == "cuda":
        dst = torch.where(dst_sorted < 0, segment_kernel.PAD_SENTINEL,
                          dst_sorted).to(torch.int32)
        return segment_kernel.csr_segment_sum(
            messages.to(torch.float32).contiguous(), dst.contiguous(), n)
    return ref.csr_segment_sum(messages, dst_sorted, n)


class SegmentSum(torch.autograd.Function):
    """The segment sum with its gradient. Forward: the dispatch above
    (kernel 7 on a CUDA tensor, its plain version on a CPU one). Backward:
    ``grad_messages[e] = grad_out[dst[e]]`` where ``0 <= dst[e] < n``, else
    0, in the messages' dtype: the transpose of a segment sum is a gather,
    as ``jax.ops.segment_sum``'s is, and the TPU package has no backward
    kernel, so neither has the port."""

    @staticmethod
    def forward(ctx, messages: torch.Tensor, dst_sorted: torch.Tensor,
                n: int) -> torch.Tensor:
        ctx.save_for_backward(dst_sorted)
        ctx.n = n
        ctx.msg_dtype = messages.dtype
        return _segment_sum(messages, dst_sorted, n)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        (dst,) = ctx.saved_tensors
        ok = (dst >= 0) & (dst < ctx.n)
        g = grad_out[torch.where(ok, dst, 0).long()]
        g = torch.where(ok[:, None], g, 0)
        return g.to(ctx.msg_dtype), None, None
