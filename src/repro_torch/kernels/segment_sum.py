"""Wrapper of the CUDA CSR segment sum (``csrc/segment_sum.cu``).

Replaces the TPU kernel ``repro/kernels/segment_sum.py::
csr_segment_sum_pallas``; the source note in the ``.cu`` file gives the
kernel's bound and design. The plain PyTorch version is
``kernels/ref.py::csr_segment_sum``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: padding destination id: sorts after every real node id (callers replace
#: -1 with it before sorting)
PAD_SENTINEL = 0x3FFFFFFF

#: kernel launches made by :func:`csr_segment_sum` in this process
LAUNCHES = 0


def _kernel():
    return _build.bind("segment_sum", "navix_csr_segment_sum",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)


def row_pointers(dst_sorted: torch.Tensor, n: int) -> torch.Tensor:
    """int64[n + 1]: row_ptr[v] = the first edge whose destination is >= v
    (the tile plan of the TPU kernel, as CSR row pointers; entries at or
    past row_ptr[n] are padding)."""
    nodes = torch.arange(n + 1, dtype=dst_sorted.dtype,
                         device=dst_sorted.device)
    return torch.searchsorted(dst_sorted, nodes)


def csr_segment_sum(messages: torch.Tensor, dst_sorted: torch.Tensor,
                    n: int) -> torch.Tensor:
    """f32[n, d]: out[v] = sum of messages[e] with dst_sorted[e] == v, on the
    CUDA device.

    messages f32[E, d] and dst_sorted int32[E] (ascending, padding as
    ``PAD_SENTINEL``), contiguous and on one CUDA device. Launches on the
    current stream and raises if the launch fails.
    """
    global LAUNCHES
    _build.check_cuda_inputs("csr_segment_sum", messages=messages,
                      dst_sorted=dst_sorted)
    if messages.dtype != torch.float32:
        raise TypeError(f"messages must be float32, got {messages.dtype}")
    if dst_sorted.dtype != torch.int32:
        raise TypeError(f"dst_sorted must be int32, got {dst_sorted.dtype}")
    if messages.ndim != 2 or dst_sorted.shape != (messages.shape[0],):
        raise ValueError(f"expected messages[E, d] and dst_sorted[E], got "
                         f"{tuple(messages.shape)} and "
                         f"{tuple(dst_sorted.shape)}")
    d = messages.shape[1]
    if not 0 <= n < PAD_SENTINEL or d > _build.INT32_MAX:
        raise ValueError(f"n = {n} or d = {d} is outside the kernel's range")
    out = torch.empty((n, d), dtype=torch.float32, device=messages.device)
    if n == 0 or d == 0:
        return out
    row_ptr = row_pointers(dst_sorted, n)
    _build.launch("csr_segment_sum", _kernel(), messages.device,
                  messages.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n,
                  d)
    LAUNCHES += 1
    return out
