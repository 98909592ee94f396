"""Wrapper of the CUDA all-pairs int8 distance kernel
(``csrc/quantized_distance.cu``).

Replaces the TPU kernel ``repro/kernels/quantized.py::
quantized_distance_pallas``; the source note in the ``.cu`` file gives the
kernel's bound and design. The plain PyTorch version is
``kernels/ref.py::quantized_distance_matrix``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_matrix import check_pairs_shapes

#: kernel launches made by :func:`quantized_distance_matrix` in this process
LAUNCHES = 0


def _kernel():
    return _build.bind("quantized_distance", "navix_quantized_distance",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)


def quantized_distance_matrix(Q: torch.Tensor, codes: torch.Tensor,
                              scale: torch.Tensor,
                              metric: str) -> torch.Tensor:
    """f32[b, n] = dist(Q[b], scale[n] * codes[n]) on the CUDA device.

    Q f32[b, d], codes int8[n, d], scale f32[n], all contiguous and on one
    CUDA device. Launches on the current stream and raises if the launch
    fails.
    """
    global LAUNCHES
    _build.check_cuda_inputs("quantized_distance_matrix", Q=Q, codes=codes,
                      scale=scale)
    check_pairs_shapes(Q, codes, metric)
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if scale.dtype != torch.float32 or scale.shape != (codes.shape[0],):
        raise ValueError(f"scale must be float32[{codes.shape[0]}], got "
                         f"{scale.dtype}{tuple(scale.shape)}")
    (b, d), n = Q.shape, codes.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=Q.device)
    if b == 0 or n == 0:
        return out
    _build.launch("quantized_distance_matrix", _kernel(), Q.device,
                  Q.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), b, n, d, _build.METRIC_CODE[metric])
    LAUNCHES += 1
    return out
