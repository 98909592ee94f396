"""Wrapper of the CUDA all-pairs distance kernel (``csrc/distance_matrix.cu``).

Replaces the TPU kernel ``repro/kernels/distance_matrix.py::
distance_matrix_pallas``; the source note in the ``.cu`` file gives the
kernel's bound and design. The plain PyTorch version is
``kernels/ref.py::distance_matrix``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`distance_matrix` in this process
LAUNCHES = 0

#: the kernel's grid holds at most 65535 tiles of 16 query rows along b
MAX_BATCH = 65535 * 16


def _kernel():
    return _build.bind("distance_matrix", "navix_distance_matrix_f32",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4)


def check_pairs_shapes(Q: torch.Tensor, X: torch.Tensor, metric: str) -> None:
    """Raise unless Q[b, d] and X[n, d] fit the tiled kernel's ranges."""
    if Q.dtype != torch.float32:
        raise TypeError(f"Q must be float32, got {Q.dtype}")
    if Q.ndim != 2 or X.ndim != 2 or Q.shape[1] != X.shape[1]:
        raise ValueError(f"expected Q[b, d] and X[n, d], got shapes "
                         f"{tuple(Q.shape)} and {tuple(X.shape)}")
    if Q.shape[1] == 0:
        raise ValueError("rows must have a width > 0")
    if (max(X.shape[0], Q.shape[1]) > _build.INT32_MAX
            or Q.shape[0] > MAX_BATCH):
        raise ValueError("a dimension exceeds the kernel's range")
    if metric not in _build.METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")


def distance_matrix(Q: torch.Tensor, X: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """f32[b, n] = dist(Q[b], X[n]) on the CUDA device.

    Q f32[b, d], X f32[n, d], both contiguous and on one CUDA device.
    Launches on the current stream and raises if the launch fails.
    """
    global LAUNCHES
    _build.check_cuda_inputs("distance_matrix", Q=Q, X=X)
    check_pairs_shapes(Q, X, metric)
    if X.dtype != torch.float32:
        raise TypeError(f"X must be float32, got {X.dtype}")
    (b, d), n = Q.shape, X.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=Q.device)
    if b == 0 or n == 0:
        return out
    _build.launch("distance_matrix", _kernel(), Q.device, Q.data_ptr(),
                  X.data_ptr(), out.data_ptr(), b, n, d,
                  _build.METRIC_CODE[metric])
    LAUNCHES += 1
    return out
