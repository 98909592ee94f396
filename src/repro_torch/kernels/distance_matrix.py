"""Wrapper of the CUDA all-pairs distance kernel, in two paths.

Replaces the TPU kernel ``repro/kernels/distance_matrix.py::
distance_matrix_pallas``. The batch size picks the path (:func:`plan`):
b <= :data:`STREAM_MAX_BATCH` streams X once through CUDA cores
(``csrc/distance_matrix_stream.cu``, bound by bytes), larger batches run
on the tensor cores with a 3xTF32 split at full f32 accuracy
(``csrc/distance_matrix_wgmma.cu``). Both paths load 16 bytes at a time
where rows are 16-byte aligned and 4 bytes otherwise. The source notes
give each path's bound and design; the plain PyTorch version is
``kernels/ref.py::distance_matrix``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`distance_matrix` in this process
LAUNCHES = 0
#: the same launches, by path
PATH_LAUNCHES = {"stream": 0, "wgmma": 0}

#: the largest batch the streaming path takes (its b sums per thread)
STREAM_MAX_BATCH = 16
#: b travels to both paths as a C int; the wgmma path's persistent grid
#: (one block per SM) walks any number of tiles
MAX_BATCH = _build.INT32_MAX


def _kernel(path: str):
    name = f"distance_matrix_{path}"
    return _build.bind(name, f"navix_{name}",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5)


def check_pairs_shapes(Q: torch.Tensor, X: torch.Tensor, metric: str,
                       max_batch: int) -> None:
    """Raise unless Q[b, d] and X[n, d] fit an all-pairs kernel's ranges
    (b at most ``max_batch``)."""
    if Q.dtype != torch.float32:
        raise TypeError(f"Q must be float32, got {Q.dtype}")
    if Q.ndim != 2 or X.ndim != 2 or Q.shape[1] != X.shape[1]:
        raise ValueError(f"expected Q[b, d] and X[n, d], got shapes "
                         f"{tuple(Q.shape)} and {tuple(X.shape)}")
    if Q.shape[1] == 0:
        raise ValueError("rows must have a width > 0")
    if (max(X.shape[0], Q.shape[1]) > _build.INT32_MAX
            or Q.shape[0] > max_batch):
        raise ValueError("a dimension exceeds the kernel's range")
    if metric not in _build.METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")


def plan(Q: torch.Tensor, X: torch.Tensor) -> tuple[str, bool]:
    """(path, 16-byte loads) for Q[b, d] against X[n, d]: ``"stream"`` for
    b <= :data:`STREAM_MAX_BATCH`, else ``"wgmma"``; 16-byte loads when
    d % 4 == 0 and both tensors start 16-byte aligned."""
    path = "stream" if Q.shape[0] <= STREAM_MAX_BATCH else "wgmma"
    vec = (Q.shape[1] % 4 == 0 and Q.data_ptr() % 16 == 0
           and X.data_ptr() % 16 == 0)
    return path, vec


def check_matrix_shapes(Q: torch.Tensor, X: torch.Tensor,
                        metric: str) -> None:
    """Raise unless Q and X fit this kernel: f32 Q[b, d] and X[n, d], b at
    most :data:`MAX_BATCH`."""
    check_pairs_shapes(Q, X, metric, MAX_BATCH)
    if X.dtype != torch.float32:
        raise TypeError(f"X must be float32, got {X.dtype}")


def distance_matrix(Q: torch.Tensor, X: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """f32[b, n] = dist(Q[b], X[n]) on the CUDA device.

    Q f32[b, d], X f32[n, d], both contiguous and on one CUDA device.
    Launches one kernel, of the path :func:`plan` picks, on the current
    stream and raises if the launch fails.
    """
    global LAUNCHES
    _build.check_cuda_inputs("distance_matrix", Q=Q, X=X)
    check_matrix_shapes(Q, X, metric)
    (b, d), n = Q.shape, X.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=Q.device)
    if b == 0 or n == 0:
        return out
    path, vec = plan(Q, X)
    _build.launch("distance_matrix", _kernel(path), Q.device, Q.data_ptr(),
                  X.data_ptr(), out.data_ptr(), b, n, d,
                  _build.METRIC_CODE[metric], int(vec))
    LAUNCHES += 1
    PATH_LAUNCHES[path] += 1
    return out
