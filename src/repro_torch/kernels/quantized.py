"""Wrapper of the CUDA all-pairs int8 distance kernel, in two paths.

Replaces the TPU kernel ``repro/kernels/quantized.py::
quantized_distance_pallas``. The batch size picks the path (:func:`plan`):
b <= :data:`STREAM_MAX_BATCH` streams the codes once through CUDA cores
(``csrc/quantized_distance_stream.cu``, bound by bytes), larger batches run
on the tensor cores with a 3xBF16 split of Q at full f32 accuracy
(``csrc/quantized_distance_wgmma.cu``, which first writes Q's split and
norms into a scratch tensor the wrapper allocates). The source notes give
each path's bound and design; the plain PyTorch version is
``kernels/ref.py::quantized_distance_matrix``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_matrix import check_pairs_shapes

#: kernel launches made by :func:`quantized_distance_matrix` in this process
LAUNCHES = 0
#: the same launches, by path
PATH_LAUNCHES = {"stream": 0, "wgmma": 0}

#: the largest batch the streaming path takes: the largest swept b at which
#: it beat the tensor-core path at (n = 1M, d = 960) on an H100 (the sweep
#: of chip_smoke.py: 1.03 against 1.32 ms at b = 16, 2.08 against 1.33 ms
#: at b = 24). A byte of int8 codes carries 2b flops against a CUDA core's
#: ridge of ~20, so the path turns FMA-bound above b ~ 10.
STREAM_MAX_BATCH = 16
#: b travels to both paths as a C int; the wgmma path's persistent grid
#: walks any number of tiles and the streaming path's grid holds
#: ceil(n / 256) blocks at b <= STREAM_MAX_BATCH
MAX_BATCH = _build.INT32_MAX


def _kernel(path: str):
    """The C entry of ``path``: Q, codes, scale, out (and the wgmma path's
    scratch), then b, n, d, the metric code and the load width."""
    name = f"quantized_distance_{path}"
    pointers = 4 if path == "stream" else 5
    return _build.bind(name, f"navix_{name}",
                       [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5)


def _scratch_bytes(b: int, d: int) -> int:
    """Bytes of the wgmma path's scratch for Q[b, d] (its split of Q and
    ||q||^2, in the layout its source defines)."""
    fn = _build.load("quantized_distance_wgmma") \
        .navix_quantized_distance_wgmma_scratch
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(b, d))


def plan(Q: torch.Tensor, codes: torch.Tensor) -> tuple[str, int]:
    """(path, load width) for Q[b, d] against codes[n, d]: ``"stream"``
    for b <= :data:`STREAM_MAX_BATCH`, else ``"wgmma"``; 16-byte loads
    when d % 16 == 0 and both tensors start 16-byte aligned, 4-byte copies
    of the codes when d % 4 == 0 and they start 4-byte aligned, else byte
    loads."""
    path = "stream" if Q.shape[0] <= STREAM_MAX_BATCH else "wgmma"
    d = Q.shape[1]
    if d % 16 == 0 and Q.data_ptr() % 16 == 0 and codes.data_ptr() % 16 == 0:
        return path, 16
    if d % 4 == 0 and codes.data_ptr() % 4 == 0:
        return path, 4
    return path, 1


def check_shapes(Q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 metric: str) -> None:
    """Raise unless Q, codes and scale fit this kernel: f32 Q[b, d], int8
    codes[n, d], f32 scale[n], b at most :data:`MAX_BATCH`."""
    check_pairs_shapes(Q, codes, metric, MAX_BATCH)
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if scale.dtype != torch.float32 or scale.shape != (codes.shape[0],):
        raise ValueError(f"scale must be float32[{codes.shape[0]}], got "
                         f"{scale.dtype}{tuple(scale.shape)}")


def _launch(Q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
            metric: str, path: str | None = None
            ) -> tuple[torch.Tensor, bool]:
    """Check the inputs, launch the kernel on the path :func:`plan` picks
    (or on ``path``, which only measurements name) with :func:`plan`'s
    load width; (out, whether it launched)."""
    _build.check_cuda_inputs("quantized_distance_matrix", Q=Q, codes=codes,
                             scale=scale)
    check_shapes(Q, codes, scale, metric)
    (b, d), n = Q.shape, codes.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=Q.device)
    if b == 0 or n == 0:
        return out, False
    picked, load = plan(Q, codes)
    path = path or picked
    pointers = [Q.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                out.data_ptr()]
    if path == "wgmma":
        scratch = torch.empty(_scratch_bytes(b, d), dtype=torch.uint8,
                              device=Q.device)
        pointers.append(scratch.data_ptr())
    _build.launch("quantized_distance_matrix", _kernel(path), Q.device,
                  *pointers, b, n, d, _build.METRIC_CODE[metric], load)
    PATH_LAUNCHES[path] += 1
    return out, True


def quantized_distance_matrix(Q: torch.Tensor, codes: torch.Tensor,
                              scale: torch.Tensor,
                              metric: str) -> torch.Tensor:
    """f32[b, n] = dist(Q[b], scale[n] * codes[n]) on the CUDA device.

    Q f32[b, d], codes int8[n, d], scale f32[n], all contiguous and on one
    CUDA device. Launches one kernel, of the path :func:`plan` picks, on
    the current stream and raises if the launch fails.
    """
    global LAUNCHES
    out, launched = _launch(Q, codes, scale, metric)
    LAUNCHES += launched
    return out
