"""Build, load and launch the port's CUDA sources.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into a shared library at first use, then loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries go to
``kernels/_build_out/`` beside the sources (ignored by git), named by a
hash of the source, the headers in ``csrc/`` and the flags, so an edited
source or header builds anew and an unchanged one is reused. Each run of
``nvcc`` is reported to ``repro_torch.analysis.runtime``'s compile
counters as one ``"nvcc"`` event; a reused library is none.

Every kernel's wrapper binds its entry with :func:`bind`, checks its
tensors with :func:`check_cuda_inputs` and launches through
:func:`launch`, which raises on a CUDA error with the message of
``csrc/cuda_error.cu``, the one source that exports it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from repro_torch.analysis.runtime import NVCC, record_compile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build_out"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the metric codes of the distance kernels' C interface
METRIC_CODE = {"l2": 0, "cos": 1, "dot": 2}
INT32_MAX = 2 ** 31 - 1
#: the schedule codes of the gather-distance kernels' C interface
SCHEDULE_CODE = {"tiled": 0, "spread": 1}
#: candidates of one lane that a tiled gather block takes (``kTileK`` in
#: both gather sources)
TILE_K = 64

_loaded: dict[str, ctypes.CDLL] = {}
#: per source: nvcc's output of the last build in this process (registers,
#: shared memory and spills from ``-Xptxas -v``) and its seconds
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    """Path of ``nvcc`` (on PATH or in the default toolkit location)."""
    exe = shutil.which("nvcc")
    if exe is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin); "
            "the CUDA kernels of repro_torch are built from source at first "
            "use and need the CUDA toolkit")
    return exe


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    nvcc = find_nvcc()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)    # atomic: a concurrent loader sees all or none
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            "log": (proc.stdout + proc.stderr).strip()}
        record_compile(NVCC)
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` (built at first use),
    taking ``argtypes`` and a stream and returning a CUDA error code."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def sm_count(device: torch.device) -> int:
    """The number of SMs of CUDA ``device`` (read once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def schedule(bsz: int, k: int, sm_count: int, min_share: float) -> str:
    """The gather kernels' schedule: ``"tiled"`` when the tiled grid,
    bsz * ceil(k / TILE_K) blocks, has at least ``min_share * sm_count``
    blocks, else ``"spread"``."""
    blocks = bsz * -(-k // TILE_K)
    return "tiled" if blocks >= min_share * sm_count else "spread"


def check_cuda_inputs(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{key} lies on {t.device}; the CUDA kernel "
                             f"takes CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    devices = [str(t.device) for t in tensors.values()]
    if len(set(devices)) != 1:
        raise ValueError(f"the inputs of {kernel} lie on different devices "
                         f"({', '.join(devices)})")


def check_launch(kernel: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if rc != 0:
        err = load("cuda_error").navix_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream; raise if
    the launch fails."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_launch(kernel, rc)
