"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into a shared library at first use, then loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries go to
``kernels/_build_out/`` beside the sources (ignored by git), named by a
hash of the source and the flags, so an edited source builds anew and an
unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build_out"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    digest = hashlib.sha256(src.read_bytes()
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
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib
