"""PyTorch/CUDA port of the NaviX filtered-HNSW engine.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``data/``, ``configs/``) so every module has exactly one reference module.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a CUDA tensor reaching a kernel wrapper launches the
hand-written CUDA kernel or raises -- nothing falls back to the CPU.
"""
