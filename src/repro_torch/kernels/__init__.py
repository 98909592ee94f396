"""Hand-written CUDA kernels, their plain PyTorch versions, and the
device-of-tensor dispatch layer (counterpart of ``repro.kernels``)."""
