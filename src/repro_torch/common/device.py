"""Device resolution for the port's entry points.

Entry points default to the CUDA device. Without a usable CUDA device they
raise instead of moving work to the CPU; the CPU runs only when a caller
asks for it with ``device="cpu"`` (the test suite does).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the device an entry point runs on ("cuda" by default).

    Raises ``RuntimeError`` for a CUDA device on a host where
    ``torch.cuda.is_available()`` is false, and ``ValueError`` for a device
    type the port has no path for.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False on this host; pass "
                "device='cpu' to run the plain PyTorch path explicitly")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
