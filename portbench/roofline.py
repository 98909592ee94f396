"""The yardstick's peaks and the work the search's distance kernels need.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense rates, no
sparsity), which assume the card's full 700 W: a card set to a lower
``power.limit`` reaches less, so every share is printed beside the limit
that ``nvidia-smi`` reads (a copy of ``repro_torch.common.hardware``'s
``H100_SXM`` and ``bound_s``). The gather-distance kernels do no matrix
work, so their bound is the device memory's rate alone.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # HBM3, 80 GB part
F32_FLOPS = 67e12               # f32 outside the tensor cores

#: bytes one gathered row takes on the device, by residency: f32 rows,
#: or int8 codes with one f32 scale
ROW_BYTES = {"f32": lambda d: 4 * d, "int8": lambda d: d + 4}


def gather_bytes(distances: int, queries: int, d: int, residency: str
                 ) -> int:
    """Bytes the search's gather-distance work needs: each distance's row
    read once, each query (f32[d]) read once, each distance (f32) written
    once. ``distances`` counts what the algorithm computes (the beam's
    ``t_dc`` and the upper descent's ``upper_dc``), not what a kernel
    reads again, so a rewrite of the kernel leaves it as it is."""
    return distances * (ROW_BYTES[residency](d) + 4) + queries * 4 * d


def bound_s(nbytes: float, flops: float = 0.0, rate: float = F32_FLOPS
            ) -> float:
    """The least seconds the work takes: the larger of its bytes over the
    memory's rate and its operations over ``rate``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / rate)
