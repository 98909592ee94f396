"""Target-hardware constants and roofline helpers (port of
``repro.common.hardware``).

The port's target is one NVIDIA H100 SXM (Hopper, sm_90a). Every value of
:data:`H100_SXM` is the data sheet's (NVIDIA's H100 data sheet and the
Hopper architecture white paper): dense tensor-core rates, the f32 rate
outside the tensor cores, device memory and its rate, the SM count, the
shared memory one block can use, and NVLink. These constants give the
least time the card could take for a piece of work (:func:`bound_s`, the
``bound_ms`` of ``chip_smoke.py``'s kernel line) and the roofline terms;
a measured time comes only from a run on the card.

The reference's ``MXU_DIM`` and ``VPU_LANES`` / ``VPU_SUBLANES`` are the
TPU's (8, 128) tiling and 128 x 128 matrix unit, which shaped its Pallas
``BlockSpec``s; they have no counterpart here. A Hopper kernel tiles by
its warps (32 threads), 16-byte loads and ``wgmma``'s 64-row tiles, each
kernel in its own source (``repro_torch/kernels/csrc``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float   # dense tensor-core bf16 FLOP/s
    peak_tf32_flops: float   # dense tensor-core TF32 FLOP/s
    peak_int8_ops: float     # dense tensor-core int8 OP/s
    peak_f32_flops: float    # f32 FLOP/s outside the tensor cores
    hbm_bandwidth: float     # device-memory bytes/s
    nvlink_bandwidth: float  # bytes/s each way, all links together
    nvlink_links: int        # NVLink links per card
    hbm_bytes: int           # device memory
    smem_bytes: int          # shared memory one block can use
    sm_count: int            # streaming multiprocessors


H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_bf16_flops=989e12,
    peak_tf32_flops=495e12,
    peak_int8_ops=1979e12,
    peak_f32_flops=67e12,
    hbm_bandwidth=3.35e12,
    nvlink_bandwidth=450e9,
    nvlink_links=18,
    hbm_bytes=80 * 1024**3,
    smem_bytes=232_448,
    sm_count=132,
)

TARGET = H100_SXM


def compute_time_s(flops: float, chips: int, chip: ChipSpec = TARGET) -> float:
    """Roofline compute term: FLOPs / (chips * dense bf16 peak)."""
    return flops / (chips * chip.peak_bf16_flops)


def memory_time_s(hbm_bytes: float, chips: int, chip: ChipSpec = TARGET) -> float:
    """Roofline memory term: bytes moved / (chips * device-memory rate)."""
    return hbm_bytes / (chips * chip.hbm_bandwidth)


def collective_time_s(coll_bytes: float, chips: int, chip: ChipSpec = TARGET) -> float:
    """Roofline collective term: collective bytes / (chips * NVLink rate
    each way). The cards of a host are joined all to all through NVLink
    switches, so every link of a card reaches every peer and the
    denominator is all of them, where the reference's torus term takes
    one ICI link."""
    return coll_bytes / (chips * chip.nvlink_bandwidth)


def bound_s(nbytes: float, f32_flops: float, tc_flops: float = 0.0,
            tc_rate: float = TARGET.peak_tf32_flops) -> tuple[float, str]:
    """``(least seconds, what bounds it)`` of one piece of work on one
    ``TARGET`` card: the larger of ``nbytes`` over the device-memory rate
    (``"bytes"``) and the operations over their rates (``"operations"``):
    ``f32_flops`` at the f32 rate outside the tensor cores plus
    ``tc_flops`` tensor-core operations at ``tc_rate``."""
    t_bytes = nbytes / TARGET.hbm_bandwidth
    t_ops = f32_flops / TARGET.peak_f32_flops + tc_flops / tc_rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
