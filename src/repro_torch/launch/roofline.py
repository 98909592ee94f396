"""Three-term roofline of one step on one chip (port of
``repro.launch.roofline``), from the op counts of
:mod:`repro_torch.launch.op_analysis` in place of a compiled artifact:

  compute term    = flops a chip / the card's dense bf16 peak
  memory term     = bytes a chip / the card's device-memory rate
  collective term = collective bytes a chip / NVLink's rate each way

Every rate is ``repro_torch.common.hardware.TARGET``'s (one H100 SXM); a
record names the link it divides by. The counts are a chip's (its local
shards), so each term is already a chip's time.
"""

from __future__ import annotations

import dataclasses

from repro_torch.common.hardware import TARGET
from repro_torch.launch.op_analysis import OpCost

#: the interconnect the collective term divides by, and its rate
LINK = "nvlink"
LINK_BANDWIDTH = TARGET.nvlink_bandwidth


@dataclasses.dataclass
class Roofline:
    name: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict[str, int]
    model_flops: float = 0.0          # 6*N*D (dense) / 6*N_active*D (MoE)
    peak_memory_per_chip: float = 0.0
    counter: dict | None = None       # the op counter's raw figures

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / TARGET.peak_bf16_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / TARGET.hbm_bandwidth

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BANDWIDTH

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs over all chips: how much of the
        counted compute is useful."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """t_compute / max(all terms): the share of the bound that is
        compute, if the other terms overlapped it perfectly."""
        return self.t_compute / self.bound_time if self.bound_time else 0.0

    def to_dict(self) -> dict:
        return {
            "counter": self.counter,
            "name": self.name, "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "peak_memory_per_chip": self.peak_memory_per_chip,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bound_s": self.bound_time,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "chip": TARGET.name,
            "peak_bf16_flops": TARGET.peak_bf16_flops,
            "hbm_bandwidth": TARGET.hbm_bandwidth,
            "link": LINK, "link_bandwidth": LINK_BANDWIDTH,
        }


def analyze(name: str, cost: OpCost, chips: int,
            model_flops: float = 0.0) -> Roofline:
    """The roofline of a step from its op counts (``OpCounter.cost``)."""
    return Roofline(name=name, chips=chips, flops_per_chip=cost.flops,
                    bytes_per_chip=cost.bytes_accessed,
                    coll_bytes_per_chip=cost.collective_bytes,
                    coll_breakdown={k: int(v) for k, v in
                                    cost.coll_breakdown.items()},
                    model_flops=model_flops,
                    peak_memory_per_chip=cost.peak_bytes,
                    counter={"n_ops": cost.n_ops,
                             "arg_bytes": cost.arg_bytes})


def lm_model_flops(cfg, shape) -> float:
    """6*N*D with N = active params; decode counts one token/step, plus
    attention KV dot cost which dominates decode."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape["seq_len"] * shape["global_batch"]
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape["seq_len"] * shape["global_batch"]
        # forward only
        return 2.0 * n_active * tokens
    if shape.kind == "decode":
        b, s = shape["global_batch"], shape["seq_len"]
        dense = 2.0 * n_active * b
        attn = (2.0 * 2.0 * cfg.n_layers * b * s
                * cfg.n_kv_heads * cfg.head_dim * cfg.q_per_kv)
        return dense + attn
    return 0.0
