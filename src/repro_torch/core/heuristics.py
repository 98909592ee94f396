"""Filtered-search heuristic space (port of ``repro.core.heuristics``).

Adaptive rule (paper Section 3.2), evaluated per lane:

  sigma >= ub_onehop (0.5)                 -> ONEHOP_S
  esv = sigma*(M+1)*M >= M*lf  (lf = 3)    -> DIRECTED
  otherwise                                -> BLIND

adaptive-global evaluates it once with sigma_g = |S|/|V|; adaptive-local
evaluates it per iteration with sigma_l = |S & nbrs(c_min)| / |nbrs(c_min)|.
"""

from __future__ import annotations

import enum

import torch


class Heuristic(enum.IntEnum):
    # order matters: the first three index the expansion branches
    ONEHOP_S = 0
    DIRECTED = 1
    BLIND = 2
    ADAPTIVE_GLOBAL = 3
    ADAPTIVE_LOCAL = 4
    ONEHOP_A = 5

    @staticmethod
    def from_name(name: str) -> "Heuristic":
        return _BY_NAME[name.replace("-", "_").lower()]


_BY_NAME = {
    "onehop_s": Heuristic.ONEHOP_S,
    "onehop_a": Heuristic.ONEHOP_A,
    "directed": Heuristic.DIRECTED,
    "blind": Heuristic.BLIND,
    "adaptive_g": Heuristic.ADAPTIVE_GLOBAL,
    "adaptive_global": Heuristic.ADAPTIVE_GLOBAL,
    "adaptive_l": Heuristic.ADAPTIVE_LOCAL,
    "adaptive_local": Heuristic.ADAPTIVE_LOCAL,
    "navix": Heuristic.ADAPTIVE_LOCAL,
}

#: selectivity above which onehop-s is safe (paper: "50% is a safe choice")
UB_ONEHOP_S = 0.5
#: leniency factor for the directed-vs-blind boundary (paper default: 3)
LENIENCY_FACTOR = 3.0


def adaptive_rule(sigma: torch.Tensor, m: int, ub: float = UB_ONEHOP_S,
                  lf: float = LENIENCY_FACTOR) -> torch.Tensor:
    """The paper's decision rule -> int32 branch index, elementwise.

    ``sigma`` is evaluated in f32, like the reference's
    ``jnp.asarray(sigma, jnp.float32)``.
    """
    sigma = sigma.to(torch.float32)
    esv = sigma * (m + 1) * m
    two_hop = torch.where(esv >= m * lf, int(Heuristic.DIRECTED),
                          int(Heuristic.BLIND))
    return torch.where(sigma >= ub, int(Heuristic.ONEHOP_S),
                       two_hop).to(torch.int32)
