"""HNSW graph container (port of ``repro.core.graph``).

NaviX is a 2-level HNSW: the lower level ``G_L`` holds all ``n`` vectors
with max degree ``M_L``; the upper level ``G_U`` holds a ``sample_rate``
sample with max degree ``M_U`` and only finds a good entry point.
Adjacency is fixed-degree and ``-1`` padded, exactly as in the reference,
so the arrays of a reference graph carry over field by field
(:func:`graph_from_numpy`). The vector payload is an f32 tensor, or a
:class:`~repro_torch.core.quantize.QuantizedStore` when the index is
int8-resident.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.quantize import QuantizedStore

FIELDS = ("lower", "lower_deg", "upper", "upper_deg", "upper_ids",
          "entry_pos", "vectors")


class HnswGraph(NamedTuple):
    """Index topology + vector payload, all on one device."""

    lower: torch.Tensor        # int32[n, M_L], -1 padded
    lower_deg: torch.Tensor    # int32[n]
    upper: torch.Tensor        # int32[n_u, M_U] positions into upper_ids
    upper_deg: torch.Tensor    # int32[n_u]
    upper_ids: torch.Tensor    # int32[n_u] -> node id in [0, n)
    entry_pos: torch.Tensor    # int32 scalar: entry position into upper_ids
    vectors: torch.Tensor | QuantizedStore
    # f32[n, d] (normalized when metric == "cos"), or int8 codes + per-row
    # scales when the index is quantized-resident

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def m_l(self) -> int:
        return self.lower.shape[1]

    @property
    def m_u(self) -> int:
        return self.upper.shape[1]

    @property
    def n_upper(self) -> int:
        return self.upper_ids.shape[0]

    @property
    def device(self) -> torch.device:
        return self.lower.device

    def nbytes(self) -> int:
        return sum(_nbytes(t) for t in self)

    def vector_nbytes(self) -> int:
        """Device-resident bytes of the vector payload alone (int8 codes +
        scales against the f32 store)."""
        return _nbytes(self.vectors)

    def to(self, device: torch.device) -> "HnswGraph":
        # a QuantizedStore moves both of its tensors
        return HnswGraph(*(t.to(device) for t in self))


def _nbytes(x: torch.Tensor | QuantizedStore) -> int:
    if isinstance(x, QuantizedStore):
        return x.nbytes()
    return x.numel() * x.element_size()


def graph_from_numpy(arrays: dict[str, np.ndarray],
                     device: str | torch.device | None = None) -> HnswGraph:
    """Build an :class:`HnswGraph` from numpy arrays, one per field.

    This carries a graph across from the reference package (fill the dict
    with ``np.asarray(getattr(g, f))`` for each field of :data:`FIELDS`) or
    from a checkpoint. Index fields become int32 and vectors f32, as in the
    reference. An int8-resident graph passes ``vectors`` as the pair
    ``{"codes": int8[n, d], "scale": f32[n]}`` of its ``QuantizedStore``.
    ``device`` defaults to CUDA (see ``resolve_device``).
    """
    dev = resolve_device(device)
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"graph arrays lack fields {missing}")

    def tensor(a, dtype) -> torch.Tensor:
        a = np.array(a, dtype=dtype, order="C")             # owned copy
        return torch.from_numpy(a).to(dev)

    out = {f: tensor(arrays[f], np.int32) for f in FIELDS if f != "vectors"}
    vectors = arrays["vectors"]
    if isinstance(vectors, dict):
        out["vectors"] = QuantizedStore(
            codes=tensor(vectors["codes"], np.int8),
            scale=tensor(vectors["scale"], np.float32))
    else:
        out["vectors"] = tensor(vectors, np.float32)
    return HnswGraph(**out)


def degree_histogram(graph: HnswGraph) -> np.ndarray:
    deg = graph.lower_deg.cpu().numpy()
    return np.bincount(deg, minlength=graph.m_l + 1)


def check_symmetric_fraction(graph: HnswGraph, sample: int = 1024,
                             seed: int = 0) -> float:
    """Fraction of sampled directed edges whose reverse edge also exists
    (same sample and count as the reference)."""
    rng = np.random.default_rng(seed)
    lower = graph.lower.cpu().numpy()
    deg = graph.lower_deg.cpu().numpy()
    nodes = rng.integers(0, graph.n, size=sample)
    hits = total = 0
    for u in nodes:
        for v in lower[u, : deg[u]]:
            if v < 0:
                continue
            total += 1
            if u in lower[v, : deg[v]]:
                hits += 1
    return hits / max(total, 1)
