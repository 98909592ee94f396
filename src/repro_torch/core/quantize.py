"""Int8 vector quantization (port of ``repro.core.quantize``).

The DiskANN-regime analogue of paper Section 5.8: symmetric per-vector
int8 codes stay on the device, the beam search runs on quantized
distances, and the final beam is re-ranked with full-precision distances.
On the card the quantized distance runs in the hand-written int8 gather
kernel (``kernels/csrc/quantized_gather_distance.cu``).

``quantize`` gives the reference's codes bit for bit: the scale is
``amax / 127`` (1 for an all-zero row), the row is divided by it in f32,
rounded half to even and clipped to +-127.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedStore(NamedTuple):
    """The int8-resident vector representation.

    It can sit directly in ``HnswGraph.vectors``: it exposes the logical
    ``[n, d]`` ``shape`` of the f32 store, so ``graph.n`` / ``graph.dim``
    keep working, and the engines gather and dequantize rows on the fly,
    so no ``[n, d]`` f32 buffer is made.
    """

    codes: torch.Tensor    # int8[n, d]
    scale: torch.Tensor    # f32[n]   per-vector symmetric scale

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def shape(self) -> torch.Size:
        """Logical [n, d] shape of the store (mirrors the f32 tensor)."""
        return self.codes.shape

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def nbytes(self) -> int:
        return self.codes.numel() + 4 * self.scale.numel()

    def to(self, device: torch.device) -> "QuantizedStore":
        return QuantizedStore(codes=self.codes.to(device),
                              scale=self.scale.to(device))


def quantize(vectors: torch.Tensor) -> QuantizedStore:
    """Per-row symmetric int8 codes and f32 scales of ``vectors`` f32[n, d],
    computed on the tensor's device."""
    amax = vectors.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0).to(torch.float32)
    # round half to even, as jnp.round
    codes = torch.round(vectors / scale[:, None]).clamp_(-127, 127)
    return QuantizedStore(codes=codes.to(torch.int8), scale=scale)


def dequantize(store: QuantizedStore) -> torch.Tensor:
    return store.codes.to(torch.float32) * store.scale[:, None]


def rerank_many(Q: torch.Tensor, vectors, ids: torch.Tensor, k: int,
                metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of per-lane candidate lists: Q[b, d], ids[b, w] ->
    (dists[b, k], ids[b, k]) ascending.

    ``ids`` may carry ``-1`` padding (never surfaces: padded slots rank at
    +inf and come back as ``-1``) and duplicates (counted once: repeats
    after the first occurrence are dropped before ranking). A stable sort
    stands in for ``lax.top_k``, which puts the lower index first among
    ties. ``vectors`` is an f32 tensor or a :class:`QuantizedStore`.
    """
    # import here: the engines import this module through core.graph
    from repro_torch.core.distances import gathered_dist_batch
    from repro_torch.core.search import _dedupe_keep_first
    if k > ids.shape[-1]:
        raise ValueError(f"k={k} exceeds the {ids.shape[-1]} candidates")
    ids = _dedupe_keep_first(ids)
    d = gathered_dist_batch(Q, vectors, ids, metric)
    out_d, order = torch.sort(d, dim=-1, stable=True)
    out_d = out_d[:, :k]
    return out_d, torch.where(torch.isfinite(out_d),
                              ids.gather(1, order[:, :k]), -1)


def rerank(q: torch.Tensor, vectors, ids: torch.Tensor, k: int,
           metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-query exact re-rank: lane 0 of :func:`rerank_many`, so the
    two agree bit for bit by construction. Returns (dists[k], ids[k])."""
    d, i = rerank_many(q[None, :], vectors, ids[None, :], k, metric)
    return d[0], i[0]
