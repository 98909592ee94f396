"""Exact f32 re-rank tier (port of ``repro.storage.columnar.ExactTier``).

The port's own copy of the reference's host tier: the full-precision rows
of an int8-resident index stay in host memory (numpy) or on disk
(``np.memmap``), the "disk" side of the paper's Section 5.8 regime, and
only the final beam's rows are read back to re-rank it exactly. It is
numpy on purpose: the device holds codes, scales and the graph only.
``NodeTable``, ``CSR`` and ``GraphStore`` of the reference module come
with the API layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ExactTier:
    """Host-side float32 exact re-rank tier over a vector column.

    The memory-hierarchy counterpart of the int8-resident engine
    (``repro_torch.core.quantize.QuantizedStore``): device HBM holds codes +
    scales + graph only, and the full-precision rows live here -- a plain
    ndarray or an ``np.memmap`` (the paper's disk-resident regime; DiskANN
    keeps compressed vectors in memory and exact vectors on disk the same
    way). ``rerank_many`` gathers only the final beam's rows, so a search
    touches O(B * efs) f32 rows host-side, never the whole store.

    Distance forms mirror ``repro_torch.core.distances.point_dist``
    (smaller-is-closer; cos assumes rows were normalized at ingest).
    """

    vectors: np.ndarray      # f32[n, d]; ndarray or np.memmap
    metric: str = "l2"

    @classmethod
    def build(cls, vectors: np.ndarray, metric: str = "l2",
              mmap_path=None) -> "ExactTier":
        """Materialize a tier from f32 rows; ``mmap_path`` spills them to
        a file and reopens the map read-only (the "disk" side)."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if mmap_path is None:
            return cls(vectors=vectors, metric=metric)
        mm = np.memmap(mmap_path, dtype=np.float32, mode="w+",
                       shape=vectors.shape)
        mm[:] = vectors
        mm.flush()
        ro = np.memmap(mmap_path, dtype=np.float32, mode="r",
                       shape=vectors.shape)
        return cls(vectors=ro, metric=metric)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def is_mmapped(self) -> bool:
        return isinstance(self.vectors, np.memmap)

    def nbytes(self) -> int:
        """Host/disk bytes of the tier (NOT device-resident)."""
        return int(self.vectors.size) * 4

    def rerank_many(self, Q: np.ndarray, ids: np.ndarray, k: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact re-rank of per-lane candidate beams, entirely host-side.

        ``Q`` f32[b, d] (prepped queries), ``ids`` int[b, w] with ``-1``
        padding -> ``(dists[b, k], ids[b, k])`` ascending by exact
        distance. Padded ids never surface (-1 in, -1 out) and duplicate
        ids count once (repeats after the first occurrence are dropped
        before ranking). Ties keep beam order (stable sort), so lane b of
        a batch is exactly :meth:`rerank` on row b.
        """
        Q = np.asarray(Q, dtype=np.float32)
        ids = np.asarray(ids)
        b, w = ids.shape
        # dedupe keep-first: id equal to an EARLIER slot's id -> -1
        earlier = np.tril(np.ones((w, w), dtype=bool), -1)
        dup = ((ids[:, :, None] == ids[:, None, :]) & earlier).any(-1) \
            & (ids >= 0)
        ids = np.where(dup, -1, ids)
        rows = self.vectors[np.maximum(ids, 0)]          # [b, w, d] gather
        if self.metric == "l2":
            diff = rows - Q[:, None, :]
            d = np.sum(diff * diff, axis=-1)
        elif self.metric == "cos":
            d = 1.0 - np.sum(rows * Q[:, None, :], axis=-1)
        elif self.metric == "dot":
            d = -np.sum(rows * Q[:, None, :], axis=-1)
        else:
            raise ValueError(self.metric)
        d = np.where(ids >= 0, d, np.inf).astype(np.float32)
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        out_d = np.take_along_axis(d, order, axis=1)
        out_i = np.where(np.isfinite(out_d),
                         np.take_along_axis(ids, order, axis=1), -1)
        if k > w:                                        # pad short beams
            pad = k - w
            out_d = np.concatenate(
                [out_d, np.full((b, pad), np.inf, np.float32)], axis=1)
            out_i = np.concatenate(
                [out_i, np.full((b, pad), -1, out_i.dtype)], axis=1)
        return out_d, out_i.astype(np.int32)

    def rerank(self, q: np.ndarray, ids: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """Single-query exact re-rank: trivially lane 0 of
        :meth:`rerank_many` (the single/batched equivalence is by
        construction, not by parallel implementations)."""
        d, i = self.rerank_many(np.asarray(q)[None], np.asarray(ids)[None],
                                k)
        return d[0], i[0]
