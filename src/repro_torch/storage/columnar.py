"""Columnar graph store (port of ``repro.storage.columnar``).

The port's own copy of the reference module, the GDBMS substrate the index
is native to (paper Section 2.3): node tables are columnar property
vectors (:class:`NodeTable`); relationship tables are CSR structures,
forward and backward (:class:`RelTable`); :class:`GraphStore` holds both.
Selection subqueries (``repro_torch.query``) run against it and emit node
semimasks. :class:`ExactTier` is the host f32 tier of an int8-resident
index (paper Section 5.8).

All of it is numpy on the host, as in the reference: the "disk" side of
the system. Only the index (``repro_torch.core``) lives on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass
class NodeTable:
    name: str
    n: int
    columns: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def add_column(self, name: str, values: np.ndarray) -> None:
        values = np.asarray(values)
        if values.shape[0] != self.n:
            raise ValueError(f"column {name}: {values.shape[0]} rows != {self.n}")
        self.columns[name] = values

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def rows(self, ids: np.ndarray,
             columns: Sequence[str] | None = None) -> dict[str, np.ndarray]:
        """Gather property values at ``ids`` (projection after a kNN).

        ``ids`` may carry -1 padding (unreachable result slots); padded
        positions return the row-0 value -- callers mask on ``ids >= 0``.
        """
        ids = np.asarray(ids)
        take = np.maximum(ids, 0)
        names = list(columns) if columns is not None else list(self.columns)
        return {c: self.columns[c][take] for c in names}


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


@dataclasses.dataclass
class CSR:
    offsets: np.ndarray      # int64[n_src + 1]
    targets: np.ndarray      # int64[n_edges]

    @property
    def n_src(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_edges(self) -> int:
        return len(self.targets)

    def neighbors(self, u: int) -> np.ndarray:
        return self.targets[self.offsets[u]:self.offsets[u + 1]]

    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets)


def csr_from_edges(src: np.ndarray, dst: np.ndarray, n_src: int) -> CSR:
    """CSR of an edge list; a source's targets keep their edge order (a
    stable sort), so the layout equals the reference's."""
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    counts = np.bincount(src_s, minlength=n_src)
    offsets = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return CSR(offsets=offsets, targets=dst_s.astype(np.int64))


@dataclasses.dataclass
class RelTable:
    name: str
    src_table: str
    dst_table: str
    fwd: CSR                 # src -> dst
    bwd: CSR                 # dst -> src

    @property
    def n_edges(self) -> int:
        return self.fwd.n_edges


@dataclasses.dataclass
class GraphStore:
    nodes: dict[str, NodeTable] = dataclasses.field(default_factory=dict)
    rels: dict[str, RelTable] = dataclasses.field(default_factory=dict)

    def add_node_table(self, name: str, n: int,
                       columns: Mapping[str, np.ndarray] | None = None
                       ) -> NodeTable:
        t = NodeTable(name=name, n=n)
        for cname, col in (columns or {}).items():
            t.add_column(cname, col)
        self.nodes[name] = t
        return t

    def add_rel_table(self, name: str, src_table: str, dst_table: str,
                      src: np.ndarray, dst: np.ndarray) -> RelTable:
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        n_src = self.nodes[src_table].n
        n_dst = self.nodes[dst_table].n
        if src.size and (src.max() >= n_src or dst.max() >= n_dst):
            raise ValueError(f"rel {name}: edge endpoint out of range")
        rel = RelTable(name=name, src_table=src_table, dst_table=dst_table,
                       fwd=csr_from_edges(src, dst, n_src),
                       bwd=csr_from_edges(dst, src, n_dst))
        self.rels[name] = rel
        return rel

    def add_vector_column(self, table: str, name: str,
                          vectors: np.ndarray) -> None:
        """Register an embedding column (f32[n, d]) on a node table; the
        index catalog builds HNSW indexes over these (CREATE_HNSW_INDEX's
        first argument pair)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2:
            raise ValueError(f"vector column {name}: expected [n, d], "
                             f"got shape {vectors.shape}")
        self.nodes[table].add_column(name, vectors)

    def node(self, name: str) -> NodeTable:
        return self.nodes[name]

    def rel(self, name: str) -> RelTable:
        return self.rels[name]
