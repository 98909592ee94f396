"""Program cache for the kNN plan operator (port of
``repro.api.plan_compile``).

The reference lowers and compiles one XLA program per plan *shape* and
stores it under a :class:`ProgramKey`; eager PyTorch has no compile step,
so here an entry is the engine callable bound to its (key, batch bucket):
``functools.partial(engine, params=params)``. The cache keeps everything
else of the reference:

* the same :class:`ProgramKey` fields -- ``(n, dim, k, efs, heuristic,
  metric, batch_shape, engine)`` plus the minor search knobs, the
  per-lane-mask arm and the residency -- so a call sequence makes the same
  entries, hits and misses as the reference's (``info()`` is equal);
* batch shapes are bucketed to the next power of two (queries are padded
  with their first row, per-lane masks and ``sigma_g`` alike, and the
  result sliced back), so a serving engine draining groups of 17, then 19,
  then 23 requests makes one entry, not three;
* the ``engine`` arm keeps the batched-frontier engine ("batched") and the
  vmap oracle ("vmap") apart, the ``resident`` arm f32 and int8 stores,
  and the ``sharded`` arm a ShardedNavix's search over its device grid
  (:meth:`ProgramCache.search_sharded`).

An entry exists so that a captured CUDA graph of the engine's loop can
later hang on its (key, bucket). The cache is owned by
:class:`repro_torch.api.db.NavixDB` and shared with every index in its
catalog (``NavixIndex.program_cache``), so the compatibility API
``NavixIndex.search(...)`` goes through it too.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.analysis.runtime import PROGRAM, record_compile
from repro_torch.core.graph import HnswGraph
from repro_torch.core.quantize import QuantizedStore
from repro_torch.core.search import SearchParams, SearchResult
from repro_torch.core.search import search as _search
from repro_torch.core.search_batch import resolve_engine


class ProgramKey(NamedTuple):
    """Identity of one cached search program (the plan's *shape*)."""
    n: int
    dim: int
    k: int
    efs: int
    heuristic: int
    metric: str
    batch_shape: Optional[int]     # None = single-query program
    knobs: tuple = ()              # (ub, lf, two_hop_cap, max_iters,
                                   #  m_l, n_upper, m_u)
    engine: str = "single"         # "single" | "vmap" | "batched" -- the
                                   # two batch engines are distinct programs
    per_lane_sel: bool = False     # [B, W] per-lane semimasks (mixed-plan
                                   # batches) vs one shared [W] mask
    sharded: int = 0               # shard count S of a ShardedNavix
                                   # program (0 = unsharded) -- the MODEL
                                   # axis: every shard searches its own
                                   # subgraph and the results merge
    lane_shards: int = 1           # DATA-axis size of the grid: the lane
                                   # (batch) dim splits into this many
                                   # blocks; batch buckets are rounded up
                                   # to a multiple of it
    resident: str = "f32"          # device residency of the vector store:
                                   # "f32" (dense rows) | "int8" (codes +
                                   # per-vector scales) -- distinct
                                   # programs, since the gather differs


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0

    @property
    def compiles(self) -> int:
        """Entries made (the reference compiles one program per miss)."""
        return self.misses

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "compiles": self.compiles}


def _bucket(b: int) -> int:
    """Round a batch size up to the next power of two (min 1)."""
    out = 1
    while out < b:
        out <<= 1
    return out


def _pad_rows(x: torch.Tensor, pad: int, dim: int = 0) -> torch.Tensor:
    """``x`` with ``pad`` copies of its first row along ``dim`` appended."""
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.narrow(dim, 0, 1).expand(shape)], dim=dim)


class ProgramCache:
    """Program cache for single-query and batched filtered search."""

    def __init__(self):
        self._programs: dict[ProgramKey, functools.partial] = {}
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._programs)

    def info(self) -> dict:
        return {**self.stats.as_dict(), "programs": len(self._programs)}

    # -- internals ----------------------------------------------------------
    def _key(self, graph: HnswGraph, params: SearchParams,
             batch_shape: Optional[int], engine: str = "single",
             per_lane_sel: bool = False) -> ProgramKey:
        resident = ("int8" if isinstance(graph.vectors, QuantizedStore)
                    else "f32")
        return ProgramKey(
            n=graph.n, dim=graph.dim, k=params.k, efs=params.efs,
            heuristic=params.heuristic, metric=params.metric,
            batch_shape=batch_shape,
            knobs=(params.ub, params.lf, params.two_hop_cap,
                   params.max_iters, graph.m_l, graph.n_upper,
                   graph.m_u),
            engine=engine, per_lane_sel=per_lane_sel, resident=resident)

    def _lookup(self, key: ProgramKey):
        """The entry under ``key`` (a hit), or None (a miss: the caller
        stores the entry)."""
        prog = self._programs.get(key)
        if prog is None:
            self.stats.misses += 1
        else:
            self.stats.hits += 1
        return prog

    def _store(self, key: ProgramKey, prog):
        """Store the entry made after a miss under ``key``; each is one
        ``"program"`` event for ``repro_torch.analysis.runtime``'s compile
        counters, counted here where it is made (the reference counts the
        compile, not the cache's stats)."""
        self._programs[key] = prog
        record_compile(PROGRAM)
        return prog

    # -- execution ----------------------------------------------------------
    def search(self, graph: HnswGraph, q: torch.Tensor,
               sel_bits: torch.Tensor, params: SearchParams,
               sigma_g) -> SearchResult:
        """Single-query filtered search through a cached entry."""
        sigma_g = torch.as_tensor(sigma_g, dtype=torch.float32)
        key = self._key(graph, params, None)
        prog = self._lookup(key)
        if prog is None:
            prog = self._store(key, functools.partial(_search,
                                                      params=params))
        return prog(graph, q, sel_bits, sigma_g=sigma_g)

    def search_batch(self, graph: HnswGraph, Q: torch.Tensor,
                     sel_bits: torch.Tensor, params: SearchParams,
                     sigma_g) -> SearchResult:
        """vmap-engine batch search (the reference oracle path)."""
        return self.batch("vmap")(graph, Q, sel_bits, params, sigma_g)

    def search_many(self, graph: HnswGraph, Q: torch.Tensor,
                    sel_bits: torch.Tensor, params: SearchParams,
                    sigma_g) -> SearchResult:
        """Batched-frontier engine search (the serving throughput path),
        under its own key arm (``engine="batched"``)."""
        return self.batch("batched")(graph, Q, sel_bits, params, sigma_g)

    def batch(self, engine: str):
        """The cached batch entry point for a (validated) engine name."""
        return functools.partial(self._run_batched, resolve_engine(engine),
                                 engine)

    def _run_batched(self, fn, engine: str, graph: HnswGraph,
                     Q: torch.Tensor, sel_bits: torch.Tensor,
                     params: SearchParams, sigma_g) -> SearchResult:
        """Shared batch path: the batch is padded to its power-of-two
        bucket so nearby batch sizes share one entry, and results are
        sliced back to the true size.

        ``sel_bits`` may be one shared ``[W]`` semimask or a per-lane
        ``[B, W]`` stack; per-lane masks (and a per-lane ``sigma_g``) are
        padded alongside the query rows, on the device, and key a distinct
        ``per_lane_sel`` arm. Lanes are independent in both engines, so
        padding changes no real lane's result.
        """
        sigma_g = torch.as_tensor(sigma_g, dtype=torch.float32,
                                  device=Q.device)
        per_lane = sel_bits.ndim == 2
        b = Q.shape[0]
        bb = _bucket(b)
        if bb != b:
            Q = _pad_rows(Q, bb - b)
            if per_lane:
                sel_bits = _pad_rows(sel_bits, bb - b)
            if sigma_g.ndim == 1:
                sigma_g = _pad_rows(sigma_g, bb - b)
        key = self._key(graph, params, bb, engine=engine,
                        per_lane_sel=per_lane)
        prog = self._lookup(key)
        if prog is None:
            prog = self._store(key, functools.partial(fn, params=params))
        res = prog(graph, Q, sel_bits, sigma_g=sigma_g)
        if bb != b:
            res = SearchResult(dists=res.dists[:b], ids=res.ids[:b],
                               stats=type(res.stats)(
                                   *(s[:b] for s in res.stats)))
        return res

    def search_sharded(self, sn, Q: torch.Tensor, sel_bits: torch.Tensor,
                       alive, params: SearchParams) -> SearchResult:
        """Sharded batched search through the cache (the ``sharded`` key
        arm): the ShardedNavix's search program, the batched-frontier
        engine on every shard + one global merge.

        ``sel_bits`` is shared ``[S, W]`` or per-lane ``[S, B, W]``
        (padded along the lane axis with the batch bucket, which is
        rounded up to a multiple of the grid's data axis); the padding is
        made where the tensors lie, as ``_run_batched`` makes it. The key
        carries the grid's devices, so two same-shape indexes on different
        devices never share an entry.
        """
        per_lane = sel_bits.ndim == 3
        b = Q.shape[0]
        bb = _bucket(b)
        ls = sn.lane_shards
        if bb % ls:
            # the data axis splits the lane dim; the padded bucket must
            # divide evenly
            bb = -(-bb // ls) * ls
        if bb != b:
            pad = bb - b
            Q = _pad_rows(Q, pad)
            if per_lane:
                sel_bits = _pad_rows(sel_bits, pad, dim=1)
        g = sn.graphs[0]
        key = ProgramKey(
            n=sn.n_total, dim=sn.dim, k=params.k, efs=params.efs,
            heuristic=params.heuristic, metric=params.metric,
            batch_shape=bb,
            knobs=(params.ub, params.lf, params.two_hop_cap,
                   params.max_iters, sn.n_local, g.m_l, g.n_upper, g.m_u,
                   sn.model_axis, sn.data_axis,
                   tuple(str(d) for d in sn.mesh.flat())),
            engine="batched", per_lane_sel=per_lane, sharded=sn.n_shards,
            lane_shards=ls)
        prog = self._lookup(key)
        if prog is None:
            prog = self._store(key, sn._program("search", params))
        res = prog(sn.graphs, Q, sel_bits, alive)
        if bb != b:
            res = SearchResult(dists=res.dists[:b], ids=res.ids[:b],
                               stats=type(res.stats)(
                                   *(s[:b] for s in res.stats)))
        return res
