"""NavixIndex -- the single-index handle (port of ``repro.core.navix``).

    idx, build_stats = NavixIndex.create(vectors, NavixConfig())   # on CUDA
    res = idx.search_many(Q, k=100, semimask=mask)   # adaptive-local
    qidx = idx.quantize_resident()                   # int8 on the device
    res = qidx.search_quantized_many(Q, k=100, semimask=mask)

The index lives on one device, chosen at ``create`` / ``from_graph``: CUDA
by default, the CPU only when the caller passes ``device="cpu"``. Searches
run where the index lives; queries and semimasks are moved there. An
int8-resident index (paper Section 5.8) keeps codes + scales on the device
and its f32 rows in a host :class:`ExactTier`, which re-ranks the final
beam exactly.

The primary public API is ``repro_torch.api.NavixDB``; ``NavixIndex`` is
the compatibility layer underneath it. Indexes registered in a ``NavixDB``
catalog share its program cache (``program_cache``), so this API's
searches are counted there too.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import bitset
from repro_torch.core.build import BuildParams, BuildStats, build
from repro_torch.core.distances import (brute_force_topk, normalize,
                                        validate_metric)
from repro_torch.core.graph import HnswGraph
from repro_torch.core.heuristics import Heuristic
from repro_torch.core.postfilter import postfilter_search
from repro_torch.core.quantize import QuantizedStore, dequantize, quantize
from repro_torch.core.search import SearchParams, SearchResult, search
from repro_torch.core.search_batch import resolve_engine
from repro_torch.storage.columnar import ExactTier


class NavixConfig(NamedTuple):
    m_u: int = 16                 # paper: M=32 upper / 64 lower at scale
    ef_construction: int = 100
    sample_rate: float = 0.05     # upper-layer sample (paper: 5%)
    metric: str = "l2"
    batch_size: int = 256
    seed: int = 0

    def build_params(self) -> BuildParams:
        return BuildParams(m_u=self.m_u, ef_construction=self.ef_construction,
                           sample_rate=self.sample_rate, metric=self.metric,
                           batch_size=self.batch_size, seed=self.seed)


@dataclasses.dataclass
class NavixIndex:
    graph: HnswGraph
    config: NavixConfig
    quantized: Optional[QuantizedStore] = None
    # exact f32 tier (host / memmap) paired with a quantized-resident graph;
    # finalizes quantized searches by re-ranking the final beam exactly
    exact: Optional[ExactTier] = None
    # set when the index is registered in a NavixDB catalog; routes search
    # through the shared program cache (repro_torch.api.plan_compile)
    program_cache: Optional[object] = None
    # lazily built quantized sibling of an f32 index (search_quantized on
    # an f32 index); never part of the persisted state
    _qview: Optional["NavixIndex"] = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- creation ---------------------------------------------------------
    @classmethod
    def create(cls, vectors, config: NavixConfig = NavixConfig(),
               device: str | torch.device | None = None
               ) -> tuple["NavixIndex", BuildStats]:
        """Build an index over ``vectors`` (f32[n, d]) on ``device``."""
        validate_metric(config.metric)
        graph, stats = build(vectors, config.build_params(), device=device)
        return cls(graph=graph, config=config), stats

    @classmethod
    def from_graph(cls, graph: HnswGraph, config: NavixConfig,
                   device: str | torch.device | None = None) -> "NavixIndex":
        """Wrap an existing graph, moved to ``device`` (CUDA by default)."""
        return cls(graph=graph.to(resolve_device(device)), config=config)

    @property
    def device(self) -> torch.device:
        return self.graph.device

    # -- residency ----------------------------------------------------------
    @property
    def is_quantized(self) -> bool:
        """True when the device-resident vectors are int8 codes + scales."""
        return isinstance(self.graph.vectors, QuantizedStore)

    def quantize_resident(self, mmap_path=None) -> "NavixIndex":
        """Return a sibling index whose device residency is int8.

        The graph's vector payload becomes the ``QuantizedStore`` (codes +
        per-vector scales, quantized on the index's device; the engines'
        gather+distance dequantizes per gathered row, so no [n, d] f32
        buffer is made on the device) and the f32 rows are copied once to
        a host-side :class:`ExactTier` (``mmap_path`` spills them to disk).
        """
        if self.is_quantized:
            return self
        store = self.quantized
        if store is None:
            store = quantize(self.graph.vectors)
        exact = ExactTier.build(self.graph.vectors.cpu().numpy(),
                                self.config.metric, mmap_path=mmap_path)
        return dataclasses.replace(
            self, graph=self.graph._replace(vectors=store), quantized=store,
            exact=exact, _qview=None)

    def _quantized_view(self) -> "NavixIndex":
        """The index search_quantized* runs on: self if already
        int8-resident, else a cached quantized sibling (built once)."""
        if self.is_quantized:
            return self
        if self._qview is None:
            self._qview = self.quantize_resident()
            self.quantized = self._qview.quantized
        # the sibling always follows this index's current catalog cache
        self._qview.program_cache = self.program_cache
        return self._qview

    # -- semimasks ----------------------------------------------------------
    def pack_semimask(self, mask) -> torch.Tensor:
        """Pack a semimask (or a per-lane stack of semimasks).

        Accepts bool[n] / bool[B, n] (numpy, a tensor, or a list of bool[n]
        masks), pre-packed uint32[W] / uint32[B, W] numpy words, or the
        port's own int32 word tensors. Returns int32 words on the index's
        device.
        """
        if isinstance(mask, (list, tuple)):
            mask = np.stack([np.asarray(m) for m in mask])
        want = bitset.n_words(self.graph.n)
        if isinstance(mask, torch.Tensor):
            if mask.dtype == torch.int32:
                if mask.shape[-1] != want:
                    raise ValueError(
                        f"pre-packed semimask has {mask.shape[-1]} words but "
                        f"this index ({self.graph.n} nodes) needs {want}")
                return mask.to(self.device)
            mask = mask.to(torch.bool)
            if mask.shape[-1] != self.graph.n:
                raise ValueError(f"semimask covers {mask.shape[-1]} nodes but "
                                 f"this index has {self.graph.n}")
            return bitset.pack(mask.to(self.device))
        mask = np.asarray(mask)
        if mask.dtype == np.uint32:
            if mask.shape[-1] != want:
                raise ValueError(
                    f"pre-packed semimask has {mask.shape[-1]} uint32 words "
                    f"but this index ({self.graph.n} nodes) needs {want}; "
                    f"was it packed for a differently-sized index?")
            return bitset.from_words(mask, self.device)
        if mask.shape[-1] != self.graph.n:
            raise ValueError(f"semimask covers {mask.shape[-1]} nodes but "
                             f"this index has {self.graph.n}")
        # host data packs on the host in one numpy pass
        return bitset.from_words(bitset.pack_np(mask), self.device)

    def full_semimask(self) -> torch.Tensor:
        return bitset.full_mask(self.graph.n, self.device)

    def sigma(self, sel_bits: torch.Tensor):
        """Selectivity |S|/|V|: a float for a [W] mask, f32[B] per lane for
        a per-lane [B, W] stack."""
        if sel_bits.ndim == 2:
            return bitset.count_batch(sel_bits).to(torch.float32) / self.graph.n
        return float(bitset.count(sel_bits)) / self.graph.n

    # -- search -------------------------------------------------------------
    def _params(self, k: int, efs: int, heuristic) -> SearchParams:
        h = (Heuristic.from_name(heuristic) if isinstance(heuristic, str)
             else Heuristic(heuristic))
        return SearchParams(k=k, efs=max(efs, k), heuristic=int(h),
                            metric=self.config.metric)

    def _single(self):
        """The single-query entry: the catalog's program cache when the
        index is registered in a ``NavixDB``, else the search itself."""
        if self.program_cache is not None:     # (an empty cache is falsy)
            return self.program_cache.search
        return search

    def _batch(self, engine: str):
        """The batch entry for a (validated) engine name, through the
        catalog's program cache when there is one."""
        if self.program_cache is not None:
            return self.program_cache.batch(engine)
        return resolve_engine(engine)

    def _prep_query(self, q) -> torch.Tensor:
        q = torch.as_tensor(q, dtype=torch.float32).to(self.device)
        if self.config.metric == "cos":
            q = normalize(q)
        return q.contiguous()

    def search(self, q, k: int = 100, efs: int = 0, semimask=None,
               heuristic="adaptive_local", sigma_g=None) -> SearchResult:
        """Filtered kNN for one query vector (the single-query oracle)."""
        efs = efs or 2 * k
        sel = (self.full_semimask() if semimask is None
               else self.pack_semimask(semimask))
        if sigma_g is None:
            sigma_g = self.sigma(sel)
        return self._single()(self.graph, self._prep_query(q), sel,
                              self._params(k, efs, heuristic), sigma_g)

    def search_many(self, Q, k: int = 100, efs: int = 0, semimask=None,
                    heuristic="adaptive_local",
                    engine: str = "batched") -> SearchResult:
        """Batched search -- the serving-throughput path.

        ``engine="batched"`` (default) runs the batched-frontier engine
        (``repro_torch.core.search_batch``); ``engine="vmap"`` runs the
        single-query search once a lane, the reference oracle. Both return
        lane-for-lane identical results.

        ``semimask`` may be one shared mask (bool[n] / uint32[W]) or a
        per-lane stack (bool[B, n], a list of B masks, or uint32[B, W]), in
        which case lane b searches its own selected set.
        """
        run = self._batch(engine)
        efs = efs or 2 * k
        sel = (self.full_semimask() if semimask is None
               else self.pack_semimask(semimask))
        return run(self.graph, self._prep_query(Q), sel,
                   self._params(k, efs, heuristic), self.sigma(sel))

    def search_quantized(self, q, k: int = 100, efs: int = 0, semimask=None,
                         heuristic="adaptive_local") -> SearchResult:
        """DiskANN-regime search for one query: int8-resident beam + exact
        re-rank (paper Section 5.8).

        The beam loop runs on the int8 codes (the fused dequantizing
        gather+distance; no [n, d] f32 store is made) and keeps the full
        ``efs`` frontier, which is re-ranked on the host against the
        :class:`ExactTier` f32 rows and cut to ``k``. Results are tensors
        on the index's device.
        """
        qidx = self._quantized_view()
        efs = max(efs or 2 * k, k)
        sel = (qidx.full_semimask() if semimask is None
               else qidx.pack_semimask(semimask))
        qv = self._prep_query(q)
        # full-beam params (k == efs): the exact tier does the final cut
        res = qidx._single()(qidx.graph, qv, sel,
                             self._params(efs, efs, heuristic),
                             qidx.sigma(sel))
        return self._reranked(qidx.exact.rerank(_host(qv), _host(res.ids),
                                                k), res.stats)

    def search_quantized_many(self, Q, k: int = 100, efs: int = 0,
                              semimask=None, heuristic="adaptive_local",
                              engine: str = "batched") -> SearchResult:
        """Batched DiskANN-regime search: the int8-resident store under the
        batched-frontier engine, then a lane-vectorized exact re-rank
        against the f32 tier. Lane for lane equal to
        :meth:`search_quantized` (``semimask`` takes the shared and
        per-lane forms of :meth:`search_many`)."""
        qidx = self._quantized_view()
        run = qidx._batch(engine)
        efs = max(efs or 2 * k, k)
        sel = (qidx.full_semimask() if semimask is None
               else qidx.pack_semimask(semimask))
        Qp = self._prep_query(Q)
        res = run(qidx.graph, Qp, sel, self._params(efs, efs, heuristic),
                  qidx.sigma(sel))
        return self._reranked(qidx.exact.rerank_many(_host(Qp),
                                                     _host(res.ids), k),
                              res.stats)

    def _reranked(self, exact: tuple[np.ndarray, np.ndarray],
                  stats) -> SearchResult:
        """The exact tier's (dists, ids) as tensors on the index's device,
        with the beam search's stats."""
        d, ids = exact
        return SearchResult(dists=torch.from_numpy(d).to(self.device),
                            ids=torch.from_numpy(ids).to(self.device),
                            stats=stats)

    def search_postfilter(self, q, k: int = 100, semimask=None):
        """The Section 5.7 postfilter baseline for one query: (dists[k],
        ids[k], PostfilterStats), numpy (see
        :func:`repro_torch.core.postfilter.postfilter_search`)."""
        sel = (self.full_semimask() if semimask is None
               else self.pack_semimask(semimask))
        return postfilter_search(self.graph, self._prep_query(q), sel, k,
                                 metric=self.config.metric)

    # -- oracles ------------------------------------------------------------
    def brute_force(self, Q, k: int = 100, semimask=None):
        """Exact filtered kNN over the index's vectors: (dists, ids).

        On a quantized-resident index it scores the exact f32 rows of the
        host tier, not the codes (a graph carried across without its tier
        falls back to dequantizing: this is an oracle, not a search path).
        """
        Q = torch.atleast_2d(self._prep_query(Q))
        mask = None
        if semimask is not None:
            mask = bitset.unpack(self.pack_semimask(semimask), self.graph.n)
        vectors = self.graph.vectors
        if self.is_quantized:
            # np.array: an owned, writable copy (the tier may be a
            # read-only memmap)
            vectors = (torch.from_numpy(np.array(self.exact.vectors))
                       .to(self.device) if self.exact is not None
                       else dequantize(vectors))
        return brute_force_topk(Q, vectors, k, self.config.metric, mask=mask)

    def recall(self, res_ids, true_ids) -> float:
        """recall@k with -1-padding awareness (both arrays [k] or [b, k])."""
        res = np.atleast_2d(_host(res_ids))
        true = np.atleast_2d(_host(true_ids))
        hits = denom = 0
        for r, t in zip(res, true):
            tset = set(int(x) for x in t if x >= 0)
            denom += len(tset)
            # a duplicated result id is one hit, not many
            hits += len(tset & set(int(x) for x in r if x >= 0))
        return hits / max(denom, 1)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
