"""NavixDB -- the unified query facade (port of ``repro.api.db``).

The paper's point (Sections 2.3, 4) is that QUERY_HNSW_INDEX is just
another operator inside the GDBMS query processor: the selection subquery
runs first, its selected set S reaches the kNN operator as a node semimask
via sideways information passing, and everything composes with joins,
projections and limits. ``NavixDB`` is that processor:

    db = NavixDB(store)                                    # on CUDA
    db.create_index("chunk_emb", "Chunk", column="embedding",
                    config=NavixConfig(metric="cos"))      # CREATE_HNSW_INDEX
    rs = db.execute(
        Q.match("Person").where("birth_date", "range", lo=0, hi=18250)
         .hop("PersonChunk", "fwd")
         .knn(qvec, k=10).project("cID"))                  # QUERY_HNSW_INDEX
    rs.ids, rs.dists, rs.columns["cID"], rs.timings.prefilter_ms

One ``execute`` runs the whole pipeline -- prefilter (host numpy) ->
semimask packing -> adaptive-local search on the device (through the
program cache) -> exact re-rank (int8 residency) -> projection -- and
returns a typed :class:`ResultSet` of numpy arrays with the paper's Table
7 per-stage timing split. The database lives on one device: CUDA unless
the caller passes ``device="cpu"``; its indexes are built there, and each
device stage's clock stops after a synchronize of it. The compatibility
path ``NavixIndex.search(..., semimask=...)`` shares the program cache once
the index is registered in a catalog.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.api.plan_compile import ProgramCache
from repro_torch.common.device import resolve_device
from repro_torch.core.build import BuildStats
from repro_torch.core.distributed import ShardedNavix
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.core.search import SearchStats
from repro_torch.query.operators import (KnnSearch, Plan, QueryResult,
                                         evaluate, output_table,
                                         split_pipeline)
from repro_torch.storage.columnar import GraphStore


@dataclasses.dataclass
class StageTimings:
    """Per-stage wall times of one execute() (Table 7 accounting)."""
    prefilter_ms: float = 0.0      # Q_S evaluation (host, numpy)
    pack_ms: float = 0.0           # mask -> device bitset (SIP handoff)
    search_ms: float = 0.0         # kNN operator (device)
    rerank_ms: float = 0.0         # exact-tier re-rank (host; quantized
                                   # residency only)
    project_ms: float = 0.0        # projection / row materialization

    @property
    def total_ms(self) -> float:
        return (self.prefilter_ms + self.pack_ms + self.search_ms
                + self.rerank_ms + self.project_ms)

    def as_dict(self) -> dict:
        return {"prefilter_ms": self.prefilter_ms, "pack_ms": self.pack_ms,
                "search_ms": self.search_ms, "rerank_ms": self.rerank_ms,
                "project_ms": self.project_ms, "total_ms": self.total_ms}


@dataclasses.dataclass
class ResultSet:
    """Typed result of ``NavixDB.execute``, numpy throughout.

    ``ids``/``dists`` are [k] for a single bound query or [b, k] for a
    batch; -1 ids are padding (fewer than k reachable selected nodes).
    ``columns`` holds the projected property columns gathered at ``ids``.
    """
    table: str
    ids: np.ndarray
    dists: Optional[np.ndarray]
    columns: dict[str, np.ndarray]
    sigma: float                   # selectivity |S| / |V| of the prefilter
                                   # (mean over lanes for per-lane masks)
    timings: StageTimings
    stats: Optional[SearchStats] = None     # kNN plans only, numpy fields
    mask: Optional[np.ndarray] = None       # the Q_S semimask (host bool[n])
    sigmas: Optional[np.ndarray] = None     # per-lane selectivities (f32[b],
                                            # execute(masks=[...]) only)

    def __len__(self) -> int:
        return int(self.ids.shape[0])

    def rows(self) -> Iterator[dict]:
        """Iterate result rows as dicts (single-query plans only)."""
        if self.ids.ndim != 1:
            raise ValueError("rows() is for single-query results; "
                             "index batch results directly")
        for j, i in enumerate(self.ids):
            if i < 0:
                continue
            row = {"id": int(i)}
            if self.dists is not None:
                row["dist"] = float(self.dists[j])
            for c, v in self.columns.items():
                row[c] = v[j]
            yield row


@dataclasses.dataclass
class IndexEntry:
    """One catalog entry: a named HNSW index over (table, vector column).
    ``index`` is a NavixIndex or a ShardedNavix (shard-and-merge)."""
    name: str
    table: str
    column: str
    index: NavixIndex | ShardedNavix


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


class NavixDB:
    """GraphStore + index catalog + query execution, behind one handle."""

    def __init__(self, store: Optional[GraphStore] = None,
                 device: str | torch.device | None = None):
        self.store = store if store is not None else GraphStore()
        self.device = resolve_device(device)
        self.catalog: dict[str, IndexEntry] = {}
        self.programs = ProgramCache()

    def _sync(self) -> None:
        """Wait for the device's queued work (a stage's clock stops after
        it, or it would time the launches, not the work)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- catalog (CREATE_HNSW_INDEX) ---------------------------------------
    def create_index(self, name: str, table: str, column: str = "embedding",
                     vectors: Optional[np.ndarray] = None,
                     config: NavixConfig = NavixConfig()
                     ) -> tuple[NavixIndex, BuildStats]:
        """Build + register an HNSW index over ``table.column``, on the
        database's device.

        ``vectors`` (f32[n, d]) may be passed to materialize the column
        first (creating the node table if absent) -- the common path when
        embeddings come from a model rather than the store.
        """
        if name in self.catalog:
            raise ValueError(f"index {name!r} already exists")
        if vectors is not None:
            vectors = np.asarray(vectors, dtype=np.float32)
            if table not in self.store.nodes:
                self.store.add_node_table(table, vectors.shape[0])
            self.store.add_vector_column(table, column, vectors)
        payload = self.store.node(table).column(column)
        index, stats = NavixIndex.create(payload, config, device=self.device)
        self._register(IndexEntry(name, table, column, index))
        return index, stats

    def register_index(self, name: str, index,
                       table: Optional[str] = None,
                       column: str = "embedding") -> IndexEntry:
        """Adopt an already-built index on the database's device
        (checkpoint restore, bench cache).

        ``index`` may be a :class:`NavixIndex` or a
        :class:`~repro_torch.core.distributed.ShardedNavix` (sharded entries
        route ``execute`` through the sharded batched engine; its grid's
        first cell is its device). When ``table`` is omitted, the catalog
        binds to the unique node table with a matching row count, creating
        a bare one if needed.
        """
        if name in self.catalog:
            raise ValueError(f"index {name!r} already exists")
        sharded = isinstance(index, ShardedNavix)
        if not (sharded or isinstance(index, NavixIndex)):
            raise TypeError(
                f"index {name!r} is a {type(index).__name__}; the port's "
                f"catalog holds NavixIndex and ShardedNavix entries")
        if index.device.type != self.device.type:
            raise ValueError(f"index {name!r} lives on {index.device}, but "
                             f"this database runs on {self.device}")
        n = index.n_total if sharded else index.graph.n
        if table is None:
            matches = [t for t, nt in self.store.nodes.items() if nt.n == n]
            if len(matches) > 1:
                raise ValueError(f"ambiguous table for index {name!r}: "
                                 f"{matches}; pass table= explicitly")
            table = matches[0] if matches else name
        if table not in self.store.nodes:
            self.store.add_node_table(table, n)
        entry = IndexEntry(name, table, column, index)
        self._register(entry)
        return entry

    def _register(self, entry: IndexEntry) -> None:
        entry.index.program_cache = self.programs
        self.catalog[entry.name] = entry

    def index(self, name: str) -> NavixIndex | ShardedNavix:
        return self.catalog[name].index

    def quantize_index(self, name: str, mmap_path=None) -> NavixIndex:
        """Switch a catalog entry to int8 device residency.

        The entry's index is replaced by its quantized-resident sibling
        (``NavixIndex.quantize_resident``): the device holds codes +
        per-vector scales + graph only, full-precision rows live in a
        host-side exact tier (``mmap_path`` spills them to disk), and
        every ``execute`` over this entry finishes with an exact re-rank
        (timed separately as ``StageTimings.rerank_ms``). Entries key on
        residency, so the swap never collides with cached f32 entries.
        """
        entry = self.catalog[name]
        if isinstance(entry.index, ShardedNavix):
            raise ValueError(f"index {name!r} is sharded; quantized "
                             f"residency applies to single-device indexes")
        entry.index = entry.index.quantize_resident(mmap_path=mmap_path)
        entry.index.program_cache = self.programs
        return entry.index

    def _resolve(self, knn: KnnSearch, table: str) -> IndexEntry:
        if knn.index is not None:
            return self.catalog[knn.index]
        matches = [e for e in self.catalog.values() if e.table == table]
        if not matches:
            raise ValueError(f"no index on table {table!r}; create one with "
                             f"db.create_index(...)")
        if len(matches) > 1:
            raise ValueError(f"multiple indexes on table {table!r}: "
                             f"{[e.name for e in matches]}; name one in "
                             f"KnnSearch(index=...)")
        return matches[0]

    # -- serving -------------------------------------------------------------
    def serve(self, index: Optional[str] = None, **kw):
        """Construct a live :class:`~repro_torch.serving.service.
        SearchService` over one catalog entry (default: the first
        registered index), on the database's device. Keyword args pass
        through -- k/efs caps, batch size, deadlines, backpressure policy;
        see ``SearchService``. Call ``.start()`` (or use it as a context
        manager) to spawn the device loop."""
        from repro_torch.serving.service import SearchService
        return SearchService(self, index=index, **kw)

    # -- execution ----------------------------------------------------------
    def prefilter(self, plan: Plan) -> QueryResult:
        """Run a selection subquery alone (mask + wall time)."""
        return evaluate(plan, self.store)

    def execute(self, plan, query: Optional[np.ndarray] = None,
                max_batch: int = 0, engine: str = "batched",
                masks=None, alive=None) -> ResultSet:
        """Run a full plan. ``plan`` is a Plan tree or a ``Q`` builder.

        ``query`` binds the vector(s) for the KnnSearch operator: [d] for
        one query, [b, d] for a batch (overrides a vector bound on the
        builder). ``max_batch`` chunks device execution of large batches;
        the prefilter still runs exactly once. ``engine`` picks the
        multi-row execution engine: "batched" (default, the
        batched-frontier engine) or "vmap" (the reference oracle, one
        single-query search a lane); single-row queries ignore it.

        ``masks`` runs a **mixed-plan batch**: a list of per-query
        selection masks (bool[n]; ``None`` entries mean unfiltered), one
        per row of a [b, d] ``query``. Each lane then searches its own
        selected set in one device batch (the paper's per-query ad-hoc S,
        batched); ``ResultSet.sigmas`` carries the per-lane
        selectivities. The plan must not also carry a selection subquery
        -- the caller has already run the per-request Q_S's.

        When the resolved catalog entry is a ShardedNavix, the kNN
        operator runs the sharded batched engine (every shard searched,
        one global merge); ``alive`` (bool[S], default all alive)
        quorum-masks the merge so dead shards contribute nothing. It
        raises on an unsharded entry.
        """
        # builders carry their own bound query vector
        bound = getattr(plan, "bound_query", None)
        as_plan = getattr(plan, "plan", None)
        if callable(as_plan):
            plan = as_plan()
        if query is None:
            query = bound
        parts = split_pipeline(plan)
        table = output_table(plan, self.store)

        # stage 1: prefilter (Q_S on the host)
        timings = StageTimings()
        mask = None
        sigma = 1.0
        if parts.selection is not None:
            if masks is not None:
                raise ValueError(
                    "execute(masks=...) replaces the prefilter stage; the "
                    "plan must not also carry a selection subquery")
            qres = evaluate(parts.selection, self.store)
            mask, sigma = qres.mask, qres.selectivity
            timings.prefilter_ms = qres.seconds * 1e3

        if parts.knn is None:
            return self._finish_selection(parts, table, mask, sigma, timings)
        if query is None:
            raise ValueError("plan has a KnnSearch but no query vector was "
                             "bound; pass execute(plan, query=...)")
        query = np.asarray(query)
        if masks is not None:
            if query.ndim != 2 or len(masks) != query.shape[0]:
                raise ValueError(
                    f"masks needs one entry per query row; got "
                    f"{len(masks)} masks for query shape {query.shape}")
            n = self.store.node(table).n
            mask = np.stack([np.ones(n, bool) if m is None
                             else np.asarray(m, bool) for m in masks])
        return self._execute_knn(parts, table, query, mask,
                                 sigma, timings, max_batch, engine, alive)

    def _execute_knn(self, parts, table, query, mask, sigma, timings,
                     max_batch, engine="batched", alive=None) -> ResultSet:
        knn = parts.knn
        entry = self._resolve(knn, table)
        idx = entry.index
        sharded = isinstance(idx, ShardedNavix)
        n_rows = idx.n_total if sharded else idx.graph.n
        if n_rows != self.store.node(table).n:
            raise ValueError(f"index {entry.name!r} covers {n_rows} "
                             f"rows but table {table!r} has "
                             f"{self.store.node(table).n}")
        if sharded and engine != "batched":
            raise ValueError(f"sharded index {entry.name!r} runs the "
                             f"batched engine only, not {engine!r}")
        if alive is not None and not sharded:
            raise ValueError(f"alive= quorum-masks sharded indexes; "
                             f"{entry.name!r} is unsharded")

        # stage 2: semimask packing (the SIP handoff to the device)
        t0 = time.perf_counter()
        if sharded:
            sel = (idx.full_semimask() if mask is None
                   else idx.shard_semimask(mask))
        else:
            sel = (idx.full_semimask() if mask is None
                   else idx.pack_semimask(mask))
        self._sync()
        timings.pack_ms = (time.perf_counter() - t0) * 1e3

        # per-lane masks carry per-lane selectivities
        sigmas = None
        if sel.ndim == (3 if sharded else 2):
            sigmas = _host(idx.sigma(sel))
            sigma = float(sigmas.mean())

        # stage 3: the kNN operator through the program cache
        k = knn.k
        quantized = not sharded and idx.is_quantized
        if quantized:
            # int8 residency: the beam runs on codes at FULL width (k ==
            # efs); the exact tier does the final cut to k in stage 3b
            efs_eff = max(knn.efs or 2 * k, k)
            params = idx._params(efs_eff, efs_eff, knn.heuristic)
        else:
            params = idx._params(k, knn.efs or 2 * k, knn.heuristic)
        t0 = time.perf_counter()
        single = query.ndim == 1
        if sharded:
            res = self._run_sharded(idx, query, sel, params, max_batch,
                                    alive)
        elif single:
            res = self.programs.search(idx.graph, idx._prep_query(query),
                                       sel, params, sigma)
        else:
            res = self._run_batch(idx, query, sel, params,
                                  sigma if sigmas is None else sigmas,
                                  max_batch, engine)
        ids, dists = _host(res.ids), _host(res.dists)
        stats = SearchStats(*(_host(s) for s in res.stats))
        self._sync()
        timings.search_ms = (time.perf_counter() - t0) * 1e3

        # stage 3b: exact-tier re-rank (quantized residency only)
        if quantized:
            t0 = time.perf_counter()
            Qp = _host(idx._prep_query(query))
            if single:
                dists, ids = idx.exact.rerank(Qp, ids, k)
            else:
                dists, ids = idx.exact.rerank_many(Qp, ids, k)
            timings.rerank_ms = (time.perf_counter() - t0) * 1e3

        # stage 4: projection + limit
        t0 = time.perf_counter()
        if parts.limit is not None:
            ids = ids[..., :parts.limit]
            dists = dists[..., :parts.limit]
        columns = (self.store.node(table).rows(ids, parts.projections)
                   if parts.projections else {})
        timings.project_ms = (time.perf_counter() - t0) * 1e3
        return ResultSet(table=table, ids=ids, dists=dists, columns=columns,
                         sigma=sigma, timings=timings, stats=stats,
                         mask=mask, sigmas=sigmas)

    def _run_sharded(self, sn, query, sel, params, max_batch, alive):
        """Sharded kNN through the program cache's ``sharded`` arm; a
        single query is lifted to a one-lane batch and sliced back."""
        single = query.ndim == 1
        Q = torch.atleast_2d(sn._prep_query(query))
        alive = (np.ones(sn.n_shards, bool) if alive is None
                 else np.asarray(alive, bool))
        if alive.shape != (sn.n_shards,):
            raise ValueError(f"alive mask has shape {alive.shape}; index "
                             f"has {sn.n_shards} shards")

        def run(Qc, selc):
            return self.programs.search_sharded(sn, Qc, selc, alive, params)

        if not max_batch or Q.shape[0] <= max_batch:
            res = run(Q, sel)
        else:
            chunks = [run(Q[i:i + max_batch],
                          sel[:, i:i + max_batch] if sel.ndim == 3 else sel)
                      for i in range(0, Q.shape[0], max_batch)]
            res = type(chunks[0])(
                dists=torch.cat([c.dists for c in chunks]),
                ids=torch.cat([c.ids for c in chunks]),
                stats=SearchStats(*(torch.cat(f) for f in
                                    zip(*(c.stats for c in chunks)))))
        if single:
            res = type(res)(dists=res.dists[0], ids=res.ids[0],
                            stats=SearchStats(*(f[0] for f in res.stats)))
        return res

    def _run_batch(self, idx, query, sel, params, sigma, max_batch,
                   engine="batched"):
        run = self.programs.batch(engine)
        Q = idx._prep_query(query)
        if not max_batch or Q.shape[0] <= max_batch:
            return run(idx.graph, Q, sel, params, sigma)

        def chunk_of(x, i):
            """Per-lane operands (2-D sel, [b] sigma) chunk with the
            query rows; shared operands pass through whole."""
            return x[i:i + max_batch] if np.ndim(x) >= 1 else x

        chunks = [run(idx.graph, Q[i:i + max_batch],
                      chunk_of(sel, i) if sel.ndim == 2 else sel,
                      params, chunk_of(sigma, i))
                  for i in range(0, Q.shape[0], max_batch)]
        return type(chunks[0])(
            dists=torch.cat([c.dists for c in chunks]),
            ids=torch.cat([c.ids for c in chunks]),
            stats=SearchStats(*(torch.cat(f) for f in
                                zip(*(c.stats for c in chunks)))))

    def _finish_selection(self, parts, table, mask, sigma,
                          timings) -> ResultSet:
        """Pure Q_S plan (no kNN): rows are the selected node ids."""
        ids = (np.flatnonzero(mask) if mask is not None
               else np.arange(self.store.node(table).n))
        t0 = time.perf_counter()
        if parts.limit is not None:
            ids = ids[:parts.limit]
        columns = (self.store.node(table).rows(ids, parts.projections)
                   if parts.projections else {})
        timings.project_ms = (time.perf_counter() - t0) * 1e3
        return ResultSet(table=table, ids=ids, dists=None, columns=columns,
                         sigma=sigma, timings=timings, mask=mask)

    # -- introspection -------------------------------------------------------
    def explain(self, plan) -> str:
        """Compact textual plan tree (top-down), Kuzu-EXPLAIN style."""
        as_plan = getattr(plan, "plan", None)
        if callable(as_plan):
            plan = as_plan()

        lines: list[str] = []

        def walk(node, depth):
            pad = "  " * depth
            name = type(node).__name__
            fields = {f.name: getattr(node, f.name)
                      for f in dataclasses.fields(node)
                      if f.name not in ("child", "left", "right")}
            args = ", ".join(f"{k}={v!r}" for k, v in fields.items()
                             if v is not None and v != ())
            lines.append(f"{pad}{name}({args})")
            for attr in ("child", "left", "right"):
                sub = getattr(node, attr, None)
                if sub is not None:
                    walk(sub, depth + 1)

        walk(plan, 0)
        return "\n".join(lines)
