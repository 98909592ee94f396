"""Batched request serving for the vector index (port of
``repro.serving.engine``).

The search engine mirrors a production vector-serving tier over the
:class:`repro_torch.api.NavixDB` pipeline:
  * requests (query vector + declarative plan + k) accumulate in a queue;
    plans may be full ``KnnSearch`` trees (built with
    ``repro_torch.api.Q``) or
    bare selection subqueries (legacy form, wrapped automatically);
  * the default scheduler is **continuous batching** (the LLM-serving
    pattern applied to beam search): requests with *different* plans fuse
    into one device batch via per-lane ``[B, W]`` semimasks -- each lane
    searches its own selection subquery's S at its own selectivity, with
    per-lane k/efs capped to the batch max -- and a host-side step loop
    (``repro_torch.core.search_batch.engine_steps``) periodically compacts
    converged lanes out and refills them from the queue, so long-tail
    convergence gaps never strand SIMD lanes. Every distinct selection
    subquery is prefiltered exactly once per drain; its cost is shared by
    the requests that carry it (never amortized across unrelated plans);
  * ``scheduler="grouped"`` keeps the reference path: requests
    grouped by identical plan into ``NavixDB.execute`` calls (one shared
    semimask per group batch, whole-batch convergence);
  * per-request latency is recorded (queue + execution + own-plan
    prefilter share) and summarized as p50/p95/p99 -- the paper's latency
    protocol (warm-up + repeats) is implemented in the benchmark harness
    on top of this engine.

The same schedulers serve a
:class:`~repro_torch.core.distributed.ShardedNavix`: the continuous
scheduler's lane state gains the shard grid (refill masks apply to every
shard's copy of a lane) and converged lanes merge across shards at
finalize under the engine's ``alive`` mask, or the mask its
``heartbeats`` monitor derives. A shard marked dead mid-drain degrades
recall, not availability: responses finalized under a partial quorum are
flagged ``degraded`` and hold no id of a dead shard. ``alive=`` on an
unsharded index raises. ``greedy_generate`` is the LM family's helper:
prefill, then greedy decode steps against the KV cache.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, defaultdict, deque
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.api.db import NavixDB
from repro_torch.api.plan_compile import _bucket
from repro_torch.core.distributed import ShardedNavix
from repro_torch.query.operators import (KnnSearch, Plan, is_selection,
                                         output_table, split_pipeline)
from repro_torch.serving.lanes import LaneBatch
from repro_torch.storage.columnar import GraphStore


@dataclasses.dataclass
class Request:
    rid: int
    query: np.ndarray
    plan: Optional[Plan]          # KnnSearch tree or bare Q_S (None = unfiltered)
    k: int = 10
    t_enqueue: float = 0.0


@dataclasses.dataclass
class Response:
    rid: int
    ids: np.ndarray
    dists: np.ndarray
    queue_ms: float
    exec_ms: float
    prefilter_ms: float           # this request's share of its OWN plan's
                                  # prefilter wall time (shared only with
                                  # requests carrying the same Q_S)
    sigma: float                  # this request's own |S| / |V|
    degraded: bool = False        # finalized under a partial shard quorum
                                  # (sharded indexes only): some shards
                                  # were dead, so recall may be reduced
    status: str = "ok"            # terminal state: "ok" (converged),
                                  # "partial" (deadline hit but the beam
                                  # already covered k candidates -- a
                                  # best-effort answer), "timeout"
                                  # (deadline hit first; ids are all -1,
                                  # NEVER a truncated id list)

    @property
    def timeout(self) -> bool:
        return self.status == "timeout"


def canonical_plan(db: NavixDB, default_index: Optional[str],
                   plan: Optional[Plan], k: int, efs: int,
                   heuristic: str) -> Plan:
    """Normalize a submission to a hashable KnnSearch-rooted plan -- the
    fuse/group key: same plan => one prefilter + one compiled program.
    Shared by the closed-queue engine and the live SearchService."""
    builder_plan = getattr(plan, "plan", None)
    if callable(builder_plan):
        plan = builder_plan()
    if plan is None:
        # resolve lazily: the catalog may be populated after __init__
        name = default_index or next(iter(db.catalog), None)
        if name is None or name not in db.catalog:
            raise ValueError("unfiltered request but the NavixDB "
                             "catalog has no index; create one with "
                             "db.create_index(...)")
        entry = db.catalog[name]
        return KnnSearch(child=None, table=entry.table, k=k,
                         index=name, efs=efs, heuristic=heuristic)
    if is_selection(plan):
        return KnnSearch(child=plan, k=k, efs=efs, heuristic=heuristic)
    return plan                    # already declarative


def resolve_alive(n_shards: int, alive, heartbeats,
                  now: Optional[float] = None) -> np.ndarray:
    """The serving tier's single source of shard liveness.

    ``heartbeats`` (a
    :class:`repro_torch.serving.heartbeat.HeartbeatMonitor`)
    takes the place of a caller-set ``alive`` mask: the mask is DERIVED
    from per-shard heartbeat staleness at the moment of each finalize,
    so straggler shards degrade responses automatically. Setting both is
    ambiguous and raises; either on an unsharded index raises (same
    contract as ``NavixDB.execute(alive=...)``).
    """
    if heartbeats is not None:
        if alive is not None:
            raise ValueError("set either a heartbeat monitor or a static "
                             "alive mask, not both")
        if not n_shards:
            raise ValueError("heartbeat liveness quorum-masks sharded "
                             "indexes; this index is unsharded")
        mask = np.asarray(heartbeats.alive(now), bool)
        if mask.shape != (n_shards,):
            raise ValueError(f"heartbeat monitor tracks {mask.shape[0]} "
                             f"shards; the index has {n_shards}")
        return mask
    if alive is None:
        return np.ones(max(n_shards, 1), bool)
    if not n_shards:
        # mirror NavixDB.execute: silently ignoring a quorum mask on
        # an unsharded index would hide the caller's intent
        raise ValueError("alive quorum-masks sharded indexes; "
                         "this drain targets an unsharded index")
    mask = np.asarray(alive, bool)
    if mask.shape != (n_shards,):
        raise ValueError(f"alive has shape {mask.shape}; the "
                         f"index has {n_shards} shards")
    return mask


@dataclasses.dataclass
class SearchEngine:
    """Serving tier over a :class:`NavixDB`.

    Construct either from a ``db`` (preferred; serves declarative plans
    against its catalog) or from a bare ``index`` (+ optional ``store``),
    which is wrapped into a single-index NavixDB on the index's device.
    ``index`` may be a :class:`ShardedNavix`: both schedulers then run the
    sharded batched engine under the engine's shard liveness.
    """
    index: Optional[object] = None
    store: Optional[GraphStore] = None
    heuristic: str = "adaptive_local"
    efs: int = 0
    max_batch: int = 32
    db: Optional[NavixDB] = None
    default_index: Optional[str] = None    # catalog name for unfiltered kNN
    engine: str = "batched"                # grouped drains run the
                                           # batched-frontier engine;
                                           # "vmap" = reference oracle
    scheduler: str = "continuous"          # "continuous": mixed-plan fusing
                                           # with per-lane semimasks + lane
                                           # refill; "grouped": the PR-2
                                           # per-plan reference path
    step_iters: int = 32                   # device loop iterations per
                                           # continuous-batching step call
                                           # while requests are still queued
                                           # (an empty queue runs each step
                                           # to whole-batch convergence)
    refill_threshold: int = 0              # min free lanes before a refill
                                           # (compaction) is worth a device
                                           # call; 0 = auto (batch size / 2)
    alive: Optional[np.ndarray] = None     # shard liveness (sharded indexes
                                           # only): bool[S], None = all
                                           # alive; may flip mid-drain --
                                           # lanes finalized under a partial
                                           # quorum come back degraded
    heartbeats: Optional[object] = None    # a HeartbeatMonitor: shard
                                           # liveness DERIVED from per-shard
                                           # heartbeat staleness at every
                                           # finalize instead of a caller-
                                           # set mask (mutually exclusive
                                           # with ``alive``)
    step_hook: Optional[Callable] = None   # called after every continuous-
                                           # scheduler device step with a
                                           # progress dict (telemetry)

    def __post_init__(self):
        if self.db is None:
            if self.index is None:
                raise ValueError("SearchEngine needs a db= or an index=")
            self.db = NavixDB(self.store,
                              device=getattr(self.index, "device", None))
            self.db.register_index("default", self.index)
            self.default_index = "default"
        else:
            if self.default_index is None:
                self.default_index = next(iter(self.db.catalog), None)
            if self.index is None and self.default_index is not None:
                self.index = self.db.index(self.default_index)
        self.store = self.db.store
        self._queue: deque[Request] = deque()
        self._next_rid = 0
        self.latencies_ms: list[float] = []
        # queue-wait vs service-time split of the same requests, recorded
        # in lockstep with latencies_ms (service = exec + prefilter share)
        self.queue_waits_ms: list[float] = []
        self.service_ms: list[float] = []
        # host-vs-device split of every stepped chunk, summed over drains
        # (see LaneBatch.timing): host_gap = host work the device waited
        # for; dispatch = host time enqueueing the chunks; host_overlap =
        # host work hidden behind an in-flight chunk
        self.chunk_timing = {"n_chunks": 0, "host_gap_ms": 0.0,
                             "dispatch_ms": 0.0, "host_overlap_ms": 0.0,
                             "device_wait_ms": 0.0}
        # LaneBatch reuse across drains, keyed by the fused program shape:
        # building one per drain allocates its parked state (a [B, n + 1]
        # visited map) every time. A batch is only reusable when the
        # previous drain left it clean (all lanes free, no chunk in flight).
        self._lane_cache: "OrderedDict[Any, LaneBatch]" = OrderedDict()

    def _record_latency(self, queue_ms: float, service_ms: float) -> None:
        self.latencies_ms.append(queue_ms + service_ms)
        self.queue_waits_ms.append(queue_ms)
        self.service_ms.append(service_ms)

    # -- client API ---------------------------------------------------------
    def submit(self, query, plan: Optional[Plan] = None, k: int = 10) -> int:
        """Enqueue one request. ``plan`` may be a full declarative plan
        (``Q...knn(...)`` tree, in which case its own k/efs/heuristic
        apply), a bare selection subquery, or None (unfiltered)."""
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid=rid, query=np.asarray(query),
                                   plan=self._canonical(plan, k), k=k,
                                   t_enqueue=time.perf_counter()))
        return rid

    def drain(self) -> list[Response]:
        """Serve everything queued.

        ``scheduler="continuous"`` (default) fuses requests with
        *different* plans into shared device batches (per-lane semimasks,
        continuous lane refill); ``scheduler="grouped"`` batches only
        identical plans (the reference path). Every submitted rid is
        answered exactly once either way.
        """
        if self.scheduler not in ("continuous", "grouped"):
            # validate BEFORE popping the queue: a bad config must not
            # silently discard every queued request
            raise ValueError(f"unknown scheduler {self.scheduler!r}; "
                             f"valid: ('continuous', 'grouped')")
        reqs: list[Request] = []
        while self._queue:
            reqs.append(self._queue.popleft())
        if self.scheduler == "continuous":
            return self._drain_continuous(reqs)
        groups: dict[Any, list[Request]] = defaultdict(list)
        for r in reqs:
            groups[r.plan].append(r)
        out: list[Response] = []
        for plan, group in groups.items():
            out.extend(self._serve_group(plan, group))
        return out

    # -- internals ------------------------------------------------------------
    def _canonical(self, plan: Optional[Plan], k: int) -> Plan:
        """Normalize every submit to a hashable KnnSearch-rooted plan --
        the group key: same plan => one prefilter + one compiled program."""
        return canonical_plan(self.db, self.default_index, plan, k,
                              self.efs, self.heuristic)

    # -- continuous batching (mixed-plan fusing + lane refill) ---------------
    def _drain_continuous(self, reqs: list[Request]) -> list[Response]:
        """Fuse mixed-plan requests into shared device batches.

        Requests fuse when they target the same index with the same
        heuristic -- their selection subqueries (and k/efs) may all
        differ: each lane carries its own packed semimask, k/efs are
        capped to the batch max, and every distinct Q_S is prefiltered
        once. Per fuse group, a host step loop advances the batch in
        ``step_iters``-iteration chunks, finalizes converged lanes, and
        refills freed lanes from the queue (``refill_threshold`` sets how
        many free lanes make a compaction worth the device call).
        """
        fuse: dict[Any, list[tuple[Request, Any]]] = defaultdict(list)
        for r in reqs:
            parts = split_pipeline(r.plan)
            table = output_table(r.plan, self.db.store)
            entry = self.db._resolve(parts.knn, table)
            fuse[(entry.name, parts.knn.heuristic)].append((r, parts))
        out: list[Response] = []
        for (name, heuristic), items in fuse.items():
            out.extend(self._serve_fused(self.db.catalog[name].index,
                                         heuristic, items))
        return out

    def _current_alive(self, backend) -> np.ndarray:
        return resolve_alive(backend.n_shards, self.alive, self.heartbeats)

    def _lanes(self, idx, heuristic: str, k_cap: int, efs_cap: int,
               bsz: int) -> LaneBatch:
        """A clean LaneBatch for this fused program shape, reused across
        drains when possible. A dirty cache entry (a previous drain died
        with lanes occupied or a chunk in flight) is discarded rather
        than repaired."""
        key = (id(idx), heuristic, k_cap, efs_cap, bsz)
        lanes = self._lane_cache.get(key)
        if lanes is not None and not lanes.step_pending \
                and not lanes.occupied_count():
            self._lane_cache.move_to_end(key)
            lanes.reset_timing()
            return lanes
        lanes = LaneBatch(idx, heuristic, k_cap, efs_cap, bsz)
        self._lane_cache[key] = lanes
        self._lane_cache.move_to_end(key)
        while len(self._lane_cache) > 8:     # bound device-state residency
            self._lane_cache.popitem(last=False)
        return lanes

    def _serve_fused(self, idx, heuristic: str,
                     items: list[tuple[Request, Any]]) -> list[Response]:
        # per-lane k/efs, capped to the batch max: one static program
        # serves every fused request; lanes slice their own k at the end
        k_cap = max(p.knn.k for _, p in items)
        efs_cap = max(max(p.knn.efs or 2 * p.knn.k for _, p in items), k_cap)
        bsz = _bucket(max(1, min(self.max_batch, len(items))))
        lanes = self._lanes(idx, heuristic, k_cap, efs_cap, bsz)

        # one prefilter per DISTINCT selection subquery; its wall time is
        # shared only by the requests that carry it
        sel_info: dict[Any, list] = {}   # Q_S -> [packed_row, sigma, ms, cnt]
        full_row = lanes.backend.full_row()
        for r, parts in items:
            s = parts.selection
            if s not in sel_info:
                if s is None:
                    sel_info[s] = [full_row, 1.0, 0.0, 0]
                else:
                    qres = self.db.prefilter(s)
                    sel_info[s] = [lanes.backend.pack_row(qres.mask),
                                   qres.selectivity, qres.seconds * 1e3, 0]
            sel_info[s][3] += 1

        # selectivity-sorted admission: lanes running together then carry
        # similar-sigma subqueries and tend to take the same expansion
        # branch (the reference's engine skips the [B, M, M] second-degree
        # stage when no live lane takes it; the port's runs it masked).
        # Lane-for-lane results are order-independent.
        items = sorted(items,
                       key=lambda rp: -sel_info[rp[1].selection][1])

        # prep every query in ONE vectorized device call (a per-request
        # _prep_query inside the refill loop costs a dispatch each)
        prepped = idx._prep_query(
            np.stack([r.query for r, _ in items])).cpu().numpy()

        pending = deque((r, parts, prepped[j])
                        for j, (r, parts) in enumerate(items))

        bsz = lanes.bsz            # data-axis backends round the batch up
        refill_thr = self.refill_threshold or max(1, bsz // 2)
        responses: list[Response] = []
        done: dict[int, float] = {}    # converged lane -> t_done (state
                                       # stays frozen until flushed)
        n_devsteps = 0

        def collect():
            """Finalize every converged-but-unemitted lane (one device
            call for any number of them), free the lanes, and return the
            raw rows for ``emit``. The device sync lives HERE; ``emit`` is
            pure host work that the driver overlaps with the next
            in-flight chunk."""
            if not done:
                return []
            alive = self._current_alive(lanes.backend)
            degraded = lanes.n_shards > 0 and not alive.all()
            ids, dists = lanes.finalize(alive)
            rows = []
            for i, t_done in done.items():
                r, parts, t0 = lanes.meta[i]
                k_r = parts.knn.k
                rows.append((r, parts, t0, t_done,
                             ids[i, :k_r], dists[i, :k_r], degraded))
                lanes.release(i)
            done.clear()
            return rows

        def emit(rows):
            """Build + record the responses for ``collect``'s rows --
            host-only, safe to run while a device chunk is in flight."""
            for r, parts, t0, t_done, ids_i, dists_i, degraded in rows:
                _, sigma, pf_ms, cnt = sel_info[parts.selection]
                pf_share = pf_ms / cnt
                queue_ms = (t0 - r.t_enqueue) * 1e3
                exec_ms = (t_done - t0) * 1e3
                self._record_latency(queue_ms, exec_ms + pf_share)
                responses.append(Response(
                    rid=r.rid, ids=ids_i, dists=dists_i,
                    queue_ms=queue_ms, exec_ms=exec_ms,
                    prefilter_ms=pf_share, sigma=float(sigma),
                    degraded=degraded))

        while pending or lanes.occupied_count():
            n_running = lanes.occupied_count() - len(done)
            # free_count() already excludes converged-but-unflushed lanes
            # (their meta stays set until flush), so the reclaimable lane
            # count is free + done -- subtracting done here would reduce
            # the admission test to free >= thr, which never passes while
            # the batch is full, silently degrading continuous scheduling
            # to whole-batch convergence
            n_free = lanes.free_count()
            rows = []
            if pending and (n_free + len(done) >= refill_thr
                            or n_running == 0):
                rows = collect()        # compact converged lanes out ...
                entries = []            # ... and refill from the queue
                now = time.perf_counter()
                while pending and len(entries) < lanes.free_count():
                    r, parts, qrow = pending.popleft()
                    row, sigma, _, _ = sel_info[parts.selection]
                    # ragged per-lane efs only when the plan NAMES its
                    # efs; an unset efs keeps the cap-wide beam
                    efs_r = (min(max(parts.knn.efs, parts.knn.k), efs_cap)
                             if parts.knn.efs else efs_cap)
                    entries.append(((r, parts, now), qrow, row, sigma,
                                    efs_r))
                lanes.admit(entries)
            elif n_running == 0:
                # queue empty (a non-empty queue with zero running lanes
                # always takes the refill branch): only frozen converged
                # lanes remain
                break

            # with an empty queue there is nothing to refill between
            # chunks: run the remaining lanes straight to convergence.
            # Dispatch FIRST (enqueued, async), then do the host-side
            # response building for the lanes collected above while the
            # chunk is in flight; sync only on the chunk's liveness.
            n_steps = self.step_iters if pending else 0
            lanes.step_async(n_steps)
            emit(rows)
            live_np = lanes.step_wait()
            n_devsteps += 1
            if self.step_hook is not None:
                self.step_hook({"step": n_devsteps,
                                "live": int(live_np.sum()),
                                "pending": len(pending),
                                "done": len(done)})
            now = time.perf_counter()
            for i in range(bsz):
                if (lanes.meta[i] is not None and i not in done
                        and not live_np[i]):
                    done[i] = now
        emit(collect())
        for key, v in lanes.timing().items():
            self.chunk_timing[key] += v
        return responses

    def _serve_group(self, plan: Plan, reqs: list[Request]) -> list[Response]:
        Q = np.stack([r.query for r in reqs])
        parts = split_pipeline(plan)
        entry = self.db._resolve(parts.knn,
                                 output_table(plan, self.db.store))
        sharded = isinstance(entry.index, ShardedNavix)
        if self.alive is not None and not sharded:
            raise ValueError("engine.alive quorum-masks sharded indexes; "
                             f"index {entry.name!r} is unsharded")
        # one liveness read for the whole group, as the continuous
        # scheduler reads one a finalize
        alive = (resolve_alive(entry.index.n_shards, self.alive,
                               self.heartbeats) if sharded else None)
        degraded = bool(sharded and not alive.all())
        t1 = time.perf_counter()
        # engine passes through: db.execute rejects "vmap" on a sharded
        # index rather than this layer silently overriding it
        rs = self.db.execute(plan, query=Q, max_batch=self.max_batch,
                             engine=self.engine, alive=alive)
        # the prefilter ran once for the whole group: amortize its cost
        # (and the semimask pack) across the group's requests so the
        # latency summary reflects what each request actually paid
        pf_share = rs.timings.prefilter_ms / len(reqs)
        exec_ms = (rs.timings.pack_ms + rs.timings.search_ms
                   + rs.timings.project_ms) / len(reqs)
        responses = []
        for j, r in enumerate(reqs):
            queue_ms = (t1 - r.t_enqueue) * 1e3
            self._record_latency(queue_ms, exec_ms + pf_share)
            responses.append(Response(
                rid=r.rid, ids=rs.ids[j], dists=rs.dists[j],
                queue_ms=queue_ms, exec_ms=exec_ms,
                prefilter_ms=pf_share, sigma=rs.sigma,
                degraded=degraded))
        return responses

    def latency_summary(self) -> dict:
        """End-to-end p50/p95/p99 plus the queue-wait vs service-time
        split of the same requests (service = exec + prefilter share;
        queue = t_dequeue - Request.t_enqueue). ``chunks`` breaks every
        continuous-scheduler step chunk into host time the device waited
        for (``host_gap_ms``), host time enqueueing the chunk
        (``dispatch_ms``, the port's own: eager PyTorch issues every op
        from the host), host time hidden behind an in-flight chunk
        (``host_overlap_ms``), and time blocked on the device
        (``device_wait_ms``) -- the overlap win made observable."""
        if not self.latencies_ms:
            return {}
        arr = np.asarray(self.latencies_ms)
        qarr = np.asarray(self.queue_waits_ms)
        sarr = np.asarray(self.service_ms)
        out = {"n": len(arr), "p50_ms": float(np.percentile(arr, 50)),
               "p95_ms": float(np.percentile(arr, 95)),
               "p99_ms": float(np.percentile(arr, 99)),
               "mean_ms": float(arr.mean()),
               "queue_p50_ms": float(np.percentile(qarr, 50)),
               "queue_p99_ms": float(np.percentile(qarr, 99)),
               "service_p50_ms": float(np.percentile(sarr, 50)),
               "service_p95_ms": float(np.percentile(sarr, 95)),
               "service_p99_ms": float(np.percentile(sarr, 99))}
        if self.chunk_timing["n_chunks"]:
            out["chunks"] = dict(self.chunk_timing)
        return out


def greedy_generate(cfg, params, prompt_tokens: np.ndarray, n_new: int,
                    max_len: Optional[int] = None,
                    return_logits: bool = False,
                    on_step: Optional[Callable[[], None]] = None):
    """LM generation (prefill + greedy decode), the RAG example's helper:
    batch-first prompt tokens int32[B, S] -> the ``n_new`` greedy tokens
    int32[B, n_new] as numpy, on the device of ``params``. The cache holds
    ``max_len`` positions (default S + n_new). As in the reference, each
    of the ``n_new`` tokens is fed to a decode step, the last one's logits
    unused; ``return_logits`` returns them too (f32[B, V], on the device).
    The tokens stay on the device until the end: one copy to the host.
    ``on_step`` (if given) is called before the prefill is issued and
    after it and each decode step are issued (a caller records CUDA events
    there to time them on the stream)."""
    import torch

    from repro_torch.models.transformer import decode_step, prefill
    mark = on_step or (lambda: None)
    dev = params["embed"].device
    tokens = torch.as_tensor(np.asarray(prompt_tokens, np.int32), device=dev)
    b, s = tokens.shape
    out = torch.empty((b, n_new), dtype=torch.int32, device=dev)
    with torch.no_grad():
        mark()
        cache, logits = prefill(cfg, params, tokens,
                                max_len=max_len or s + n_new)
        mark()
        for i in range(n_new):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            out[:, i] = nxt
            cache, logits = decode_step(cfg, params, cache, nxt)
            mark()
    tokens_out = out.cpu().numpy()
    return (tokens_out, logits) if return_logits else tokens_out
