"""The live serving front door: :class:`SearchService` (port of
``repro.serving.service``).

Where ``SearchEngine.drain()`` serves a *closed* queue (everything
submitted up front, loop until empty), ``SearchService`` runs the same
:class:`~repro_torch.serving.lanes.LaneBatch` machine *forever*: clients
``submit()`` from any thread (or ``await asubmit()``), the device loop
advances in ``step_iters``-sized chunks, and between chunks it

1. expires queue items whose deadline already passed (they never get a
   lane; their futures resolve to a ``timeout`` response) -- host-only
   work that OVERLAPS the chunk still in flight from the previous tick,
2. waits on that chunk, then finalizes converged lanes (``ok``) and
   evicts in-flight lanes past their deadline -- finalizing FIRST so a
   beam that already covers k valid candidates is salvaged as a
   ``"partial"`` best-effort answer; otherwise the response is
   ``"timeout"`` with all ids ``-1`` (never a truncated id list),
3. admits new requests from the :class:`SubmissionQueue` into freed
   lanes (deadline-ordered, selectivity-binned; see ``queues.py``),
4. enqueues the next chunk on the card's stream and resolves the
   finalized futures while it runs.

Every device call runs on the thread that drives the loop (the background
thread, or the caller of ``_tick``). Client threads do host work only:
the prefilter and its pack (numpy), and the query's prep, copied back to
the host.

Shard liveness of a sharded entry is a static ``alive`` mask or
heartbeat-derived (:class:`HeartbeatMonitor`): the mask is recomputed at
every finalize, so a straggler shard flips responses to ``degraded``
automatically. Because :class:`ShardedNavix` masks shards only at the
finalize merge, answers under a stale shard equal the alive-restricted
search exactly. Either on an unsharded entry raises.

Drive it with the background thread (``start()`` / ``shutdown()``) or
tick it by hand (``_tick()``) for deterministic tests. ``shutdown``
with ``drain=True`` answers every submitted rid exactly once before
returning; ``drain=False`` cancels outstanding futures.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.api.db import NavixDB
from repro_torch.api.plan_compile import _bucket
from repro_torch.query.operators import output_table, split_pipeline
from repro_torch.serving.engine import (Response, canonical_plan,
                                        resolve_alive)
from repro_torch.serving.lanes import LaneBatch
from repro_torch.serving.queues import ServiceClosed, SubmissionQueue


@dataclasses.dataclass
class _Pending:
    """Everything the device loop needs about one in-flight submission.
    Lives as ``QueueItem.meta`` while queued, then as ``LaneBatch.meta``
    while occupying a lane."""
    rid: int
    fut: Future
    k: int
    efs: int                     # this request's OWN efs (<= the service
                                 # cap): its lane's beam tail beyond efs
                                 # is masked, so small-efs requests skip
                                 # cap-wide beam maintenance
    sigma: float
    pf_ms: float                 # this submission's prefilter charge (the
                                 # first carrier of a Q_S pays its wall
                                 # time; later cache hits pay 0)
    deadline: Optional[float]
    t_enqueue: float
    t_start: float = 0.0         # set at lane admission
    qrow: Optional[np.ndarray] = None
    sel_row: Optional[np.ndarray] = None


class SearchService:
    """Async front door over one catalog index entry.

    The device program is fixed at construction (``k_cap`` / ``efs_cap``
    / ``heuristic`` / batch size): a live loop cannot re-derive caps per
    drain, so submissions exceeding them are rejected at ``submit``.
    ``clock`` is injectable -- deadlines, queue timestamps, and latency
    accounting all run on it, so tests drive a fake clock.
    """

    def __init__(self, db: NavixDB, index: Optional[str] = None,
                 heuristic: str = "adaptive_local", k_cap: int = 10,
                 efs_cap: int = 0, max_batch: int = 16,
                 step_iters: int = 32,
                 default_deadline_s: Optional[float] = None,
                 queue: Optional[SubmissionQueue] = None,
                 queue_size: int = 256, policy: str = "reject",
                 high_watermark: Optional[int] = None,
                 low_watermark: Optional[int] = None,
                 alive: Optional[np.ndarray] = None,
                 heartbeats: Optional[object] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 window: int = 1024, sel_cache_size: int = 128):
        self.db = db
        name = index if index is not None else next(iter(db.catalog), None)
        if name is None or name not in db.catalog:
            raise ValueError(f"no catalog index {name!r}; create one with "
                             "db.create_index(...)")
        self.entry = db.catalog[name]
        self.heuristic = heuristic
        self.k_cap = k_cap
        self.efs_cap = max(efs_cap or 2 * k_cap, k_cap)
        self.step_iters = step_iters
        self.default_deadline_s = default_deadline_s
        self.clock = clock
        self.alive = alive
        self.heartbeats = heartbeats
        # fail fast on an inconsistent liveness config instead of at the
        # first finalize (mid-service, inside the device loop)
        resolve_alive(getattr(self.entry.index, "n_shards", 0), alive,
                      heartbeats)
        self.lanes = LaneBatch(self.entry.index, heuristic, k_cap,
                               self.efs_cap, _bucket(max(1, max_batch)))
        self.queue = queue if queue is not None else SubmissionQueue(
            maxsize=queue_size, policy=policy,
            high_watermark=high_watermark, low_watermark=low_watermark)
        # Q_S -> (row, sigma, ms), LRU-bounded: each packed row is
        # ~n/32 words, so an unbounded cache leaks memory on
        # a long-running service with many distinct selections. An
        # evicted Q_S is simply re-prefiltered on its next submission
        # (whose carrier then pays the wall time again).
        if sel_cache_size < 1:
            raise ValueError("sel_cache_size must be >= 1")
        self.sel_cache_size = sel_cache_size
        self._sel_cache: OrderedDict[Any, tuple] = OrderedDict()  # guarded-by: _submit_lock
        self._submit_lock = threading.Lock()
        self._lat_lock = threading.Lock()
        self._next_rid = 0                       # guarded-by: _submit_lock
        self.n_submitted = 0                     # guarded-by: _lat_lock
        self.n_done = 0                          # guarded-by: _lat_lock
        self.n_timeout = 0                       # guarded-by: _lat_lock
        self.n_partial = 0                       # guarded-by: _lat_lock
        self._lat = deque(maxlen=window)         # guarded-by: _lat_lock  (total ms, rolling)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._draining = False
        self.closed = False

    # -- client side --------------------------------------------------------
    def submit(self, query, plan=None, k: Optional[int] = None,
               deadline_s: Optional[float] = None,
               block_timeout: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to a
        :class:`Response` (status ``ok`` / ``partial`` / ``timeout``).
        Raises :class:`QueueFull` under ``reject`` backpressure (or after
        ``block_timeout`` seconds under ``block``), :class:`ServiceClosed`
        after shutdown, ``ValueError`` if the plan exceeds the service's
        fixed program (k/efs caps, heuristic, target index)."""
        if self.closed or self.queue.closed:
            raise ServiceClosed("service is shut down")
        k = k if k is not None else self.k_cap
        plan = canonical_plan(self.db, self.entry.name, plan, k, 0,
                              self.heuristic)
        parts = split_pipeline(plan)
        entry = self.db._resolve(parts.knn,
                                 output_table(plan, self.db.store))
        if entry.name != self.entry.name:
            raise ValueError(f"plan targets index {entry.name!r}; this "
                             f"service serves {self.entry.name!r}")
        if parts.knn.heuristic != self.heuristic:
            raise ValueError(f"plan heuristic {parts.knn.heuristic!r} != "
                             f"service program {self.heuristic!r}")
        k_r = parts.knn.k
        efs_r = max(parts.knn.efs or 2 * k_r, k_r)
        if k_r > self.k_cap or efs_r > self.efs_cap:
            raise ValueError(f"k={k_r}/efs={efs_r} exceed the service "
                             f"program caps (k_cap={self.k_cap}, "
                             f"efs_cap={self.efs_cap})")
        # ragged per-lane efs: a plan that names its efs gets exactly
        # that beam width (its lane skips cap-wide beam maintenance); an
        # unset efs keeps the historical cap-wide beam
        efs_lane = (min(max(parts.knn.efs, k_r), self.efs_cap)
                    if parts.knn.efs else self.efs_cap)
        # prefilter + pack in the SUBMITTER's thread (host numpy): the
        # device loop never blocks on a prefilter, and the queue can bin by
        # the resulting sigma. One prefilter per distinct Q_S for the
        # service's lifetime; the first carrier pays.
        with self._submit_lock:
            s = parts.selection
            if s not in self._sel_cache:
                if s is None:
                    self._sel_cache[s] = (self.lanes.backend.full_row(),
                                          1.0, 0.0)
                else:
                    qres = self.db.prefilter(s)
                    self._sel_cache[s] = (
                        self.lanes.backend.pack_row(qres.mask),
                        qres.selectivity, qres.seconds * 1e3)
                row, sigma, pf_ms = self._sel_cache[s]
                while len(self._sel_cache) > self.sel_cache_size:
                    self._sel_cache.popitem(last=False)
            else:
                self._sel_cache.move_to_end(s)
                row, sigma, _ = self._sel_cache[s]
                pf_ms = 0.0
            rid = self._next_rid
            self._next_rid += 1
        # the loop's query row, prepped as the engine preps it and copied
        # back to the host at once
        qrow = self.entry.index._prep_query(
            np.asarray(query, np.float32)[None]).cpu().numpy()[0]
        now = self.clock()
        ddl_s = deadline_s if deadline_s is not None \
            else self.default_deadline_s
        pend = _Pending(rid=rid, fut=Future(), k=k_r, efs=efs_lane,
                        sigma=float(sigma), pf_ms=pf_ms,
                        deadline=None if ddl_s is None else now + ddl_s,
                        t_enqueue=now, qrow=qrow, sel_row=row)
        self.queue.put(sigma, pend.deadline, pend,
                       timeout=block_timeout, now=now)
        with self._lat_lock:
            self.n_submitted += 1
        return pend.fut

    async def asubmit(self, query, plan=None, k: Optional[int] = None,
                      deadline_s: Optional[float] = None) -> Response:
        """Asyncio driver: awaits the response. ``submit`` may block
        under ``block`` backpressure, so it runs in the default
        executor."""
        import asyncio
        loop = asyncio.get_running_loop()
        fut = await loop.run_in_executor(
            None, lambda: self.submit(query, plan, k, deadline_s))
        return await asyncio.wrap_future(fut)

    # -- device loop --------------------------------------------------------
    def _alive(self) -> np.ndarray:
        return resolve_alive(self.lanes.n_shards, self.alive,
                             self.heartbeats)

    def _resolve(self, pend: _Pending, resp: Response) -> None:
        if not pend.fut.done():
            pend.fut.set_result(resp)
            # gauges() reads the counters and iterates this deque from
            # other threads; an unguarded update can tear that poll
            with self._lat_lock:
                self.n_done += 1
                self._lat.append(resp.queue_ms + resp.exec_ms
                                 + resp.prefilter_ms)
                if resp.status == "timeout":
                    self.n_timeout += 1
                elif resp.status == "partial":
                    self.n_partial += 1

    def _emit_timeout(self, pend: _Pending, now: float) -> None:
        self._resolve(pend, Response(
            rid=pend.rid, ids=np.full(pend.k, -1, np.int64),
            dists=np.full(pend.k, np.inf, np.float32),
            queue_ms=(now - pend.t_enqueue) * 1e3, exec_ms=0.0,
            prefilter_ms=pend.pf_ms, sigma=pend.sigma,
            degraded=False, status="timeout"))

    def _tick(self, now: Optional[float] = None) -> bool:
        """One service-loop iteration: expire -> wait on the previous
        chunk -> finalize (converged + overdue) -> admit -> dispatch the
        next chunk -> resolve futures. Returns False when there was
        nothing to do (the thread driver then parks on the queue). Call
        directly for deterministic single-threaded tests.

        Overlapped stepping: the chunk dispatched at the END of each tick
        (enqueued, async) is waited on at the TOP of the next, so
        queue expiry overlaps the in-flight chunk and future resolution
        overlaps the next one. A lane that both converged in the chunk
        and passed its deadline while in flight resolves ``ok`` --
        convergence takes precedence, matching the synchronous order
        where the step emitted it before the deadline check could run.
        """
        now = self.clock() if now is None else now
        worked = False

        # 1. queue-side expiry: deadline passed before a lane freed up
        # (host-only -- runs while the previous chunk is still in flight)
        for it in self.queue.expire(now):
            self._emit_timeout(it.meta, now)
            worked = True

        # 2. synchronize on the chunk dispatched last tick (the ONE
        # device sync per tick)
        live = self.lanes.step_wait() if self.lanes.step_pending else None
        t_done = self.clock()

        # 3. one finalize covers both converged and overdue lanes.
        # Finalize FIRST for overdue lanes: a beam that already holds k
        # valid candidates is a usable best-effort answer ("partial");
        # anything less resolves to "timeout" with ALL ids -1 -- a
        # truncated list would silently read as a full top-k. Evicted
        # lanes park on device (live=False) so the next admit reuses
        # them. Responses are built here but resolved AFTER the next
        # chunk is dispatched (step 6).
        conv = ([] if live is None else
                [i for i in self.lanes.occupied() if not live[i]])
        overdue = [i for i in self.lanes.occupied()
                   if i not in conv
                   and self.lanes.meta[i].deadline is not None
                   and self.lanes.meta[i].deadline < now]
        rows: list[tuple] = []
        if conv or overdue:
            alive = self._alive()
            degraded = self.lanes.n_shards > 0 and not alive.all()
            ids, dists = self.lanes.finalize(alive)
            for i in conv:
                pend = self.lanes.meta[i]
                rows.append((pend, Response(
                    rid=pend.rid, ids=ids[i, :pend.k],
                    dists=dists[i, :pend.k],
                    queue_ms=(pend.t_start - pend.t_enqueue) * 1e3,
                    exec_ms=(t_done - pend.t_start) * 1e3,
                    prefilter_ms=pend.pf_ms, sigma=pend.sigma,
                    degraded=degraded, status="ok")))
                self.lanes.release(i)
            for i in overdue:
                pend = self.lanes.meta[i]
                got = ids[i, :pend.k]
                if (got >= 0).all():
                    rows.append((pend, Response(
                        rid=pend.rid, ids=got, dists=dists[i, :pend.k],
                        queue_ms=(pend.t_start - pend.t_enqueue) * 1e3,
                        exec_ms=(now - pend.t_start) * 1e3,
                        prefilter_ms=pend.pf_ms, sigma=pend.sigma,
                        degraded=degraded, status="partial")))
                else:
                    rows.append((pend, None))    # timeout, built in step 6
            self.lanes.evict(overdue)
            worked = True

        # 4. admit from the queue into free lanes (the running lanes'
        # median sigma anchors the selectivity bin, keeping the fused
        # batch regime-coherent)
        n_free = self.lanes.free_count()
        if n_free:
            occ = self.lanes.occupied()
            prefer = (float(np.median(self.lanes.sigh[occ]))
                      if occ else None)
            batch = self.queue.pop_batch(n_free, prefer)
            if batch:
                entries = []
                for it in batch:
                    pend = it.meta
                    pend.t_start = now
                    entries.append((pend, pend.qrow, pend.sel_row,
                                    pend.sigma, pend.efs))
                self.lanes.admit(entries)
                worked = True

        # 5. dispatch the next chunk (enqueued, async). Always
        # chunked (never run-to-convergence): a live loop must return to
        # the queue between chunks.
        if self.lanes.occupied_count():
            self.lanes.step_async(self.step_iters)
            worked = True

        # 6. resolve futures -- host-only, overlapped with the chunk
        # dispatched above (Future callbacks run in this thread)
        for pend, resp in rows:
            if resp is None:
                self._emit_timeout(pend, now)
            else:
                self._resolve(pend, resp)
        return worked

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "SearchService":
        """Spawn the background device-loop thread (idempotent)."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="navix-serve",
                                            daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            worked = self._tick()
            if self._stop.is_set():
                if not self._draining:
                    break
                if (not worked and not len(self.queue)
                        and not self.lanes.occupied_count()):
                    break
            elif not worked:
                self.queue.wait_nonempty(0.01)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> bool:
        """Close the front door. ``drain=True`` first answers every
        submitted rid exactly once (blocked putters wake with
        :class:`ServiceClosed`); ``drain=False`` cancels every
        outstanding future. Returns True once fully shut down; False if
        the background thread is still draining when ``timeout`` expires
        -- the thread keeps sole ownership of the lane state (ticking it
        inline here would race it), so call ``shutdown`` again to keep
        waiting. Idempotent."""
        if self.closed:
            return True
        self.queue.close()
        self._draining = drain
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return False
            self._thread = None
        if drain:
            # manual-driver path (no thread ever ran, or it exited
            # before finishing a non-drain stop): finish inline
            while len(self.queue) or self.lanes.occupied_count():
                self._tick()
        else:
            for it in self.queue.drain_remaining():
                self._cancel(it.meta)
            # the loop thread exits right after dispatching a chunk
            # (tick step 5), so a non-drain stop usually lands here
            # with that chunk still in flight -- synchronize before
            # touching the lane state
            if self.lanes.step_pending:
                self.lanes.step_wait()
            occ = self.lanes.occupied()
            for i in occ:
                self._cancel(self.lanes.meta[i])
            self.lanes.evict(occ)
        self.closed = True
        return True

    @staticmethod
    def _cancel(pend: _Pending) -> None:
        if not pend.fut.done() and not pend.fut.cancel():
            pend.fut.set_exception(
                ServiceClosed("service shut down without drain"))

    def __enter__(self) -> "SearchService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc[0] is None)

    # -- observability ------------------------------------------------------
    def gauges(self) -> dict:
        """Live service gauges: queue depth/backpressure state, in-flight
        lanes, completion counters, rolling p50/p99 latency, and the
        cumulative host-vs-device chunk split (``chunks``: host work the
        device waited for vs host work hidden behind in-flight chunks vs
        time blocked on the device)."""
        g = {"queue": self.queue.gauges(),
             "in_flight": self.lanes.occupied_count(),
             "lanes": self.lanes.bsz,
             "chunks": self.lanes.timing()}
        with self._lat_lock:
            g.update(submitted=self.n_submitted, done=self.n_done,
                     timeouts=self.n_timeout, partials=self.n_partial)
            lat = list(self._lat)
        if lat:
            arr = np.asarray(lat)
            g["p50_ms"] = float(np.percentile(arr, 50))
            g["p99_ms"] = float(np.percentile(arr, 99))
        return g
