"""The device-side lane core shared by every serving driver (port of
``repro.serving.lanes``).

Both serving drivers -- the closed-queue ``SearchEngine.drain()`` and the
live :class:`~repro_torch.serving.service.SearchService` loop -- run the
same machine: a fixed ``[B]``-lane batch over the resumable stepping API
of ``repro_torch.core.search_batch`` (``parked_state`` / ``engine_refill``
/ ``engine_steps`` / ``engine_finalize`` / ``engine_evict``). This module
holds that machine so the two drivers stay in bitwise lockstep:

* ``_FlatLanes`` / ``_ShardLanes`` -- the backend split: the same lane
  operations over an unsharded :class:`NavixIndex` or a
  :class:`ShardedNavix` (whose semimask buffers gain a leading shard dim,
  whose state is one block a grid cell, and whose ``finalize`` merges the
  per-shard beams under an ``alive`` quorum mask);
* :class:`LaneBatch` -- host-side buffer management + the device calls:
  ``admit`` (fill free lanes with new requests), ``step`` (advance
  ``n_steps`` loop iterations, report per-lane liveness), ``finalize``
  (extract every lane's current beam), ``evict`` (park overdue lanes so
  they stop burning device work and become refillable).

Scheduling policy -- what to admit, when to flush, which lanes are past
deadline -- stays in the drivers; ``LaneBatch`` owns no policy beyond
"fill free lanes in ascending order", which both drivers rely on.

Overlapped stepping: ``step_async`` enqueues the next chunk on the current
CUDA stream, copies its per-lane liveness without blocking into a pinned
host tensor, records an event and returns; the host then runs finalize /
expire / refill / response work while the chunk runs, and ``step_wait``
synchronizes on that event, once per chunk. ``step`` is the synchronous
spelling. PyTorch has no buffer donation: ``LaneBatch`` holds the only
reference to the state and replaces it at every call; finalize / evict /
admit issued while a chunk is in flight queue behind it on the stream, so
results are bit for bit the synchronous order's. On the CPU both calls run
synchronously.

Semimask rows stay host ``uint32`` words (``bitset.pack_np``) and become
the port's int32 words only when placed on the device. Lane buffers are
placed from pageable host memory, which the copy stages before it returns,
so the host mirrors may be rewritten at once.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core import search_batch as sb
from repro_torch.core.distributed import ShardedNavix
from repro_torch.core.navix import NavixIndex


class _FlatLanes:
    """Device-side lane operations of the continuous scheduler over an
    unsharded :class:`NavixIndex` (the ``search_batch`` stepping API)."""

    n_shards = 0
    lane_multiple = 1
    exact = None

    def __init__(self, idx: NavixIndex, params):
        self.idx, self.graph, self.params = idx, idx.graph, params
        self.device = idx.device
        self._words = bitset.n_words(idx.graph.n)
        # int8-resident indexes carry an exact f32 tier; LaneBatch
        # re-ranks finalized beams against it (the serving-side re-rank)
        self.exact = idx.exact if idx.is_quantized else None
        # the unfiltered row, copied to the host once: client threads of
        # the live service read it without a device call
        self._full = bitset.to_words(idx.full_semimask())       # [W]

    def full_row(self) -> np.ndarray:
        return self._full

    def pack_row(self, mask) -> np.ndarray:
        # host-side pack: one numpy pass per distinct plan
        m = np.asarray(mask)
        if m.dtype == np.uint32:
            return m                                           # [W]
        return bitset.pack_np(m)                               # [W]

    def sel_buffer(self, bsz: int) -> np.ndarray:
        return np.zeros((bsz, self._words), np.uint32)

    def set_lane(self, selh: np.ndarray, i: int, row: np.ndarray) -> None:
        selh[i] = row

    def place_lanes(self, arr: np.ndarray) -> torch.Tensor:
        """Host [B, ...] lane buffer -> a new device tensor (from pageable
        memory: the buffer may be rewritten once this returns)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, non_blocking=True, copy=True)

    def place_sel(self, arr: np.ndarray) -> torch.Tensor:
        """Host uint32 [B, W] semimask words -> the port's int32 words
        (same bits) on the device."""
        return self.place_lanes(np.ascontiguousarray(arr).view(np.int32))

    def place_admit(self, Qh, selh, sigh, efsh, refill):
        """The admit-time lane buffers on the device; the refill mask stays
        on the host, where ``engine_refill`` reads its rows."""
        return (self.place_lanes(Qh), self.place_sel(selh),
                self.place_lanes(sigh), self.place_lanes(efsh),
                torch.from_numpy(refill.copy()))

    def parked(self, bsz: int):
        return (sb.parked_state(self.graph.n, bsz, self.params, self.device),
                torch.zeros(bsz, dtype=torch.int32, device=self.device))

    def refill(self, Qj, selj, st, udc, refill):
        return sb.engine_refill(self.graph, Qj, selj, st, udc, refill,
                                self.params)

    def steps(self, Qj, selj, st, n_steps, sigj, efsj):
        # enqueued on the current stream; the caller syncs on `live`
        return sb.engine_steps(self.graph, Qj, selj, st, self.params,
                               n_steps, sigma_g=sigj, efs_lanes=efsj)

    def finalize(self, st, udc, alive):
        fin = sb.engine_finalize(st, udc, self.params)
        return fin.ids, fin.dists

    def evict(self, st, udc, evict):
        return sb.engine_evict(st, udc, torch.from_numpy(np.array(evict)))


class _ShardLanes(_FlatLanes):
    """The same lane operations over a :class:`ShardedNavix`: semimask
    buffers gain a leading shard dim ([S, B, W] words), the state is the
    index's per-cell blocks, and ``finalize`` merges the per-shard beams
    into the global top-efs under the current ``alive`` mask. Lane
    buffers live on the grid's first cell, where the programs slice them
    per cell."""

    def __init__(self, sn: ShardedNavix, params):
        self.sn, self.params = sn, params
        self.device = sn.device
        self.n_shards = sn.n_shards
        self.lane_multiple = sn.lane_shards
        # sharded indexes stay f32-resident (no quantized tier)
        self.exact = None
        self._refill = sn.refill_program(params)
        self._steps = sn.steps_program(params)
        # beams-only finalize: the merged ids/dists of finalize_program
        # bit for bit, minus the stats reduction the drivers discard
        self._finalize = sn.finalize_beams_program(params)
        self._evict = sn.evict_program(params)
        self._full = sn.shard_semimask_np(np.ones(sn.n_total, bool))

    def pack_row(self, mask) -> np.ndarray:
        m = np.asarray(mask)
        if m.dtype == np.uint32:
            return m                                           # [S, W]
        return self.sn.shard_semimask_np(m)                    # [S, W]

    def sel_buffer(self, bsz: int) -> np.ndarray:
        return np.zeros((self.n_shards, bsz, self.sn.n_words_local),
                        np.uint32)

    def set_lane(self, selh: np.ndarray, i: int, row: np.ndarray) -> None:
        selh[:, i] = row

    def parked(self, bsz: int):
        return self.sn.parked_state(bsz, self.params)

    def refill(self, Qj, selj, st, udc, refill):
        return self._refill(self.sn.graphs, Qj, selj, st, udc, refill)

    def steps(self, Qj, selj, st, n_steps, sigj, efsj):
        # sigj unused: each shard's lanes estimate selectivity against
        # their own slice of S (lane-local, shard-local)
        return self._steps(self.sn.graphs, Qj, selj, st, n_steps,
                           efs_lanes=efsj)

    def finalize(self, st, udc, alive):
        d, ids = self._finalize(st, udc, alive)
        return ids, d

    def evict(self, st, udc, evict):
        return self._evict(st, udc, np.array(evict))


def _backend_class(idx):
    """The backend split: :class:`ShardedNavix` -> ``_ShardLanes``,
    :class:`NavixIndex` -> ``_FlatLanes``; anything else raises."""
    if isinstance(idx, ShardedNavix):
        return _ShardLanes
    if isinstance(idx, NavixIndex):
        return _FlatLanes
    raise TypeError(f"serving a {type(idx).__name__}: the port serves "
                    f"NavixIndex and ShardedNavix entries")


def make_backend(idx, params):
    """The lane backend that serves ``idx`` under ``params``."""
    return _backend_class(idx)(idx, params)


class LaneBatch:
    """A resumable ``[B]``-lane device batch with host-side bookkeeping.

    Each lane is free (``meta[i] is None``) or carries one in-flight
    request's opaque driver payload. Device state (`st`, `udc`) and the
    host mirrors of the lane buffers (query rows, packed per-lane
    semimasks, per-lane sigma and efs) live here; drivers decide *when* to
    call ``admit`` / ``step`` / ``finalize`` / ``evict`` and what the
    payloads mean. Admission fills free lanes in ascending index order.
    """

    def __init__(self, idx, heuristic: str, k_cap: int, efs_cap: int,
                 bsz: int):
        backend = _backend_class(idx)   # a non-index raises by name first
        self.params = idx._params(k_cap, efs_cap, heuristic)
        self.backend = backend(idx, self.params)
        # data-axis backends split the lane dim into lane_multiple
        # blocks; round the batch up so it divides evenly
        lm = self.backend.lane_multiple
        bsz = -(-bsz // lm) * lm
        self.bsz = bsz
        self.k_cap, self.efs_cap = k_cap, efs_cap
        self.device = self.backend.device
        dim = idx.dim if isinstance(idx, ShardedNavix) else idx.graph.dim
        self.Qh = np.zeros((bsz, dim), np.float32)
        self.selh = self.backend.sel_buffer(bsz)
        self.sigh = np.ones((bsz,), np.float32)
        # per-lane efs: free/uniform lanes sit at the cap (the masked
        # beam tail is then empty, bitwise-identical to no masking)
        self.efsh = np.full((bsz,), efs_cap, np.int32)
        self.meta: list[Optional[Any]] = [None] * bsz
        self.st, self.udc = self.backend.parked(bsz)
        self.Qj = self.backend.place_lanes(self.Qh)
        self.selj = self.backend.place_sel(self.selh)
        self.sigj = self.backend.place_lanes(self.sigh)
        self.efsj = self.backend.place_lanes(self.efsh)
        # each chunk's live[B] lands here: pinned on the card, so its copy
        # is enqueued without blocking the host
        self._live_host = torch.zeros(
            bsz, dtype=torch.bool, pin_memory=self.device.type == "cuda")
        self._pending = False              # a chunk awaits step_wait
        self._live_ready: Optional[torch.cuda.Event] = None
        # overlapped-stepping bookkeeping (host-vs-device observability)
        self._t_dispatched = 0.0
        self._t_wait_end = time.perf_counter()
        self.n_chunks = 0
        self.host_gap_ms = 0.0      # host work NOT overlapped (wait->dispatch)
        self.dispatch_ms = 0.0      # host time enqueueing the chunks (eager
                                    # PyTorch issues each op from the host;
                                    # an n_steps=0 chunk also reads the device)
        self.host_overlap_ms = 0.0  # host work overlapped (dispatch->wait)
        self.device_wait_ms = 0.0   # blocked on the device inside step_wait

    @property
    def n_shards(self) -> int:
        return self.backend.n_shards

    def occupied(self) -> list[int]:
        return [i for i in range(self.bsz) if self.meta[i] is not None]

    def occupied_count(self) -> int:
        return sum(1 for m in self.meta if m is not None)

    def free_count(self) -> int:
        return self.bsz - self.occupied_count()

    def release(self, i: int) -> None:
        """Free a lane host-side. Its frozen device state is inert (a
        converged/parked lane never advances) and the next ``admit``
        overwrites it."""
        self.meta[i] = None

    # -- device calls ---------------------------------------------------
    def admit(self, entries) -> list[int]:
        """Fill free lanes (ascending) from ``entries`` -- an iterable of
        ``(meta, qrow, sel_row, sigma, efs)`` -- and run ONE device refill
        for all of them (``efs`` is clamped to ``[1, efs_cap]``). Returns
        the lane indices used; raises if more entries arrive than there
        are free lanes."""
        refill = np.zeros(self.bsz, bool)
        used: list[int] = []
        it = iter(entries)
        entry = next(it, None)
        for i in range(self.bsz):
            if entry is None:
                break
            if self.meta[i] is not None:
                continue
            meta, qrow, row, sigma, efs = entry
            self.Qh[i] = qrow
            self.backend.set_lane(self.selh, i, row)
            self.sigh[i] = sigma
            self.efsh[i] = min(max(int(efs), 1), self.efs_cap)
            self.meta[i] = meta
            refill[i] = True
            used.append(i)
            entry = next(it, None)
        if entry is not None:
            raise ValueError("more entries than free lanes; size the "
                             "admission to LaneBatch.free_count()")
        if not used:
            return used
        (self.Qj, self.selj, self.sigj, self.efsj,
         refill_t) = self.backend.place_admit(
            self.Qh, self.selh, self.sigh, self.efsh, refill)
        self.st, self.udc = self.backend.refill(
            self.Qj, self.selj, self.st, self.udc, refill_t)
        return used

    @property
    def step_pending(self) -> bool:
        """True while a dispatched device chunk has not been waited on."""
        return self._pending

    def step_async(self, n_steps: int) -> None:
        """Enqueue the next device chunk (``n_steps`` loop iterations; 0 =
        run to whole-batch convergence, which reads the device as it goes)
        and return without waiting for it on the card. Host work between
        this call and :meth:`step_wait` overlaps the device."""
        if self._pending:
            raise RuntimeError("a device chunk is already in flight; "
                               "step_wait() it first")
        t0 = time.perf_counter()
        self.host_gap_ms += (t0 - self._t_wait_end) * 1e3
        self.st, live = self.backend.steps(
            self.Qj, self.selj, self.st, n_steps, self.sigj, self.efsj)
        if self.device.type == "cuda":
            self._live_host.copy_(live, non_blocking=True)
            self._live_ready = torch.cuda.Event()
            self._live_ready.record()
        else:
            self._live_host.copy_(live)
        self._pending = True
        self._t_dispatched = time.perf_counter()
        self.dispatch_ms += (self._t_dispatched - t0) * 1e3

    def step_wait(self) -> np.ndarray:
        """Synchronize on the in-flight chunk; returns live bool[B].
        The ONE host sync per chunk lives here."""
        if not self._pending:
            raise RuntimeError("no device chunk in flight; step_async() "
                               "first")
        t1 = time.perf_counter()
        self.host_overlap_ms += (t1 - self._t_dispatched) * 1e3
        if self._live_ready is not None:
            # the chunk boundary: the ONE host sync per chunk (the host
            # scheduler branches on liveness between device chunks)
            self._live_ready.synchronize()
            self._live_ready = None
        live = self._live_host.numpy().copy()
        self._pending = False
        t2 = time.perf_counter()
        self.device_wait_ms += (t2 - t1) * 1e3
        self._t_wait_end = t2
        self.n_chunks += 1
        return live

    def step(self, n_steps: int) -> np.ndarray:
        """Advance every lane by ``n_steps`` loop iterations (0 = run to
        whole-batch convergence); returns live bool[B]. The synchronous
        spelling of ``step_async`` + ``step_wait``."""
        self.step_async(n_steps)
        return self.step_wait()

    def timing(self) -> dict:
        """Cumulative host-vs-device split over every stepped chunk."""
        return {"n_chunks": self.n_chunks,
                "host_gap_ms": self.host_gap_ms,
                "dispatch_ms": self.dispatch_ms,
                "host_overlap_ms": self.host_overlap_ms,
                "device_wait_ms": self.device_wait_ms}

    def reset_timing(self) -> None:
        """Zero the chunk counters and re-anchor the gap clock. A reused
        batch (the closed-queue engine keeps LaneBatches across drains to
        skip the parked state's allocation) would otherwise charge the
        idle time between drains as host_gap."""
        self.n_chunks = 0
        self.host_gap_ms = self.host_overlap_ms = self.device_wait_ms = 0.0
        self.dispatch_ms = 0.0
        self._t_wait_end = time.perf_counter()

    def finalize(self, alive) -> tuple[np.ndarray, np.ndarray]:
        """Extract every lane's current beam (``alive`` is the sharded
        backends' quorum mask; the flat backend ignores it). Returns host
        ``(ids[B, efs], dists[B, efs])``.

        Quantized-resident backends finish here: the full-width beam
        (searched on int8 codes) is exactly re-ranked against the host
        f32 tier, lane-vectorized, so every driver's ``[:k]`` slice of a
        finalized lane is already exact-ordered. Parked/free lanes are
        all ``-1`` and stay all ``-1`` through the re-rank."""
        ids, dists = self.backend.finalize(self.st, self.udc, alive)
        # THE finalize boundary: results cross to the host once a finalize
        ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
        exact = self.backend.exact
        if exact is not None:
            # exact-tier re-rank: host-side numpy at the same finalize
            # boundary (prepped queries already mirrored in Qh)
            dists, ids = exact.rerank_many(self.Qh, ids, ids.shape[1])
        return ids, dists

    def evict(self, lane_ids) -> None:
        """Park the given lanes (one device call) and free them. Parked
        lanes report live=False and finalize to all ``-1`` ids until the
        next admit overwrites them -- finalize BEFORE evicting to salvage
        a partial beam."""
        lane_ids = list(lane_ids)
        if not lane_ids:
            return
        mask = np.zeros(self.bsz, bool)
        mask[lane_ids] = True
        self.st, self.udc = self.backend.evict(self.st, self.udc, mask)
        for i in lane_ids:
            self.meta[i] = None
