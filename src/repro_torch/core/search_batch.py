"""Batched-frontier beam search (port of ``repro.core.search_batch``).

One loop over a ``[B, efs]`` beam state serves a whole batch of queries:

* **per-query live mask** -- each lane carries the single-query
  convergence predicate; a converged lane's state is frozen and its
  candidate ids are masked to ``-1`` before the shared gathers, so it adds
  no distance computations while the rest of the batch finishes;
* **per-lane semimasks** -- ``sel_bits`` is one shared ``[W]`` bitset or a
  per-lane ``[B, W]`` stack, and every selectivity decision is lane-local;
* **masked unified expansion** -- onehop-s, directed and blind share one
  ``[B, M + K2]`` candidate layout: one ``[B, M]`` gather+distance serves
  all three first-degree passes, the branches differ only in masks;
* **per-lane adaptive-local choice** -- sigma_l and the paper's rule are
  evaluated per lane against the lane's own S.

Lane for lane the state transition equals the single-query
``repro_torch.core.search.search`` with that lane's semimask.

Where the reference loops on the device (``lax.while_loop``) and skips the
second-degree stage with ``lax.cond``, eager PyTorch would read the device
back every iteration. This engine instead steps in fixed chunks of
``CHUNK`` iterations and reads one ``any(live)`` per chunk. The
second-degree stage runs masked, so lanes that take no second hop yield
``-1`` / ``+inf`` there; it is skipped outright only when the heuristic
cannot take a second hop (onehop-s, onehop-a), which is known before the
loop. A lane that has converged is frozen by the live mask, so the extra
masked iterations change nothing.

Every distance goes through :func:`batch_gather_dist`, i.e.
``kernels.ops.gather_distance_batch`` for f32 vectors and
``kernels.ops.quantized_gather_distance_batch`` for an int8-resident
store: the hand-written CUDA kernels for CUDA tensors, their plain PyTorch
versions for CPU tensors.

``efs_lanes`` (an int32[B] per-lane efs) makes the beam ragged: each lane
is bit for bit a search at its own efs.

The ``engine_*`` stepping API at the bottom cuts the same loop into
resumable chunks (park / refill / step / evict / finalize) for the serving
tier's continuous scheduler. PyTorch has no buffer donation, so there are
no ``_overlap`` twins: ``serving.lanes.LaneBatch`` holds the only reference
to the state, and refill and evict write the visited rows in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitset
from repro_torch.core.graph import HnswGraph
from repro_torch.core.heuristics import Heuristic, adaptive_rule
from repro_torch.core.quantize import QuantizedStore
from repro_torch.core.search import (SearchParams, SearchResult, SearchStats,
                                     _dedupe_keep_first, search_batch)
from repro_torch.kernels import ops

#: loop iterations between two reads of the batch's liveness
CHUNK = 16


class _BatchState(NamedTuple):
    d: torch.Tensor          # f32[B, efs]
    ids: torch.Tensor        # int32[B, efs]
    exp: torch.Tensor        # bool[B, efs]
    sel: torch.Tensor        # bool[B, efs]
    visited: torch.Tensor    # bool[B, n + 1], updated in place
    it: torch.Tensor         # int32[B]
    t_dc: torch.Tensor       # int32[B]
    s_dc: torch.Tensor       # int32[B]
    picks: torch.Tensor      # int32[B, 3]


def batch_gather_dist(Q: torch.Tensor,
                      vectors: torch.Tensor | QuantizedStore,
                      ids: torch.Tensor, metric: str) -> torch.Tensor:
    """The engine's distance primitive and its one store dispatch point:
    dist(Q[b], vectors[ids[b]]) over f32 rows, or over int8 codes + scales
    for a store (dequantized per gathered row inside the kernel)."""
    if isinstance(vectors, QuantizedStore):
        return ops.quantized_gather_distance_batch(Q, vectors.codes,
                                                   vectors.scale, ids, metric)
    return ops.gather_distance_batch(Q, vectors, ids, metric)


def _take_first_batch(elig: torch.Tensor, values: torch.Tensor, width: int,
                      budget: torch.Tensor | None = None) -> torch.Tensor:
    """Lane-wise first-k compaction: ([B, L], [B, L]) -> int32[B, width].

    The first up-to-``budget`` eligible values of each lane, in order,
    -1 padded (the reference's ``vmap(search._take_first)``).
    """
    pos = torch.cumsum(elig, dim=1, dtype=torch.int64) - 1
    limit = width if budget is None else budget.clamp(max=width)[:, None]
    take = elig & (pos < limit)
    out = torch.full((elig.shape[0], width + 1), -1, dtype=torch.int32,
                     device=elig.device)
    # non-taken entries all land in the dump column, which is sliced off
    out.scatter_(1, torch.where(take, pos, width),
                 torch.where(take, values, -1))
    return out[:, :width]


def _frontier_min(st: _BatchState):
    d_un = torch.where((~st.exp) & (st.ids >= 0), st.d, torch.inf)
    j = torch.argmin(d_un, dim=1)
    return j, d_un.gather(1, j[:, None])[:, 0]


def _r_max(st: _BatchState, efs) -> torch.Tensor:
    """Per-lane result-set radius; ``efs`` is the int cap or a per-lane
    int32[B] (the ragged path: a lane's radius closes once ITS OWN efs
    slots are selected)."""
    live = st.sel & (st.ids >= 0) & torch.isfinite(st.d)
    r = torch.where(live, st.d, -torch.inf).amax(dim=1)
    return torch.where(live.sum(dim=1) >= efs, r, torch.inf)


def _run_chunked(step, state, live_fn):
    """Apply ``step`` in chunks of CHUNK iterations until ``live_fn`` says
    no lane is live (one device read per chunk). ``step`` must leave every
    non-live lane unchanged."""
    while bool(live_fn(state).any()):
        for _ in range(CHUNK):
            state = step(state)
    return state


def greedy_upper_batch(graph: HnswGraph, Q: torch.Tensor, metric: str):
    """Batched greedy walk on G_U with a per-lane improving mask.

    Returns (entry_ids int32[B], dc int32[B]); lane for lane identical to
    ``search.greedy_upper``.
    """
    upper, upper_ids, vectors = graph.upper, graph.upper_ids, graph.vectors
    bsz = Q.shape[0]
    b_idx = torch.arange(bsz, device=Q.device)
    pos0 = graph.entry_pos.reshape(1).expand(bsz).to(torch.int32)
    d0 = batch_gather_dist(Q, vectors, upper_ids[pos0.long()][:, None],
                           metric)[:, 0]

    def step(c):
        pos, d, dc, act = c
        nbr_pos = upper[pos.long()]                            # [B, M_U]
        valid = nbr_pos >= 0
        nbr_ids = torch.where(valid, upper_ids[nbr_pos.clamp(min=0).long()],
                              -1)
        nd = batch_gather_dist(Q, vectors,
                               torch.where(act[:, None], nbr_ids, -1), metric)
        jj = torch.argmin(nd, dim=1)
        best = nd.gather(1, jj[:, None])[:, 0]
        upd = act & (best < d)
        return (torch.where(upd, nbr_pos[b_idx, jj], pos),
                torch.where(upd, best, d),
                dc + torch.where(act, valid.sum(dim=1), 0).to(torch.int32),
                upd)

    init = (pos0, d0, torch.ones(bsz, dtype=torch.int32, device=Q.device),
            torch.ones(bsz, dtype=torch.bool, device=Q.device))
    pos, _, dc, _ = _run_chunked(step, init, lambda c: c[3])
    return upper_ids[pos.long()], dc


# ---------------------------------------------------------------------------
# the lower-level loop
# ---------------------------------------------------------------------------


def _resolve_branching(sel2: torch.Tensor, params: SearchParams, sigma_g,
                       n: int, m_l: int, bsz: int):
    """Normalize (semimask, heuristic) to the loop's form.

    Returns ``(sel2, mode, global_branch int32[B])``: ONEHOP_A becomes
    ONEHOP_S over the full mask; ADAPTIVE_GLOBAL evaluates the paper's rule
    with a scalar or per-lane sigma_g (default: each lane's own |S|/|V|).
    """
    mode = int(params.heuristic)
    dev = sel2.device
    if mode == int(Heuristic.ONEHOP_A):
        sel2 = bitset.full_mask(n, dev).expand(sel2.shape)
        mode = int(Heuristic.ONEHOP_S)
    if mode == int(Heuristic.ADAPTIVE_GLOBAL):
        if sigma_g is None:
            sigma_g = bitset.count_batch(sel2) / n
        global_branch = adaptive_rule(torch.as_tensor(sigma_g, device=dev),
                                      m_l, params.ub, params.lf)
    else:
        global_branch = torch.tensor(mode if mode <= 2 else 0,
                                     dtype=torch.int32, device=dev)
    return sel2, mode, global_branch.expand(bsz)


def _visit_test(visited: torch.Tensor, ids: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Visited flags of [B, K] ids (``valid`` = ids >= 0; padding: False)."""
    return visited.gather(1, ids.clamp(min=0).long()) & valid


def _visit_set_(visited: torch.Tensor, ids: torch.Tensor) -> None:
    """Mark [B, K] ids visited in place; padding ids go to the dump column
    ``n``, which is set in every row from the start (so a store there
    changes no bit) and which no test reads unmasked. Duplicate-safe (a
    store of True)."""
    n = visited.shape[1] - 1
    visited.scatter_(1, torch.where(ids >= 0, ids, n).long(), True)


def _reset_visited_(visited: torch.Tensor, rows: torch.Tensor,
                    seeds: torch.Tensor | None = None) -> None:
    """Clear the visited rows ``rows`` (int64 lane indices) in place, keep
    their dump column set, and mark each row's seed (int32, one a row)
    when ``seeds`` is given: a masked row assignment, not a pass over the
    whole [B, n + 1] map."""
    n = visited.shape[1] - 1
    visited[rows] = False
    visited[rows, n] = True
    if seeds is not None:
        visited[rows, seeds.long()] = True


def _init_beams(graph: HnswGraph, Q: torch.Tensor, sel2: torch.Tensor,
                seeds: torch.Tensor, params: SearchParams) -> _BatchState:
    """Fresh per-lane beams holding only each lane's seed entry point,
    without the visited map (``visited=None``)."""
    bsz, efs, dev = Q.shape[0], params.efs, Q.device
    seeds = seeds.to(torch.int32)
    seed_d = batch_gather_dist(Q, graph.vectors, seeds[:, None],
                               params.metric)
    d = torch.full((bsz, efs), torch.inf, device=dev)
    d[:, :1] = seed_d
    ids = torch.full((bsz, efs), -1, dtype=torch.int32, device=dev)
    ids[:, 0] = seeds
    sel = torch.zeros((bsz, efs), dtype=torch.bool, device=dev)
    sel[:, :1] = bitset.test_batch(sel2, seeds[:, None])
    zeros = torch.zeros(bsz, dtype=torch.int32, device=dev)
    return _BatchState(
        d=d, ids=ids, exp=torch.zeros((bsz, efs), dtype=torch.bool, device=dev),
        sel=sel, visited=None, it=zeros, t_dc=zeros.clone(),
        s_dc=zeros.clone(),
        picks=torch.zeros((bsz, 3), dtype=torch.int32, device=dev))


def _init_state(graph: HnswGraph, Q: torch.Tensor, sel2: torch.Tensor,
                seeds: torch.Tensor, params: SearchParams) -> _BatchState:
    """Fresh per-lane beams and visited maps holding only each lane's seed
    entry point."""
    n = graph.n
    visited = torch.zeros((Q.shape[0], n + 1), dtype=torch.bool,
                          device=Q.device)
    visited[:, n] = True                     # the dump column (_visit_set_)
    _visit_set_(visited, seeds[:, None])
    return _init_beams(graph, Q, sel2, seeds, params)._replace(
        visited=visited)


def _loop_fns(graph: HnswGraph, Q: torch.Tensor, sel2: torch.Tensor,
              params: SearchParams, mode: int, global_branch: torch.Tensor,
              efs_lanes: torch.Tensor | None = None):
    """Build the (lane_cond, body) closures of the batched lower-level
    loop. ``sel2`` is per-lane ``[B, W]``; ``mode`` the resolved heuristic;
    ``global_branch`` the per-lane branch when the mode is not adaptive.

    ``efs_lanes`` (optional int32[B]) makes the beam RAGGED: after every
    merge, slots at or past a lane's own efs are cleared (d +inf, id -1,
    sel False, exp True), so a lane admitted at a small efs is bit for bit
    a lane whose beam was only ever that wide (the merge is sorted
    ascending, so its first efs_lanes[b] slots are the narrow beam's).
    Lanes at the full ``params.efs`` have an empty tail, so a uniform-efs
    batch is unchanged."""
    efs, metric = params.efs, params.metric
    efs_eff = efs if efs_lanes is None else efs_lanes
    m_l = graph.m_l
    k2 = params.two_hop_cap or m_l
    max_iters = params.max_iters or graph.n
    bsz = Q.shape[0]
    vectors, lower = graph.vectors, graph.lower
    slots = torch.arange(efs, device=Q.device)[None, :]
    branches = torch.arange(3, device=Q.device)[None, :]
    i32 = torch.int32

    def frontier(st: _BatchState):
        """(j, live): each lane's closest unexpanded slot and whether the
        lane continues (the single-query convergence predicate)."""
        j, d_min = _frontier_min(st)
        keep = (d_min < torch.inf) & (d_min <= _r_max(st, efs_eff))
        return j, keep & (st.it < max_iters)

    def lane_cond(st: _BatchState) -> torch.Tensor:
        return frontier(st)[1]

    # the (never written) result of a second-degree stage with no parents
    no_cand2 = torch.full((bsz, k2), -1, dtype=i32, device=Q.device)
    no_d2 = torch.full((bsz, k2), torch.inf, device=Q.device)
    no_n2 = torch.zeros(bsz, dtype=i32, device=Q.device)

    def second_degree(st, live, branch, is_dir, nbrs, valid, d_all, n1):
        """Up to k2 selected, unvisited, unique 2nd-degree candidates per
        lane (marked visited here), their distances and their count.
        Lanes that take no second hop this iteration have no parents and
        yield -1 / +inf, so the stage runs masked with no host read."""
        # parents: distance-ordered for directed, scan order for blind,
        # none for onehop-s / retired lanes
        order1 = torch.argsort(torch.where(valid, d_all, torch.inf), dim=1,
                               stable=True)
        two_hop = live & (branch != int(Heuristic.ONEHOP_S))
        parents = torch.where(
            two_hop[:, None],
            torch.where(is_dir[:, None], nbrs.gather(1, order1), nbrs), -1)
        budget = torch.where(two_hop, (k2 - n1).clamp(min=0), 0)
        nb2 = lower[parents.clamp(min=0).long()]               # [B, M, M]
        flat = torch.where((parents >= 0)[:, :, None], nb2,
                           -1).reshape(bsz, -1)
        elig = (bitset.test_batch(sel2, flat)
                & ~_visit_test(st.visited, flat, flat >= 0))
        cand = _take_first_batch(elig, flat, 2 * k2)           # over-take
        cand = _dedupe_keep_first(cand)                        # dedupe
        cand2 = _take_first_batch(cand >= 0, cand, k2, budget=budget)
        d2 = batch_gather_dist(Q, vectors, cand2, metric)      # -1 -> +inf
        _visit_set_(st.visited, cand2)
        return cand2, d2, (cand2 >= 0).sum(dim=1, dtype=i32)

    def body(st: _BatchState) -> _BatchState:
        j, live = frontier(st)                                 # [B], [B]
        c_min = st.ids.gather(1, j[:, None])[:, 0]
        # retired lanes contribute no candidates to the shared gathers
        nbrs = torch.where(live[:, None], lower[c_min.clamp(min=0).long()],
                           -1)                                 # [B, M_L]
        valid = nbrs >= 0
        sel_hit = bitset.test_batch(sel2, nbrs)                # own S per lane

        if mode == int(Heuristic.ADAPTIVE_LOCAL):
            # sigma_l = |S & nbrs| / |nbrs| against each lane's own S
            sigma_l = (sel_hit.sum(dim=1, dtype=i32)
                       / valid.sum(dim=1, dtype=i32).clamp(min=1))
            branch = adaptive_rule(sigma_l, m_l, params.ub, params.lf)
        else:
            branch = global_branch
        is_dir = branch == int(Heuristic.DIRECTED)

        # shared first-degree pass: one gather serves every branch
        unvisited = ~_visit_test(st.visited, nbrs, valid)      # [B, M]
        new1 = valid & unvisited
        sel1 = sel_hit & unvisited
        cand1 = torch.where(sel1, nbrs, -1)
        d_all = batch_gather_dist(Q, vectors, nbrs, metric)
        d1 = torch.where(sel1, d_all, torch.inf)
        n1 = sel1.sum(dim=1, dtype=i32)
        # directed marks every neighbor it ordered; the others only the
        # selected candidates they actually inserted
        _visit_set_(st.visited, torch.where(
            torch.where(is_dir[:, None], new1, sel1), nbrs, -1))

        if mode == int(Heuristic.ONEHOP_S):
            # no lane can take a second hop (onehop-s / onehop-a, e.g. the
            # build's insert searches): the stage yields nothing, as the
            # reference's lax.cond skip does, decided from the static mode
            cand2, d2, n2 = no_cand2, no_d2, no_n2
        else:
            cand2, d2, n2 = second_degree(st, live, branch, is_dir, nbrs,
                                          valid, d_all, n1)

        # retired lanes have no candidates, so they add nothing here
        s_add = n1 + n2
        t_add = torch.where(is_dir, new1.sum(dim=1, dtype=i32) + n2, s_add)

        # retire the expanded slot and merge candidates (per lane); d1 and
        # d2 are already +inf wherever their id is -1
        slot = slots == j[:, None]                             # [B, efs]
        sel_j = st.sel.gather(1, j[:, None])
        cand_ids = torch.cat([cand1, cand2], dim=1)
        all_d = torch.cat([torch.where(slot & ~sel_j, torch.inf, st.d),
                           d1, d2], dim=1)
        all_id = torch.cat([st.ids, cand_ids], dim=1)
        all_exp = torch.cat([st.exp | slot,
                             torch.zeros_like(cand_ids, dtype=torch.bool)],
                            dim=1)
        all_sel = torch.cat([st.sel, cand_ids >= 0], dim=1)

        # stable ascending sort == lax.top_k(-d): same lower-index-first
        # order among ties, which padding slots (+inf / -1) rely on
        srt, order = torch.sort(all_d, dim=1, stable=True)
        order = order[:, :efs]
        new_d, new_id = srt[:, :efs], all_id.gather(1, order)
        new_exp, new_sel = all_exp.gather(1, order), all_sel.gather(1, order)
        if efs_lanes is not None:
            # the ragged beam tail (see above)
            tail = slots >= efs_lanes[:, None]
            new_d = torch.where(tail, torch.inf, new_d)
            new_id = torch.where(tail, -1, new_id)
            new_exp = new_exp | tail
            new_sel = new_sel & ~tail
        keep = live[:, None]
        return _BatchState(
            d=torch.where(keep, new_d, st.d),
            ids=torch.where(keep, new_id, st.ids),
            exp=torch.where(keep, new_exp, st.exp),
            sel=torch.where(keep, new_sel, st.sel),
            visited=st.visited,          # updated in place; retired lanes
            it=st.it + live.to(i32),     # marked only the dump column
            t_dc=st.t_dc + t_add,
            s_dc=st.s_dc + s_add,
            picks=st.picks + ((branches == branch[:, None])
                              & keep).to(i32),
        )

    return lane_cond, body


def _extract_results(st: _BatchState, efs: int):
    """Selected-slot order of the final beams: (dists[B, efs],
    ids[B, efs], per-lane stats with upper_dc left zero)."""
    res_d = torch.where(st.sel & (st.ids >= 0), st.d, torch.inf)
    out_d, order = torch.sort(res_d, dim=1, stable=True)
    out_d, order = out_d[:, :efs], order[:, :efs]
    out_id = torch.where(torch.isfinite(out_d), st.ids.gather(1, order), -1)
    stats = SearchStats(iters=st.it, t_dc=st.t_dc, s_dc=st.s_dc,
                        upper_dc=torch.zeros_like(st.it), picks=st.picks)
    return out_d, out_id, stats


def beam_search_lower_batch(graph: HnswGraph, Q: torch.Tensor,
                            sel_bits: torch.Tensor, seeds: torch.Tensor,
                            params: SearchParams, sigma_g=None,
                            efs_lanes: torch.Tensor | None = None):
    """Search G_L for B queries at once. Returns the full beams
    (dists[B, efs], ids[B, efs]) ascending, plus per-lane stats.

    ``seeds``: int32[B] entry node ids (one per lane). ``sel_bits``: one
    shared semimask ``[W]`` or a per-lane stack ``[B, W]``. ``sigma_g``:
    scalar or per-lane ``[B]`` (ADAPTIVE_GLOBAL only). ``efs_lanes``:
    optional per-lane int32[B] efs (each lane bit for bit a search at its
    own efs <= params.efs).
    """
    bsz = Q.shape[0]
    sel2 = bitset.broadcast_lanes(sel_bits, bsz)
    sel2, mode, global_branch = _resolve_branching(
        sel2, params, sigma_g, graph.n, graph.m_l, bsz)
    lane_cond, body = _loop_fns(graph, Q, sel2, params, mode, global_branch,
                                efs_lanes=efs_lanes)
    st = _run_chunked(body, _init_state(graph, Q, sel2, seeds, params),
                      lane_cond)
    return _extract_results(st, params.efs)


def search_lanes(graph: HnswGraph, Q: torch.Tensor, sel_bits: torch.Tensor,
                 params: SearchParams, sigma_g=None,
                 efs_lanes: torch.Tensor | None = None) -> SearchResult:
    """Full 2-level filtered search for a [B, d] query batch."""
    entry, upper_dc = greedy_upper_batch(graph, Q, params.metric)
    beam_d, beam_id, stats = beam_search_lower_batch(
        graph, Q, sel_bits, entry, params, sigma_g=sigma_g,
        efs_lanes=efs_lanes)
    k = params.k
    return SearchResult(
        dists=beam_d[:, :k], ids=beam_id[:, :k],
        # +1: the entry vector's own distance at the lower level
        stats=stats._replace(upper_dc=upper_dc + 1))


def search_many(graph: HnswGraph, Q: torch.Tensor, sel_bits: torch.Tensor,
                params: SearchParams, sigma_g=None,
                efs_lanes: torch.Tensor | None = None) -> SearchResult:
    """Full 2-level filtered search for a [B, d] query batch.

    Lane for lane equal to ``search.search`` per query with that lane's own
    semimask (same ids, dists and stats). ``sel_bits`` is ``[W]`` (shared)
    or ``[B, W]`` (per lane); ``efs_lanes`` (optional int32[B]) runs each
    lane at its own efs.
    """
    Q = Q.to(torch.float32)
    on = {Q.device, sel_bits.device}
    if efs_lanes is not None:
        on.add(efs_lanes.device)
    if on != {graph.device}:
        raise ValueError(f"queries, semimask and efs_lanes on "
                         f"{sorted(map(str, on))}, but the graph is on "
                         f"{graph.device}")
    return search_lanes(graph, Q, sel_bits, params, sigma_g=sigma_g,
                        efs_lanes=efs_lanes)


# ---------------------------------------------------------------------------
# resumable stepping API -- the continuous scheduler's device side
# ---------------------------------------------------------------------------
# The serving tier holds a fixed [B, efs] beam state across calls:
#   parked_state    -> all lanes empty (converged by construction)
#   engine_refill   -> reset some lanes to fresh beams for new requests
#   engine_steps    -> advance n_steps loop iterations; per-lane live mask
#   engine_evict    -> park some lanes (deadline eviction)
#   engine_finalize -> per-lane (dists, ids, stats) at any point
# A lane stepped to convergence through any chunking passes through exactly
# the `search_many` state sequence (converged and parked lanes are frozen by
# the body's live mask), so its result is bit for bit the single query's.
# The reference's ``*_lanes`` bodies and jitted ``engine_*`` entries are one
# function each here (eager PyTorch compiles nothing); both names are kept.


def _lane_mask(mask: torch.Tensor, device: torch.device):
    """A bool[B] lane mask on ``device`` and its int64 row indices there. A
    host mask gives its rows without reading the device; a device mask
    costs one read."""
    rows = torch.nonzero(mask)[:, 0]
    return (mask.to(device, non_blocking=True),
            rows.to(device, non_blocking=True))


def _parked_beams(bsz: int, efs: int, device) -> _BatchState:
    """Empty, converged beams (``visited=None``)."""
    zeros = torch.zeros(bsz, dtype=torch.int32, device=device)
    return _BatchState(
        d=torch.full((bsz, efs), torch.inf, device=device),
        ids=torch.full((bsz, efs), -1, dtype=torch.int32, device=device),
        exp=torch.ones((bsz, efs), dtype=torch.bool, device=device),
        sel=torch.zeros((bsz, efs), dtype=torch.bool, device=device),
        visited=None, it=zeros, t_dc=zeros.clone(), s_dc=zeros.clone(),
        picks=torch.zeros((bsz, 3), dtype=torch.int32, device=device))


def parked_state(n: int, bsz: int, params: SearchParams,
                 device: torch.device | str) -> _BatchState:
    """An all-parked batch state on ``device``: every lane empty and
    converged."""
    visited = torch.zeros((bsz, n + 1), dtype=torch.bool, device=device)
    visited[:, n] = True                     # the dump column (_visit_set_)
    return _parked_beams(bsz, params.efs, device)._replace(visited=visited)


def _merge_lanes(mask: torch.Tensor, new: _BatchState,
                 old: _BatchState) -> _BatchState:
    """``new``'s lanes where ``mask`` (bool[B] on the device), ``old``'s
    elsewhere; the visited map is ``old``'s (its rows are written in place
    by the caller)."""
    def pick(a, b):
        return torch.where(mask.view((-1,) + (1,) * (a.ndim - 1)), a, b)
    return _BatchState(*(old.visited if f == "visited" else
                         pick(getattr(new, f), getattr(old, f))
                         for f in _BatchState._fields))


def refill_lanes(graph: HnswGraph, Q: torch.Tensor, sel_bits: torch.Tensor,
                 st: _BatchState, upper_dc: torch.Tensor,
                 refill: torch.Tensor, params: SearchParams
                 ) -> tuple[_BatchState, torch.Tensor]:
    """Reset the lanes flagged in ``refill`` (bool[B], on the host or the
    state's device) to fresh beams.

    Refilled lanes run the greedy upper descent for their (new) query and
    start a fresh lower-level beam over their (new) per-lane semimask; all
    other lanes pass through bit for bit. The upper descent and the beams
    are made for the whole batch and merged by the mask, as the reference
    does; the visited map's flagged rows are rewritten in place. Returns
    the state and the per-lane ``upper_dc`` accounting.
    """
    bsz, dev = Q.shape[0], Q.device
    sel2 = bitset.broadcast_lanes(sel_bits, bsz)
    sel2, _, _ = _resolve_branching(sel2, params, None, graph.n,
                                    graph.m_l, bsz)
    entry, dc = greedy_upper_batch(graph, Q, params.metric)
    fresh = _init_beams(graph, Q, sel2, entry, params)
    mask, rows = _lane_mask(refill, dev)
    _reset_visited_(st.visited, rows, entry[rows])
    return (_merge_lanes(mask, fresh, st),
            torch.where(mask, dc.to(torch.int32) + 1, upper_dc))


#: the reference's jitted entry; the same eager function here
engine_refill = refill_lanes


def step_lanes(graph: HnswGraph, Q: torch.Tensor, sel_bits: torch.Tensor,
               st: _BatchState, params: SearchParams, n_steps: int,
               sigma_g=None, efs_lanes: torch.Tensor | None = None
               ) -> tuple[_BatchState, torch.Tensor]:
    """Advance the batch by ``n_steps`` loop iterations (``n_steps=0``: run
    to whole-batch convergence, reading the device once a ``CHUNK``).

    Returns ``(state, live bool[B])`` with ``live`` a device tensor; a lane
    with ``live == False`` has converged (or is parked) and is safe to
    finalize and refill. ``n_steps > 0`` reads nothing from the device:
    it applies the body ``n_steps`` times, which changes no bit of a
    converged lane (the reference stops early instead; the states agree).
    ``efs_lanes`` (optional int32[B]) steps each lane at its own efs and
    must stay constant for a lane between refills.
    """
    bsz = Q.shape[0]
    sel2 = bitset.broadcast_lanes(sel_bits, bsz)
    sel2, mode, global_branch = _resolve_branching(
        sel2, params, sigma_g, graph.n, graph.m_l, bsz)
    lane_cond, body = _loop_fns(graph, Q, sel2, params, mode, global_branch,
                                efs_lanes=efs_lanes)
    if n_steps:
        for _ in range(n_steps):
            st = body(st)
    else:
        st = _run_chunked(body, st, lane_cond)
    return st, lane_cond(st)


engine_steps = step_lanes


def evict_lanes(st: _BatchState, upper_dc: torch.Tensor,
                evict: torch.Tensor) -> tuple[_BatchState, torch.Tensor]:
    """Park the lanes flagged in ``evict`` (bool[B], on the host or the
    state's device): their beams become empty and converged (ids -1, sel
    False, d +inf), so they stop contributing work in ``engine_steps``,
    finalize to all ``-1`` ids, and are immediately refillable. The serving
    tier finalizes first (to salvage a partial beam), then evicts. The
    visited map's flagged rows are cleared in place."""
    dev = st.it.device
    mask, rows = _lane_mask(evict, dev)
    _reset_visited_(st.visited, rows)
    return (_merge_lanes(mask, _parked_beams(*st.ids.shape, dev), st),
            torch.where(mask, 0, upper_dc))


engine_evict = evict_lanes


def finalize_lanes(st: _BatchState, upper_dc: torch.Tensor,
                   params: SearchParams) -> SearchResult:
    """Per-lane results of a (possibly partly converged) batch state: the
    full-efs beams (the host slices each lane to its own k) and the stats,
    with ``upper_dc``."""
    out_d, out_id, stats = _extract_results(st, params.efs)
    return SearchResult(dists=out_d, ids=out_id,
                        stats=stats._replace(upper_dc=upper_dc.to(torch.int32)))


engine_finalize = finalize_lanes


#: the multi-row execution engines (name -> entry point): the one registry
#: behind NavixIndex.search_many, NavixDB.execute and ProgramCache.batch
BATCH_ENGINES = {"batched": search_many, "vmap": search_batch}


def resolve_engine(engine: str):
    """Validate an engine name and return its entry point."""
    try:
        return BATCH_ENGINES[engine]
    except KeyError:
        raise ValueError(f"unknown engine {engine!r}; valid: "
                         f"{tuple(BATCH_ENGINES)}") from None
