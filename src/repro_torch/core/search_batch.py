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


def _r_max(st: _BatchState, efs: int) -> torch.Tensor:
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
    ``n``, which no test reads unmasked. Duplicate-safe (a store of True)."""
    n = visited.shape[1] - 1
    visited.scatter_(1, torch.where(ids >= 0, ids, n).long(), True)


def _init_state(graph: HnswGraph, Q: torch.Tensor, sel2: torch.Tensor,
                seeds: torch.Tensor, params: SearchParams) -> _BatchState:
    """Fresh per-lane beams holding only each lane's seed entry point."""
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
    visited = torch.zeros((bsz, graph.n + 1), dtype=torch.bool, device=dev)
    _visit_set_(visited, seeds[:, None])
    zeros = torch.zeros(bsz, dtype=torch.int32, device=dev)
    return _BatchState(
        d=d, ids=ids, exp=torch.zeros((bsz, efs), dtype=torch.bool, device=dev),
        sel=sel, visited=visited, it=zeros, t_dc=zeros.clone(),
        s_dc=zeros.clone(),
        picks=torch.zeros((bsz, 3), dtype=torch.int32, device=dev))


def _loop_fns(graph: HnswGraph, Q: torch.Tensor, sel2: torch.Tensor,
              params: SearchParams, mode: int, global_branch: torch.Tensor):
    """Build the (lane_cond, body) closures of the batched lower-level
    loop. ``sel2`` is per-lane ``[B, W]``; ``mode`` the resolved heuristic;
    ``global_branch`` the per-lane branch when the mode is not adaptive."""
    efs, metric = params.efs, params.metric
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
        keep = (d_min < torch.inf) & (d_min <= _r_max(st, efs))
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
        keep = live[:, None]
        return _BatchState(
            d=torch.where(keep, srt[:, :efs], st.d),
            ids=torch.where(keep, all_id.gather(1, order), st.ids),
            exp=torch.where(keep, all_exp.gather(1, order), st.exp),
            sel=torch.where(keep, all_sel.gather(1, order), st.sel),
            visited=st.visited,          # updated in place; retired lanes
            it=st.it + live.to(i32),     # marked nothing
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
                            params: SearchParams, sigma_g=None):
    """Search G_L for B queries at once. Returns the full beams
    (dists[B, efs], ids[B, efs]) ascending, plus per-lane stats.

    ``seeds``: int32[B] entry node ids (one per lane). ``sel_bits``: one
    shared semimask ``[W]`` or a per-lane stack ``[B, W]``. ``sigma_g``:
    scalar or per-lane ``[B]`` (ADAPTIVE_GLOBAL only).
    """
    bsz = Q.shape[0]
    sel2 = bitset.broadcast_lanes(sel_bits, bsz)
    sel2, mode, global_branch = _resolve_branching(
        sel2, params, sigma_g, graph.n, graph.m_l, bsz)
    lane_cond, body = _loop_fns(graph, Q, sel2, params, mode, global_branch)
    st = _run_chunked(body, _init_state(graph, Q, sel2, seeds, params),
                      lane_cond)
    return _extract_results(st, params.efs)


def search_lanes(graph: HnswGraph, Q: torch.Tensor, sel_bits: torch.Tensor,
                 params: SearchParams, sigma_g=None) -> SearchResult:
    """Full 2-level filtered search for a [B, d] query batch."""
    entry, upper_dc = greedy_upper_batch(graph, Q, params.metric)
    beam_d, beam_id, stats = beam_search_lower_batch(
        graph, Q, sel_bits, entry, params, sigma_g=sigma_g)
    k = params.k
    return SearchResult(
        dists=beam_d[:, :k], ids=beam_id[:, :k],
        # +1: the entry vector's own distance at the lower level
        stats=stats._replace(upper_dc=upper_dc + 1))


def search_many(graph: HnswGraph, Q: torch.Tensor, sel_bits: torch.Tensor,
                params: SearchParams, sigma_g=None) -> SearchResult:
    """Full 2-level filtered search for a [B, d] query batch.

    Lane for lane equal to ``search.search`` per query with that lane's own
    semimask (same ids, dists and stats). ``sel_bits`` is ``[W]`` (shared)
    or ``[B, W]`` (per lane).
    """
    Q = Q.to(torch.float32)
    if Q.device != graph.device or sel_bits.device != graph.device:
        raise ValueError(f"queries on {Q.device} and semimask on "
                         f"{sel_bits.device}, but the graph is on "
                         f"{graph.device}")
    return search_lanes(graph, Q, sel_bits, params, sigma_g=sigma_g)


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
