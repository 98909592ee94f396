"""Filtered HNSW beam search for one query (port of ``repro.core.search``).

Paper Algorithm 2 with the Section 3 heuristics, one query at a time:

* the candidates/results queues are one fixed-size beam of ``efs`` slots
  with per-slot ``expanded`` flags; the search stops when the closest
  unexpanded candidate is further than the efs-th best selected result;
* the visited set is a packed bitset (``repro_torch.core.bitset``);
* each iteration runs exactly one expansion branch {onehop-s, directed,
  blind}, chosen in Python (the reference's exclusive ``lax.switch``);
* ``s_dc`` counts distances to selected vectors that enter the beam,
  ``t_dc`` all distances computed (directed also pays for ordering).

This is the port's oracle for the batched engine
(``repro_torch.core.search_batch``): every distance goes through
:func:`_gdist`, the single-query entries of ``kernels.ops`` (f32, or int8
for a quantized-resident graph), which are one-lane launches of the
batched engine's kernels, so a batched lane and this search agree bit for
bit on either device. The loop reads the device once or twice per iteration to steer
Python control flow; it is the reference, not the throughput path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitset
from repro_torch.core.graph import HnswGraph
from repro_torch.core.heuristics import (LENIENCY_FACTOR, UB_ONEHOP_S,
                                         Heuristic, adaptive_rule)
from repro_torch.core.quantize import QuantizedStore
from repro_torch.kernels import ops


class SearchParams(NamedTuple):
    k: int = 100
    efs: int = 200
    heuristic: int = int(Heuristic.ADAPTIVE_LOCAL)
    metric: str = "l2"
    ub: float = UB_ONEHOP_S
    lf: float = LENIENCY_FACTOR
    two_hop_cap: int = 0          # 0 -> M_L (the paper's M)
    max_iters: int = 0            # 0 -> unbounded (n is the true bound)


class SearchStats(NamedTuple):
    iters: torch.Tensor           # int32
    t_dc: torch.Tensor            # total distance computations
    s_dc: torch.Tensor            # selected (inserted) distance computations
    upper_dc: torch.Tensor        # distance computations in the upper layer
    picks: torch.Tensor           # int32[3]: times each branch was chosen


class SearchResult(NamedTuple):
    dists: torch.Tensor           # f32[k] (or [B, k])
    ids: torch.Tensor             # int32[k], -1 padded
    stats: SearchStats


def _gdist(q: torch.Tensor, vectors: torch.Tensor | QuantizedStore,
           ids: torch.Tensor, metric: str) -> torch.Tensor:
    """dist(q, vectors[ids]): the oracle's one store dispatch point (int8
    codes + scales for a store, f32 rows otherwise)."""
    if isinstance(vectors, QuantizedStore):
        return ops.quantized_gather_distance(q, vectors.codes, vectors.scale,
                                             ids, metric)
    return ops.gather_distance(q, vectors, ids, metric)


def _i32(x, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def _take_first(elig: torch.Tensor, values: torch.Tensor, width: int,
                budget: torch.Tensor | None = None) -> torch.Tensor:
    """Compact the first (up to ``budget``, a device scalar) eligible
    values, in order. Returns int32[width] padded with -1.
    """
    pos = torch.cumsum(elig.to(torch.int32), 0) - 1
    limit = width if budget is None else budget.clamp(max=width)
    take = elig & (pos < limit)
    tgt = torch.where(take, pos, width).long()      # dump slot is sliced off
    out = torch.full((width + 1,), -1, dtype=torch.int32, device=elig.device)
    out.scatter_(0, tgt, torch.where(take, values, -1).to(torch.int32))
    return out[:width]


def _dedupe_keep_first(ids: torch.Tensor) -> torch.Tensor:
    """Replace repeated ids (keeping the first occurrence) with -1. O(W^2)."""
    i = torch.arange(ids.shape[-1], device=ids.device)
    eq_earlier = (ids[..., None, :] == ids[..., :, None]) & (i[None, :] < i[:, None])
    dup = eq_earlier.any(dim=-1) & (ids >= 0)
    return torch.where(dup, -1, ids)


# ---------------------------------------------------------------------------
# expansion branches (the Section 3 heuristic space)
# ---------------------------------------------------------------------------
# Every branch maps (nbrs[M], visited[W], sel_bits[W], q, vectors, lower)
# to (cand_ids[M + K2], cand_d[M + K2], visited'[W], t_add, s_add).


def _expand_onehop_s(nbrs, visited, sel_bits, q, vectors, lower, k2, metric):
    sel_new = bitset.test(sel_bits, nbrs) & ~bitset.test(visited, nbrs)
    cand1 = torch.where(sel_new, nbrs, -1)
    d1 = _gdist(q, vectors, cand1, metric)
    visited = bitset.set_bits(visited, cand1)
    n1 = (cand1 >= 0).sum()
    pad_ids = torch.full((k2,), -1, dtype=torch.int32, device=nbrs.device)
    pad_d = torch.full((k2,), torch.inf, device=nbrs.device)
    return (torch.cat([cand1, pad_ids]), torch.cat([d1, pad_d]),
            visited, n1, n1)


def _second_degree(parents_in_order, visited, sel_bits, q, vectors, lower,
                   k2, budget, metric):
    """Gather 2nd-degree neighborhoods in the given parent order and keep
    the first ``budget`` selected+unvisited unique nodes."""
    nb2 = lower[parents_in_order.clamp(min=0).long()]            # [M, M]
    parent_ok = (parents_in_order >= 0)[:, None]
    flat = torch.where(parent_ok, nb2, -1).reshape(-1)            # in order
    elig = ((flat >= 0) & bitset.test(sel_bits, flat)
            & ~bitset.test(visited, flat))
    cand = _take_first(elig, flat, 2 * k2)                        # over-take
    cand = _dedupe_keep_first(cand)                               # dedupe
    cand = _take_first(cand >= 0, cand, k2, budget=budget)        # then cap
    d2 = _gdist(q, vectors, cand, metric)
    visited = bitset.set_bits(visited, cand)
    return cand, d2, visited, (cand >= 0).sum()


def _expand_directed(nbrs, visited, sel_bits, q, vectors, lower, k2, metric):
    """2 hops, parents ordered by distance to q; pays a distance for every
    unvisited 1st-degree neighbor (selected or not) for the ordering."""
    valid = nbrs >= 0
    d_all = _gdist(q, vectors, nbrs, metric)
    new1 = valid & ~bitset.test(visited, nbrs)
    t_order = new1.sum()
    sel1 = new1 & bitset.test(sel_bits, nbrs)
    cand1 = torch.where(sel1, nbrs, -1)
    d1 = torch.where(sel1, d_all, torch.inf)
    n1 = sel1.sum()
    visited = bitset.set_bits(visited, torch.where(new1, nbrs, -1))
    order = torch.argsort(torch.where(valid, d_all, torch.inf), stable=True)
    parents = nbrs[order]
    cand2, d2, visited, n2 = _second_degree(
        parents, visited, sel_bits, q, vectors, lower, k2,
        (k2 - n1).clamp(min=0), metric)
    return (torch.cat([cand1, cand2]), torch.cat([d1, d2]),
            visited, t_order + n2, n1 + n2)


def _expand_blind(nbrs, visited, sel_bits, q, vectors, lower, k2, metric):
    """2 hops, parents in scan order; no ordering overhead (t-dc == s-dc)."""
    sel1 = bitset.test(sel_bits, nbrs) & ~bitset.test(visited, nbrs)
    cand1 = torch.where(sel1, nbrs, -1)
    d1 = _gdist(q, vectors, cand1, metric)
    n1 = sel1.sum()
    visited = bitset.set_bits(visited, cand1)
    cand2, d2, visited, n2 = _second_degree(
        nbrs, visited, sel_bits, q, vectors, lower, k2,
        (k2 - n1).clamp(min=0), metric)
    return (torch.cat([cand1, cand2]), torch.cat([d1, d2]),
            visited, n1 + n2, n1 + n2)


_BRANCHES = (_expand_onehop_s, _expand_directed, _expand_blind)


# ---------------------------------------------------------------------------
# upper layer: greedy descent to find the lower-level entry point
# ---------------------------------------------------------------------------


def greedy_upper(graph: HnswGraph, q: torch.Tensor, metric: str):
    """Greedy walk on G_U (efs=1, unfiltered). Returns (entry_id, dc)."""
    pos = graph.entry_pos.reshape(1)
    d = _gdist(q, graph.vectors, graph.upper_ids[pos.long()], metric)[0]
    dc = 1
    while True:
        nbr_pos = graph.upper[pos.long()][0]                       # [M_U]
        valid = nbr_pos >= 0
        nbr_ids = torch.where(
            valid, graph.upper_ids[nbr_pos.clamp(min=0).long()], -1)
        nd = _gdist(q, graph.vectors, nbr_ids, metric)
        j = torch.argmin(nd)
        dc = dc + valid.sum()
        if not bool(nd[j] < d):                       # one read per step
            break
        pos, d = nbr_pos[j].reshape(1), nd[j]
    return graph.upper_ids[pos.long()][0], dc


# ---------------------------------------------------------------------------
# the beam search
# ---------------------------------------------------------------------------


def _frontier_min(d, ids, exp):
    d_un = torch.where((~exp) & (ids >= 0), d, torch.inf)
    j = torch.argmin(d_un)
    return j, d_un[j]


def _r_max(d, ids, sel, efs: int) -> torch.Tensor:
    live = sel & (ids >= 0) & torch.isfinite(d)
    r = torch.where(live, d, -torch.inf).max()
    return torch.where(live.sum() >= efs, r, torch.inf)


def beam_search_lower(graph: HnswGraph, q: torch.Tensor,
                      sel_bits: torch.Tensor, seeds: torch.Tensor,
                      params: SearchParams, sigma_g=None):
    """Search G_L. Returns the full beam (dists[efs], ids[efs]) ascending
    with unselected / invalid slots pushed to +inf, plus stats.

    ``seeds``: int32[n_seeds] entry node ids. ``sigma_g``: |S|/|V| for
    ADAPTIVE_GLOBAL (computed from ``sel_bits`` when None).
    """
    efs, metric = params.efs, params.metric
    mode = int(params.heuristic)
    m_l = graph.m_l
    k2 = params.two_hop_cap or m_l
    max_iters = params.max_iters or graph.n
    vectors, lower = graph.vectors, graph.lower
    dev = vectors.device

    if mode == int(Heuristic.ONEHOP_A):
        # unfiltered original HNSW == onehop-s with the full mask
        sel_bits = bitset.full_mask(graph.n, dev)
        mode = int(Heuristic.ONEHOP_S)
    if mode == int(Heuristic.ADAPTIVE_GLOBAL):
        if sigma_g is None:
            sigma_g = bitset.count(sel_bits) / graph.n
        global_branch = int(adaptive_rule(torch.as_tensor(sigma_g), m_l,
                                          params.ub, params.lf))
    else:
        global_branch = mode if mode <= 2 else 0

    n_seeds = seeds.shape[0]
    pad = efs - n_seeds
    d = torch.cat([_gdist(q, vectors, seeds, metric),
                   torch.full((pad,), torch.inf, device=dev)])
    ids = torch.cat([seeds.to(torch.int32),
                     torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    exp = torch.zeros(efs, dtype=torch.bool, device=dev)
    sel = torch.cat([bitset.test(sel_bits, seeds),
                     torch.zeros(pad, dtype=torch.bool, device=dev)])
    visited = bitset.set_bits(
        torch.zeros(bitset.n_words(graph.n), dtype=torch.int32, device=dev),
        seeds)
    it = 0
    t_dc = torch.zeros((), dtype=torch.int64, device=dev)
    s_dc = torch.zeros((), dtype=torch.int64, device=dev)
    picks = [0, 0, 0]

    # the host reads the device once per iteration for the stop rule and,
    # under adaptive-local, once for the branch; counters stay on the device
    while it < max_iters:
        j, d_min = _frontier_min(d, ids, exp)
        if not bool((d_min < torch.inf) & (d_min <= _r_max(d, ids, sel, efs))):
            break
        nbrs = lower[ids[j].long()]                                # [M_L]
        if mode == int(Heuristic.ADAPTIVE_LOCAL):
            deg = (nbrs >= 0).sum()
            sigma_l = bitset.count_members(sel_bits, nbrs) / deg.clamp(min=1)
            branch = int(adaptive_rule(sigma_l, m_l, params.ub, params.lf))
        else:
            branch = global_branch
        cand_ids, cand_d, visited, t_add, s_add = _BRANCHES[branch](
            nbrs, visited, sel_bits, q, vectors, lower, k2, metric)

        # retire the expanded slot; unselected slots are dropped entirely
        exp = exp.clone()
        exp[j] = True
        d = d.clone()
        d[j] = torch.where(sel[j], d[j], torch.inf)

        all_d = torch.cat([d, torch.where(cand_ids >= 0, cand_d, torch.inf)])
        all_id = torch.cat([ids, cand_ids])
        all_exp = torch.cat([exp, torch.zeros_like(cand_ids, dtype=torch.bool)])
        all_sel = torch.cat([sel, cand_ids >= 0])
        # stable ascending sort == lax.top_k(-d) incl. its lower-index-first
        # tie order
        srt, order = torch.sort(all_d, stable=True)
        d, order = srt[:efs], order[:efs]
        ids, exp, sel = all_id[order], all_exp[order], all_sel[order]
        it += 1
        t_dc = t_dc + t_add
        s_dc = s_dc + s_add
        picks[branch] += 1

    res_d = torch.where(sel & (ids >= 0), d, torch.inf)
    out_d, order = torch.sort(res_d, stable=True)
    out_id = torch.where(torch.isfinite(out_d), ids[order], -1)
    stats = SearchStats(iters=_i32(it, dev), t_dc=t_dc.to(torch.int32),
                        s_dc=s_dc.to(torch.int32), upper_dc=_i32(0, dev),
                        picks=_i32(picks, dev))
    return out_d, out_id, stats


def search(graph: HnswGraph, q: torch.Tensor, sel_bits: torch.Tensor,
           params: SearchParams, sigma_g=None) -> SearchResult:
    """Full 2-level filtered search for one query (QUERY_HNSW_INDEX).

    The upper layer is searched unfiltered with k=1 (greedy) to find the
    entry point; the lower layer runs the configured heuristic.
    """
    entry, upper_dc = greedy_upper(graph, q, params.metric)
    beam_d, beam_id, stats = beam_search_lower(
        graph, q, sel_bits, entry.reshape(1), params, sigma_g=sigma_g)
    k = params.k
    # +1: the entry vector's own distance at the lower level
    return SearchResult(dists=beam_d[:k], ids=beam_id[:k],
                        stats=stats._replace(
                            upper_dc=(upper_dc + 1).to(torch.int32)))


def search_batch(graph: HnswGraph, Q: torch.Tensor, sel_bits: torch.Tensor,
                 params: SearchParams, sigma_g=None) -> SearchResult:
    """The vmap engine: one :func:`search` a lane, kept as the reference
    oracle for the batched-frontier engine
    (``repro_torch.core.search_batch.search_many``).

    ``sel_bits`` may be one shared ``[W]`` semimask or a per-lane
    ``[B, W]`` stack, and ``sigma_g`` a scalar or a per-lane ``[B]``.
    Results and stats are stacked to the batched engine's per-lane shapes
    and dtypes (``dists`` f32[B, k], ``ids`` int32[B, k], each stat
    int32[B], ``picks`` int32[B, 3]).
    """
    per_lane_sigma = sigma_g is not None and torch.as_tensor(sigma_g).ndim == 1
    lanes = [search(graph, Q[i], sel_bits[i] if sel_bits.ndim == 2
                    else sel_bits, params,
                    sigma_g=sigma_g[i] if per_lane_sigma else sigma_g)
             for i in range(Q.shape[0])]
    return SearchResult(
        dists=torch.stack([r.dists for r in lanes]),
        ids=torch.stack([r.ids for r in lanes]),
        stats=SearchStats(*(torch.stack(f)
                            for f in zip(*(r.stats for r in lanes)))))
