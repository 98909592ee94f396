"""HNSW construction (port of ``repro.core.build``; paper Algorithm 1).

NaviX builds a 2-level index: ``G_U`` over a ``sample_rate`` (5%) sample
with max degree ``M_U``, and ``G_L`` over all vectors with max degree
``M_L = 2 * M_U``. Insertion is batch-parallel, as in the reference: each
morsel of vectors searches a frozen snapshot of the graph, then all edge
updates are merged. Intra-morsel inserts do not see each other (the
staleness of the paper's benign data race).

The reference vmaps its single-query ``beam_search_lower`` over a morsel;
the port writes that batch dimension out and runs the morsel's insert
searches through the batched engine (``ONEHOP_A``, full mask, one seed per
lane). Batched lanes equal single-query searches bit for bit, so this is
the same computation. Morsels are not padded (the reference pads them to
two sizes so ``jit`` compiles at most twice; its padded lanes write
nothing).

Neighbor selection is Toussaint's relative-neighborhood (RNG) rule:
candidate ``c_j`` (ascending distance from ``v``) is kept iff it is closer
to ``v`` than to every previously kept candidate. The same rule shrinks
overflowing adjacency lists when backward edges are added. Upper-sample
nodes are inserted into the lower level first (phase A).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import bitset
from repro_torch.core.distances import (dist_matrix, gather_rows, normalize,
                                        validate_metric)
from repro_torch.core.graph import HnswGraph
from repro_torch.core.heuristics import Heuristic
from repro_torch.core.search import SearchParams
from repro_torch.core.search_batch import (_take_first_batch,
                                           beam_search_lower_batch,
                                           greedy_upper_batch)
from repro_torch.kernels import ops

#: f32 elements of gathered candidate rows held at once by a prune pass
_PRUNE_ELEMS = 1 << 28


class BuildParams(NamedTuple):
    m_u: int = 16                  # upper max degree; M_L = 2 * m_u
    ef_construction: int = 100
    sample_rate: float = 0.05
    metric: str = "l2"
    batch_size: int = 256          # morsel size (paper: 2048 rows / thread)
    new_edge_cap: int = 8          # max backward edges per target per batch
    seed: int = 0


@dataclasses.dataclass
class BuildStats:
    n: int = 0
    n_upper: int = 0
    seconds: float = 0.0
    search_dc: int = 0             # distance computations in insert searches
    batches: int = 0


# ---------------------------------------------------------------------------
# RNG (relative neighborhood) pruning -- Toussaint's rule, over lanes
# ---------------------------------------------------------------------------


def rng_prune_mask(cand_d: torch.Tensor, pd: torch.Tensor,
                   valid: torch.Tensor, m: int) -> torch.Tensor:
    """keep[b, j] per Algorithm 1's SelectNeighbors / RNGShrink.

    ``cand_d``: f32[B, C] distances candidate -> v, ascending. ``pd``:
    f32[B, C, C] pairwise candidate distances. Keeps at most ``m`` per lane.
    """
    bsz, c = cand_d.shape
    keep = torch.zeros((bsz, c), dtype=torch.bool, device=cand_d.device)
    n_kept = torch.zeros(bsz, dtype=torch.int64, device=cand_d.device)
    for i in range(c):
        # min distance from candidate i to any already-kept candidate
        mind = torch.where(keep, pd[:, i, :], torch.inf).amin(dim=1)
        ok = valid[:, i] & (n_kept < m) & (cand_d[:, i] < mind)
        keep[:, i] = ok
        n_kept += ok
    return keep


def _prune_forward(cand_ids: torch.Tensor, cand_d: torch.Tensor,
                   vectors: torch.Tensor, m: int, metric: str) -> torch.Tensor:
    """Up to ``m`` RNG-kept candidates of each lane (ascending ``cand_d``),
    in order, -1 padded; lanes are pruned in chunks to bound memory."""
    c, d = cand_ids.shape[1], vectors.shape[1]
    step = max(1, _PRUNE_ELEMS // (c * d))
    out = []
    for lo in range(0, cand_ids.shape[0], step):
        ids = cand_ids[lo:lo + step]
        X = gather_rows(vectors, ids)                          # [b, C, d]
        keep = rng_prune_mask(cand_d[lo:lo + step], dist_matrix(X, X, metric),
                              ids >= 0, m)
        out.append(_take_first_batch(keep, ids, m))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# one level of construction
# ---------------------------------------------------------------------------


def _graph_view(adj: torch.Tensor, deg: torch.Tensor,
                vectors: torch.Tensor) -> HnswGraph:
    """Wrap one level's adjacency as an HnswGraph for the lower-level loop."""
    dev = vectors.device
    return HnswGraph(
        lower=adj, lower_deg=deg,
        upper=torch.full((1, 1), -1, dtype=torch.int32, device=dev),
        upper_deg=torch.zeros(1, dtype=torch.int32, device=dev),
        upper_ids=torch.zeros(1, dtype=torch.int32, device=dev),
        entry_pos=torch.zeros((), dtype=torch.int32, device=dev),
        vectors=vectors)


def _insert_batch(adj: torch.Tensor, deg: torch.Tensor, vectors: torch.Tensor,
                  batch_ids: torch.Tensor, seeds: torch.Tensor, efc: int,
                  m_fwd: int, m_cap: int, p_cap: int, metric: str) -> int:
    """Insert a morsel of nodes into one level, updating ``adj`` / ``deg``
    in place. Returns the insert searches' distance computations."""
    n = vectors.shape[0]
    bsz = batch_ids.shape[0]
    dev = vectors.device
    params = SearchParams(k=efc, efs=efc, heuristic=int(Heuristic.ONEHOP_A),
                          metric=metric)
    beam_d, beam_id, stats = beam_search_lower_batch(
        _graph_view(adj, deg, vectors), vectors[batch_ids.long()],
        bitset.full_mask(n, dev), seeds, params)
    # the node being inserted may already appear (re-insert safety)
    beam_id = torch.where(beam_id == batch_ids[:, None], -1, beam_id)
    beam_d = torch.where(beam_id >= 0, beam_d, torch.inf)
    fwd = _prune_forward(beam_id, beam_d, vectors, m_fwd, metric)  # [B, m_fwd]

    # ---- forward edges --------------------------------------------------
    rows = torch.full((bsz, m_cap), -1, dtype=torch.int32, device=dev)
    rows[:, :m_fwd] = fwd
    adj[batch_ids.long()] = rows
    deg[batch_ids.long()] = (rows >= 0).sum(dim=1).to(torch.int32)

    # ---- backward edges (append; RNG-shrink on overflow) ----------------
    tgt = fwd.reshape(-1)                                      # [B*m_fwd]
    src = batch_ids.repeat_interleave(m_fwd)
    valid = tgt >= 0
    big = n + 1
    order = torch.argsort(torch.where(valid, tgt, big), stable=True)
    st, ss, sv = tgt[order], src[order], valid[order]
    prev = torch.cat([torch.full((1,), big, dtype=st.dtype, device=dev),
                      st[:-1]])
    newseg = sv & (st != prev)
    pos = torch.arange(st.shape[0], device=dev)
    seg_first = torch.cummax(torch.where(newseg, pos, 0), dim=0).values
    rank = pos - seg_first
    keep = sv & (rank < p_cap)
    uniq = st[newseg]                                          # [U] targets
    slot = torch.cumsum(newseg.long(), dim=0) - 1
    news = torch.full((uniq.shape[0], p_cap), -1, dtype=torch.int32,
                      device=dev)
    news[slot[keep], rank[keep]] = ss[keep].to(torch.int32)

    t = uniq.long()
    cand = torch.cat([adj[t], news], dim=1)                    # [U, m_cap+P]
    d_t = ops.gather_distance_batch(vectors[t], vectors, cand, metric)
    d_t, o = torch.sort(d_t, dim=1, stable=True)
    cand = cand.gather(1, o)
    valid_c = cand >= 0
    new_rows = _take_first_batch(
        valid_c & (torch.arange(cand.shape[1], device=dev) < m_cap), cand,
        m_cap)
    over = torch.nonzero(valid_c.sum(dim=1) > m_cap)[:, 0]
    if over.numel():
        new_rows[over] = _prune_forward(cand[over], d_t[over], vectors,
                                        m_cap, metric)
    adj[t] = new_rows
    deg[t] = (new_rows >= 0).sum(dim=1).to(torch.int32)
    return int(stats.t_dc.sum())


def _batch_schedule(n_total: int, start: int, batch_size: int):
    """Morsels (lo, hi) in insertion order: a doubling warm-up (1, 2, 4,
    ...) then fixed morsels of ``batch_size``, the reference's schedule, so
    the same nodes share a morsel."""
    out, i, b = [], start, 1
    while i < n_total:
        step = min(b, batch_size, n_total - i)
        out.append((i, i + step))
        i += step
        b *= 2
    return out


def _build_level(vectors: torch.Tensor, ids_in_order: np.ndarray, m_fwd: int,
                 m_cap: int, efc: int, p_cap: int, metric: str,
                 batch_size: int = 256):
    """Build one proximity-graph level over ``vectors`` restricted to
    ``ids_in_order`` (insertion order), seeded at the first node.
    Returns (adj, deg, dc, batches)."""
    n, dev = vectors.shape[0], vectors.device
    adj = torch.full((n, m_cap), -1, dtype=torch.int32, device=dev)
    deg = torch.zeros(n, dtype=torch.int32, device=dev)
    ids = torch.from_numpy(np.asarray(ids_in_order, dtype=np.int32)).to(dev)
    total_dc = 0
    schedule = _batch_schedule(len(ids_in_order), 1, batch_size)
    for lo, hi in schedule:
        seeds = ids[:1].expand(hi - lo)
        total_dc += _insert_batch(adj, deg, vectors, ids[lo:hi], seeds,
                                  efc=efc, m_fwd=m_fwd, m_cap=m_cap,
                                  p_cap=p_cap, metric=metric)
    return adj, deg, total_dc, len(schedule)


# ---------------------------------------------------------------------------
# the full 2-level build
# ---------------------------------------------------------------------------


def build(vectors, params: BuildParams,
          device: str | torch.device | None = None
          ) -> tuple[HnswGraph, BuildStats]:
    """Build the two-level index over ``vectors`` (f32[n, d], numpy or
    torch) on ``device`` (CUDA by default)."""
    validate_metric(params.metric)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    vectors = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
    if params.metric == "cos":
        vectors = normalize(vectors)
    vectors = vectors.contiguous()
    n = vectors.shape[0]
    m_u = params.m_u
    m_l = 2 * m_u
    rng = np.random.default_rng(params.seed)

    n_upper = max(1, int(round(n * params.sample_rate)))
    upper_ids_np = np.sort(rng.choice(n, size=n_upper, replace=False))
    upper_ids = torch.from_numpy(upper_ids_np.astype(np.int32)).to(dev)
    stats = BuildStats(n=n, n_upper=n_upper)

    # ---- upper level over the sampled subset (positions 0..n_u-1) -------
    up_adj, up_deg, dc_u, _ = _build_level(
        vectors[upper_ids.long()].contiguous(), np.arange(n_upper),
        m_fwd=max(m_u // 2, 4), m_cap=m_u,
        efc=max(params.ef_construction // 2, 32), p_cap=params.new_edge_cap,
        metric=params.metric)
    stats.search_dc += dc_u

    # ---- lower level: phase A (upper nodes first), then the rest --------
    rest = np.setdiff1d(np.arange(n, dtype=np.int64), upper_ids_np)
    order = torch.from_numpy(
        np.concatenate([upper_ids_np, rest]).astype(np.int32)).to(dev)
    lo_adj = torch.full((n, m_l), -1, dtype=torch.int32, device=dev)
    lo_deg = torch.zeros(n, dtype=torch.int32, device=dev)
    graph = HnswGraph(lower=lo_adj, lower_deg=lo_deg, upper=up_adj,
                      upper_deg=up_deg, upper_ids=upper_ids,
                      entry_pos=torch.zeros((), dtype=torch.int32, device=dev),
                      vectors=vectors)
    schedule = _batch_schedule(n, 1, params.batch_size)
    for lo, hi in schedule:
        batch = order[lo:hi]
        # phase A morsels are seeded at the first node; phase B morsels use
        # greedy upper-layer entries (all upper nodes are in G_L by then)
        if lo < n_upper:
            seeds = order[:1].expand(hi - lo)
        else:
            seeds, _ = greedy_upper_batch(graph, vectors[batch.long()],
                                          params.metric)
        stats.search_dc += _insert_batch(
            lo_adj, lo_deg, vectors, batch, seeds,
            efc=params.ef_construction, m_fwd=m_u, m_cap=m_l,
            p_cap=params.new_edge_cap, metric=params.metric)
    stats.batches = len(schedule)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats.seconds = time.perf_counter() - t0
    return graph, stats
