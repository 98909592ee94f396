"""Postfiltering baseline (port of ``repro.core.postfilter``; paper Section
5.7: PGVectorScale / VBase style).

Postfiltering streams vectors from the *unfiltered* index nearest-first and
verifies each against the selection predicate until k survivors are found.
Costs decompose exactly as in the paper: vector-search cost (how far the
stream must run, driven by selectivity/correlation) + verification cost
(one membership check per streamed tuple).

The stream is realized by re-running the unfiltered single-query search
with doubling ``efs`` until k selected vectors appear among the results --
the way Postgres-based systems re-execute the index scan with a larger
limit. Every restart is one :func:`repro_torch.core.search.search`, whose
distances on the card are one-lane launches of the gather kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.graph import HnswGraph
from repro_torch.core.heuristics import Heuristic
from repro_torch.core.search import SearchParams, search


class PostfilterStats(NamedTuple):
    restarts: int
    verifications: int     # streamed tuples checked against S
    t_dc: int              # distance computations across all restarts
    final_efs: int


def postfilter_search(graph: HnswGraph, q: torch.Tensor,
                      sel_bits: torch.Tensor, k: int, metric: str = "l2",
                      efs0: int = 0, max_efs: int = 4096):
    """Returns (dists f32[k], ids int64[k], PostfilterStats), numpy. -1
    padded when fewer than k selected vectors are reachable within max_efs;
    the cap bounds the stream length (real postfiltering systems bail to
    brute force below ~5% selectivity for the same reason, paper 5.1.1)."""
    efs = efs0 or max(2 * k, 64)
    full = bitset.full_mask(graph.n, graph.device)
    restarts = verifications = t_dc = 0
    while True:
        params = SearchParams(k=efs, efs=efs, metric=metric,
                              heuristic=int(Heuristic.ONEHOP_A))
        res = search(graph, q, full, params)
        t_dc += int(res.stats.t_dc)
        ok = bitset.test(sel_bits, res.ids).cpu().numpy()
        ids = res.ids.cpu().numpy()
        dists = res.dists.cpu().numpy()
        verifications += int((ids >= 0).sum())
        sel_ids, sel_d = ids[ok], dists[ok]
        restarts += 1
        if len(sel_ids) >= k or efs >= max_efs:
            break
        efs = min(efs * 2, max_efs)
    out_d = np.full(k, np.inf, np.float32)
    out_i = np.full(k, -1, np.int64)
    out_d[:min(k, len(sel_d))] = sel_d[:k]
    out_i[:min(k, len(sel_ids))] = sel_ids[:k]
    return out_d, out_i, PostfilterStats(restarts, verifications, t_dc, efs)
