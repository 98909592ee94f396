"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch and numpy: it imports nothing of the program, and works
from the generator's arrays alone (``portbench.data``): the rows, the
schema's arrays and the query blocks that the program was handed too.

* :func:`oracle_mask` is a plan's selection, worked out from the schema's
  arrays without a store or plan operators (a copy of ``chip_smoke.py``'s
  ``oracle_mask``);
* :class:`Reference` is the exact filtered kNN, in float64 on the given
  device: the k nearest selected rows of each query, and the exact
  distance of any row to a query, both smaller-is-closer as the program's
  metrics are (``l2``: squared Euclidean; ``cos``: 1 - the dot product of
  the normalised vectors);
* :func:`compare` holds the program's answers to both and returns the
  numbers that ``correct`` is decided on, and the recall.
"""

from __future__ import annotations

import numpy as np
import torch

#: the numbers of :func:`compare` that ``correct`` is decided on, in
#: order, each against the limit the cell's traffic file gives it: at most
#: the limit, but the recalls at least theirs
CHECKS = ("mask_rows", "bad_answers", "empty_share", "dist_gap", "recall",
          "plan_recall")
AT_LEAST = frozenset({"recall", "plan_recall"})


def oracle_mask(kind: str, sigma: float, a: dict, n: int,
                birth_days: int = 0) -> np.ndarray:
    """bool[n]: the rows a plan of ``kind`` at ``sigma`` selects.

    ``id_range``: ``cid < n * sigma``. ``person_chunk``: the chunks of the
    persons born before ``birth_days * sigma``. ``two_hop``: the chunks of
    the resources those persons link to."""
    if kind == "id_range":
        return a["cid"] < int(n * sigma)
    persons = np.flatnonzero(a["birth"] < int(birth_days * sigma))
    if kind == "person_chunk":
        return np.isin(a["person_of"], persons)
    if kind == "two_hop":
        linked = np.unique(a["wl_dst"][np.isin(a["wl_src"], persons)])
        return np.isin(a["resource_of"], linked)
    raise ValueError(f"unknown selection {kind!r}")


class Reference:
    """Exact filtered kNN over ``X`` (f32[n, d], numpy), in float64 (the
    control computes in ``dtype`` float32 over rows it rounded)."""

    #: elements of one [queries, rows] block of distances
    BLOCK = 1 << 27

    def __init__(self, X: np.ndarray, metric: str, device,
                 dtype: torch.dtype = torch.float64):
        if metric not in ("l2", "cos"):
            raise ValueError(f"unknown metric {metric!r}")
        self.metric, self.device = metric, torch.device(device)
        self.dtype = dtype
        self.X = self._prep(X)
        self.xx = (self.X * self.X).sum(dim=1)
        self.n = self.X.shape[0]

    def _prep(self, A: np.ndarray) -> torch.Tensor:
        A = torch.as_tensor(A).to(self.device, self.dtype)
        if self.metric == "cos":
            A = A / A.norm(dim=1, keepdim=True)
        return A

    def _all(self, Q: torch.Tensor) -> torch.Tensor:
        dots = Q @ self.X.T
        if self.metric == "cos":
            return 1.0 - dots
        return (Q * Q).sum(dim=1)[:, None] + self.xx[None, :] - 2.0 * dots

    def topk(self, Q: np.ndarray, mask: np.ndarray, k: int):
        """(dists f64[b, k], ids int64[b, k]) of the k nearest selected
        rows, ascending; +inf and -1 pad where fewer than k are
        selected."""
        Qd = self._prep(Q)
        sel = torch.as_tensor(mask, device=self.device)
        step = max(1, self.BLOCK // self.n)
        ds, ids = [], []
        for i in range(0, len(Qd), step):
            D = self._all(Qd[i:i + step]).masked_fill_(~sel[None, :],
                                                       torch.inf)
            d, j = torch.topk(D, min(k, self.n), dim=1, largest=False)
            ds.append(d)
            ids.append(torch.where(torch.isfinite(d), j, -1))
        return torch.cat(ds), torch.cat(ids)

    def dists(self, Q: np.ndarray, ids: np.ndarray) -> torch.Tensor:
        """f64[b, k]: the exact distance of row ``ids[i, j]`` to query i,
        in its direct form (+inf where the id is out of range)."""
        Qd = self._prep(Q)
        ids = torch.as_tensor(ids, device=self.device).long()
        ok = (ids >= 0) & (ids < self.n)
        out = []
        step = max(1, self.BLOCK // max(1, ids.shape[1] * self.X.shape[1]))
        for i in range(0, len(Qd), step):
            rows = self.X[ids[i:i + step].clamp(0, self.n - 1)]
            q = Qd[i:i + step, None, :]
            if self.metric == "cos":
                out.append(1.0 - (rows * q).sum(dim=-1))
            else:
                out.append(((rows - q) ** 2).sum(dim=-1))
        return torch.where(ok, torch.cat(out), torch.inf)


def judge(got: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, each number of :data:`CHECKS` beside its limit)."""
    checks = {c: {"value": got[c], "limit": limits[c]} for c in CHECKS}
    return all(v["value"] >= v["limit"] if c in AT_LEAST
               else v["value"] <= v["limit"]
               for c, v in checks.items()), checks


def compare(ref: Reference, answers, queries, masks, k: int) -> dict:
    """The numbers ``correct`` is decided on, over every answer.

    ``answers``: (plan, block, ids int[b, k], dists f32[b, k], the
    program's selection bool[n]) for each execute. ``queries[plan][block]``
    is the block the program was handed, ``masks[plan]`` the oracle's
    selection. Returns ``mask_rows`` (rows where a program selection
    differs from the oracle's), ``bad_answers`` (answers with an id out
    of range or outside the selection, a repeated id, an id after a -1
    pad, or a distance that is not finite or falls), ``empty_answers``
    (answers with no id where the selection holds a row), ``dist_gap``
    (the widest
    gap between a returned distance and the exact distance of its id, as
    a share of that query's exact k-th distance), ``recall`` (the mean
    over answers of the share of the exact k nearest that came back),
    ``empty_share`` (empty answers over all answers), ``plan_recall`` (the
    lowest of the plans' recalls), ``answers``, ``failed`` (bad or empty)
    and ``by_plan`` (each plan's recall, answers, and answers with fewer
    than min(k, |S|) ids)."""
    out = dict(mask_rows=0, bad_answers=0, empty_answers=0, dist_gap=0.0)
    hits = n_answers = failed = 0
    exact: dict = {}
    by_plan = {p: [0.0, 0, 0] for p in range(len(masks))}  # recall, n, short
    for plan, block, ids, dists, sel in answers:
        mask = masks[plan]
        out["mask_rows"] += int(np.count_nonzero(sel != mask))
        Q = queries[plan][block]
        if (plan, block) not in exact:
            exact[(plan, block)] = ref.topk(Q, mask, k)
        e_d, e_ids = exact[(plan, block)]
        ids_t = torch.as_tensor(ids, device=ref.device).long()
        d_t = torch.as_tensor(dists, device=ref.device).to(torch.float64)
        valid = ids_t >= 0
        sel_t = torch.as_tensor(mask, device=ref.device)
        inside = (ids_t < ref.n) & sel_t[ids_t.clamp(0, ref.n - 1)]
        srt = ids_t.sort(dim=1).values
        repeat = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
        gapped = (valid[:, 1:] & ~valid[:, :-1]).any(1)
        both = valid[:, 1:] & valid[:, :-1]
        falls = (both & ~(d_t[:, 1:] >= d_t[:, :-1])).any(1)
        bad = (valid & ~(inside & torch.isfinite(d_t))).any(1) | repeat \
            | gapped | falls
        want = min(k, int(mask.sum()))
        short = valid.sum(1) < want
        empty = (valid.sum(1) == 0) & (want > 0)
        good = valid & inside
        kth = e_d[:, :want].max(dim=1).values if want else \
            torch.ones(len(ids_t), dtype=torch.float64, device=ref.device)
        gap = ((d_t - ref.dists(Q, ids)).abs() / kth[:, None].abs())
        gap = torch.where(good, gap, 0.0)
        if gap.numel():
            out["dist_gap"] = max(out["dist_gap"], float(gap.max()))
        e_valid = e_ids >= 0
        found = ((e_ids[:, :, None] == ids_t[:, None, :])
                 & valid[:, None, :]).any(2) & e_valid
        got = float((found.sum(1) / e_valid.sum(1).clamp(min=1)).sum())
        hits += got
        n_answers += len(ids_t)
        by_plan[plan][0] += got
        by_plan[plan][1] += len(ids_t)
        by_plan[plan][2] += int(short.sum())
        out["bad_answers"] += int(bad.sum())
        out["empty_answers"] += int(empty.sum())
        failed += int((bad | empty).sum())
    plans = {p: {"recall": r / max(m, 1), "answers": m, "short": sh}
             for p, (r, m, sh) in by_plan.items()}
    out.update(recall=hits / max(n_answers, 1), answers=n_answers,
               failed=failed, by_plan=plans,
               empty_share=out["empty_answers"] / max(n_answers, 1),
               plan_recall=min((v["recall"] for v in plans.values()
                                if v["answers"]), default=0.0))
    return out
