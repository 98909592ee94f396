"""Reduce the profiler's trace of the profiled sub-window to numbers.

The sub-window is the host span :data:`SPAN`, which the harness opens
around one whole cycle of the cell's plans in a traced run's window. Only
device events (kernels, copies, sets) count as busy: host operations
would count the launch overhead as work. A gap between device events is
named by the innermost torch operation the host was in at the gap's
middle (``host python`` where it was in none, as in numpy work).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

SPAN = "portbench.profiled"


def _ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def collect(prof) -> tuple:
    """(span (start, end) ns or None, device events, host events) of a
    stopped ``torch.profiler.profile``; an event is (start, end, name)."""
    span, dev, host = None, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = _ns(e)
        if name == SPAN:
            # the span also shows on the device as a user annotation,
            # which is no device work
            if "CPU" in str(e.device_type()):
                span = (s, t)
        elif "CPU" not in str(e.device_type()):
            dev.append((s, t, name))
        else:
            host.append((s, t, name))
    return span, dev, host


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[5:] if name.startswith("void ") else name


def _merge(iv: np.ndarray) -> np.ndarray:
    """The union of intervals [k, 2] as disjoint sorted intervals."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    starts = iv[new, 0]
    ends = reach[np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]]
    return np.stack([starts, ends], axis=1)


def summary(span, dev: list, host: list, top: int = 10) -> dict | None:
    """Busy and window seconds of the sub-window, device time by
    operation, and idle time by what the host was doing (each a list of
    ``[name, seconds]``, longest first, at most ``top``). None without a
    span or without a device event in it."""
    if span is None:
        return None
    lo, hi = span
    iv = np.array([(max(s, lo), min(t, hi)) for s, t, _ in dev
                   if t > lo and s < hi], dtype=np.int64).reshape(-1, 2)
    busy = _merge(iv)
    if not len(busy):
        return None
    ops: dict = defaultdict(int)
    for s, t, name in dev:
        if t > lo and s < hi:
            ops[short_name(name)] += min(t, hi) - max(s, lo)
    edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    # innermost host operations are the leaves of their nesting; they are
    # disjoint, so a gap's middle falls in at most one
    hs = sorted((s, t, n) for s, t, n in host if t > lo and s < hi)
    leaf = [i for i in range(len(hs))
            if i + 1 == len(hs) or hs[i + 1][0] >= hs[i][1]]
    starts = np.array([hs[i][0] for i in leaf], dtype=np.int64)
    idle: dict = defaultdict(int)
    for s, t in gaps:
        mid = (s + t) // 2
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        inside = j >= 0 and hs[leaf[j]][1] > mid
        idle[hs[leaf[j]][2] if inside else "host python"] += int(t - s)

    def ranked(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"window_s": (hi - lo) / 1e9,
            "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) / 1e9,
            "ops_s": {k: v / 1e9 for k, v in ops.items()},
            "device_ops": ranked(ops), "idle_gaps": ranked(idle)}
