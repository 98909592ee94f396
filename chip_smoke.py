#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version, builds a GIST1M-shaped index on the
card (n = 1,000,000 x d = 960, l2, the paper's index settings), answers
filtered batched queries at the paper's selectivities through
``NavixIndex.search_many`` and checks the answers: the batched engine
against the port's single-query search, bit for bit, and against the same
search run on CPU copies through the plain version. Each phase prints one
line; a failed phase raises, so the script exits non-zero and prints no
``ok`` line. The last three lines are the card's name and power limit, a
JSON line of per-kernel numbers, and ``{"ok": true, "device": ...}``.

It needs one CUDA device and exits non-zero without one. It imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port itself: without the repository around this file these imports
# fail, before anything is printed
from repro_torch.configs.navix_paper import (PAPER_INDEX,  # noqa: E402
                                             SELECTIVITIES)
from repro_torch.core.graph import check_symmetric_fraction  # noqa: E402
from repro_torch.core.navix import NavixIndex  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.kernels import _build, gather_distance, ref  # noqa: E402

# GIST1M (TEXMEX; the paper's Table 2): 1M vectors of width 960, l2
N_GIST = 1_000_000
N = N_GIST                   # vectors indexed (cut only to fit the time limit)
DIM = 960
N_CLUSTERS = 1000
N_QUERIES = 1024
K = 100
EFS = 200
BUILD_MORSEL = 2048          # the paper's morsel size
PARITY_LANES = 64
PARITY_SIGMAS = (1.0, 0.1, 0.01)
# kernel vs plain version: a different f32 summation order
RTOL, ATOL = 1e-5, 1e-4
# the card's memory rate (H100 SXM data sheet) for the bound
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/gather_distance.cu"
KERNEL_REPLACES = "src/repro/kernels/gather_distance.py:125"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events,
    after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def gather_bound_ms(Q: torch.Tensor, ids: torch.Tensor) -> float:
    """Least time for one gather-distance call on these inputs: each valid
    candidate row read once (4d bytes), each id, each query row and each
    output moved once, at the card's memory rate."""
    bsz, k = ids.shape
    d = Q.shape[1]
    rows = int(torch.unique(ids[ids >= 0]).numel())
    nbytes = rows * 4 * d + 4 * bsz * k + 4 * bsz * d + 4 * bsz * k
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {line} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    return line


def _padded_ids(gen: torch.Generator, bsz: int, k: int, n: int) -> torch.Tensor:
    """Random ids in [0, n) with -1 padding and out-of-range ids (>= n)."""
    ids = torch.randint(0, n, (bsz, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    r = torch.rand((bsz, k), generator=gen, device="cuda")
    ids = torch.where(r < 0.2, -1, ids)
    ids = torch.where((r >= 0.2) & (r < 0.25), n + 7, ids)
    ids[0] = -1                                     # a fully retired lane
    return ids


def _kernel_shapes() -> list[tuple[int, int]]:
    """(B, K) of every launch on the main path at this run's settings."""
    m_u = PAPER_INDEX.m_u
    m_l = 2 * m_u
    p_cap = PAPER_INDEX.build_params().new_edge_cap
    return [
        (N_QUERIES, 1),                # search: entry and seed distances
        (N_QUERIES, m_u),              # search: upper-descent steps
        (N_QUERIES, m_l),              # search: beam iterations
        (BUILD_MORSEL, 1),             # build: seeds of a morsel's searches
        (BUILD_MORSEL, m_l),           # build: insert-search iterations
        (BUILD_MORSEL, m_u + p_cap),   # build: upper-level edge merge
        (BUILD_MORSEL, m_l + p_cap),   # build: lower-level edge merge, over
        (BUILD_MORSEL * m_u, m_l + p_cap),  # up to morsel x m_u targets
    ]


def _check_kernel(vecs: torch.Tensor, qs: torch.Tensor, ids: torch.Tensor,
                  metric: str) -> tuple[float, float]:
    """Kernel vs plain version on the same inputs; (max abs, max rel) err.
    The plain version runs in slices of lanes to bound its [b, K, d]
    gather."""
    got = gather_distance.gather_distance_batch(qs, vecs, ids, metric)
    want = torch.cat([ref.gather_distance_batch(qs[i:i + 4096], vecs,
                                                ids[i:i + 4096], metric)
                      for i in range(0, qs.shape[0], 4096)])
    sync()
    where = f"{metric}, B={ids.shape[0]}, K={ids.shape[1]}, d={qs.shape[1]}"
    check(torch.equal(torch.isinf(got), torch.isinf(want)),
          f"kernel places +inf differently ({where})")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0, 0.0
    err = (got[fin] - want[fin]).abs()
    check(bool((err <= ATOL + RTOL * want[fin].abs()).all()),
          f"kernel disagrees with its plain version ({where}): max abs err "
          f"{float(err.max())}")
    return (float(err.max()),
            float((err / want[fin].abs().clamp(min=1e-30)).max()))


def phase_kernel() -> dict:
    t0 = time.perf_counter()
    _build.load("gather_distance")
    info = _build.build_info.get("gather_distance", {})
    build_s = time.perf_counter() - t0
    for ln in info.get("log", "").splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"[kernel] ptxas: {ln.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    vectors = torch.randn((N, DIM), generator=gen, device="cuda")
    shapes = _kernel_shapes()
    max_abs = max_rel = 0.0
    for bsz, k in shapes:
        qs = torch.randn((bsz, DIM), generator=gen, device="cuda")
        ids = _padded_ids(gen, bsz, k, N)
        for metric in ("l2", "cos", "dot"):
            a, r = _check_kernel(vectors, qs, ids, metric)
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
    del qs, ids
    # an odd width exercises the kernel's unaligned (4-byte load) path
    v_odd = torch.randn((4096, 33), generator=gen, device="cuda")
    for bsz, k in ((64, 64), (64, 72)):
        q_odd = torch.randn((bsz, 33), generator=gen, device="cuda")
        ids = _padded_ids(gen, bsz, k, v_odd.shape[0])
        for metric in ("l2", "cos", "dot"):
            a, r = _check_kernel(v_odd, q_odd, ids, metric)
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
    print(f"[kernel] kernel == plain version at every (B, K) of the main "
          f"path, d={DIM}, l2/cos/dot: "
          + ", ".join(f"({b}, {k})" for b, k in shapes)
          + "; and d=33 at K=64, 72", flush=True)

    Q = torch.randn((N_QUERIES, DIM), generator=gen, device="cuda")
    timings = {}
    for k in (64, 32):      # beam iterations use K = M_L, the descent M_U
        ids = _padded_ids(gen, N_QUERIES, k, N)
        timings[k] = (
            cuda_ms(lambda: gather_distance.gather_distance_batch(
                Q, vectors, ids, "l2"), reps=50),
            cuda_ms(lambda: ref.gather_distance_batch(
                Q, vectors, ids, "l2"), reps=10),
            gather_bound_ms(Q, ids))
    ms, plain_ms, bound_ms = timings[64]
    shown = "; ".join(
        f"K={k}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, bound "
        f"{t[2]:.4f} ms (bytes)" for k, t in timings.items())
    print(f"[kernel] gather_distance_batch built in {build_s:.3f}s "
          f"(nvcc {info.get('seconds', 0.0):.3f}s); max abs err {max_abs:.3e}"
          f", max rel err {max_rel:.3e} (rtol {RTOL}, atol {ATOL}); B="
          f"{N_QUERIES} d={DIM} l2, 20% ids -1: {shown}", flush=True)
    return {"name": "gather_distance_batch", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def make_data(n: int):
    X, _, centers = gaussian_mixture(n, DIM, N_CLUSTERS, seed=0)
    rng = np.random.default_rng(1)
    base = centers[rng.integers(0, len(centers), size=N_QUERIES)]
    Q = (base + 0.3 * rng.normal(size=base.shape)).astype(np.float32)
    return X, Q


def phase_build(X: np.ndarray):
    cfg = PAPER_INDEX._replace(batch_size=BUILD_MORSEL)
    torch.cuda.reset_peak_memory_stats()
    idx, stats = NavixIndex.create(X, cfg)            # on the card
    peak = torch.cuda.max_memory_allocated()
    g = idx.graph
    check(g.device.type == "cuda", "index was not built on the card")
    mean_deg = float(g.lower_deg.float().mean())
    sym = check_symmetric_fraction(g)
    check(mean_deg > 0 and int(g.lower_deg.max()) <= g.m_l,
          f"degenerate lower graph (mean degree {mean_deg})")
    cut = "" if g.n == N_GIST else f" (n cut from {N_GIST:,} to {g.n:,})"
    print(f"[build] n={g.n:,}{cut} d={g.dim} l2 m_u={cfg.m_u} M_L={g.m_l} "
          f"efc={cfg.ef_construction} morsel={cfg.batch_size}: "
          f"{stats.seconds:.3f}s, n_upper={g.n_upper}, mean lower degree "
          f"{mean_deg:.3f}, symmetric fraction {sym:.4f}, "
          f"search_dc={stats.search_dc}, peak device memory "
          f"{peak / 2**30:.3f} GiB (index {g.nbytes() / 2**30:.3f} GiB)",
          flush=True)
    return idx


def make_masks(n: int, sigmas) -> dict[float, np.ndarray]:
    rng = np.random.default_rng(2)
    return {s: rng.random(n) < s for s in sigmas}


def phase_search(idx, Q: np.ndarray, masks) -> dict[float, object]:
    results = {}
    for sigma, mask in masks.items():
        idx.search_many(Q, k=K, efs=EFS, semimask=mask)       # warm-up
        sync()
        before = gather_distance.LAUNCHES
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = idx.search_many(Q, k=K, efs=EFS, semimask=mask)
        sync()
        dt = time.perf_counter() - t0
        work = torch.cuda.max_memory_allocated() - base
        launches = gather_distance.LAUNCHES - before
        check(launches > 0, f"sigma={sigma}: the search launched no kernel")
        check(tuple(res.ids.shape) == (len(Q), K)
              and bool(torch.isfinite(res.dists[res.ids >= 0]).all()),
              f"sigma={sigma}: malformed result")
        true_ids = torch.cat([idx.brute_force(Q[i:i + 256], k=K,
                                              semimask=mask)[1]
                              for i in range(0, len(Q), 256)])
        rec = idx.recall(res.ids, true_ids)
        st = res.stats
        picks = (st.picks.float().mean(dim=0)).tolist()
        print(f"[search] sigma={sigma}: QPS {len(Q) / dt:.1f} ({dt:.3f}s for "
              f"B={len(Q)}), recall@{K} {rec:.4f}, mean t_dc "
              f"{float(st.t_dc.float().mean()):.1f}, mean s_dc "
              f"{float(st.s_dc.float().mean()):.1f}, mean picks "
              f"[onehop-s {picks[0]:.1f}, directed {picks[1]:.1f}, blind "
              f"{picks[2]:.1f}], iters max {int(st.iters.max())} mean "
              f"{float(st.iters.float().mean()):.1f}, kernel launches "
              f"{launches}, pass working set {work / 2**30:.3f} GiB",
              flush=True)
        results[sigma] = res
    return results


def phase_profile(idx, Q: np.ndarray, mask) -> None:
    """One search pass under torch.profiler: where its time goes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idx.search_many(Q, k=K, efs=EFS, semimask=mask)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in events
                    if "gather_distance_batch_kernel" in e.key) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    check(device_ms > 0, "the profiler saw no device time")
    print(f"[profile] sigma=0.1, one pass of B={len(Q)} under torch.profiler:"
          f" wall {wall_ms:.1f} ms, device busy {device_ms:.1f} ms "
          f"({100 * device_ms / wall_ms:.1f}% of wall), gather_distance "
          f"kernel {kernel_ms:.1f} ms ({100 * kernel_ms / device_ms:.1f}% of "
          f"device time), {launches} kernel launches from the host",
          flush=True)


def _same_result(one, many, i: int) -> bool:
    """Single-query result ``one`` equals lane ``i`` of ``many``, bitwise."""
    return (torch.equal(one.ids, many.ids[i])
            and torch.equal(one.dists, many.dists[i])
            and all(torch.equal(getattr(one.stats, f),
                                getattr(many.stats, f)[i])
                    for f in one.stats._fields))


def phase_parity(idx, Q: np.ndarray, masks) -> None:
    Qp = Q[:PARITY_LANES]
    cpu_idx = NavixIndex.from_graph(idx.graph, idx.config, device="cpu")
    identical = total = 0
    for sigma in PARITY_SIGMAS:
        mask = masks[sigma]
        many = idx.search_many(Qp, k=K, efs=EFS, semimask=mask)
        for i in range(PARITY_LANES):
            one = idx.search(Qp[i], k=K, efs=EFS, semimask=mask)
            check(_same_result(one, many, i),
                  f"sigma={sigma} lane {i}: batched engine != single-query "
                  f"search on the card")
        plain = cpu_idx.search_many(Qp, k=K, efs=EFS, semimask=mask)
        gpu_ids, gpu_d = many.ids.cpu(), many.dists.cpu()
        for i in range(PARITY_LANES):
            total += 1
            if torch.equal(plain.ids[i], gpu_ids[i]):
                identical += 1
                continue
            # the lanes may differ only by the order of near-tied distances
            check(torch.allclose(plain.dists[i], gpu_d[i], rtol=1e-5,
                                 atol=0.0),
                  f"sigma={sigma} lane {i}: kernel path and plain path "
                  f"differ beyond a distance tie")
    check(identical >= 0.99 * total,
          f"only {identical}/{total} lanes identical to the plain path")
    print(f"[parity] batched == single-query on the card, bit for bit: "
          f"{len(PARITY_SIGMAS) * PARITY_LANES}/"
          f"{len(PARITY_SIGMAS) * PARITY_LANES} lanes (sigma "
          f"{PARITY_SIGMAS}); kernel path vs plain path on CPU copies: "
          f"{identical}/{total} lanes with identical ids, the rest differ "
          f"only at ties within 1e-5 relative", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False     # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = phase_device()
    kernel = timed("kernel", phase_kernel)
    torch.cuda.empty_cache()

    X, Q = timed("data", make_data, N)
    print(f"[data] gaussian_mixture({N:,}, {DIM}, {N_CLUSTERS}, seed=0) and "
          f"{N_QUERIES} queries on the host: {seconds['data']:.1f}s",
          flush=True)
    masks = make_masks(len(X), SELECTIVITIES)
    masks[1.0] = None
    gather_distance.LAUNCHES = 0                       # the main path: build
    idx = timed("build", phase_build, X)               # + search
    del X
    build_launches = gather_distance.LAUNCHES
    timed("search", phase_search, idx, Q,
          {s: masks[s] for s in SELECTIVITIES})
    kernel["launches"] = gather_distance.LAUNCHES
    check(kernel["launches"] > build_launches,
          "the search phase launched no gather_distance kernel")
    print(f"[launches] gather_distance_batch: {build_launches} in the build, "
          f"{kernel['launches'] - build_launches} in the search phase",
          flush=True)
    timed("profile", phase_profile, idx, Q, masks[0.1])
    timed("parity", phase_parity, idx, Q, masks)
    print(f"[done] {time.perf_counter() - t_start:.1f}s; phases (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()),
          flush=True)
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
