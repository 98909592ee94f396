"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with a CUDA device. Set-up makes
the rows, the schema and the queries from ``--seed`` (``portbench.data``),
builds the cell's index on the card through ``NavixDB.create_index``
(``NavixDB.quantize_index`` after it for an int8 cell), and runs one
warm-up execute at the cell's batch size. The window then runs whole
cycles of the cell's plans, one ``NavixDB.execute`` a plan, until
``--seconds`` have passed, and ends with the last execute of the cycle
that completes; nothing may compile inside it (``CompileCounter``). With
``--trace 1`` the first whole cycle that starts after half of
``--seconds`` runs under ``torch.profiler``, so every traced run profiles
the same plans. After the window the program's state is freed and the
plain reference (``portbench.reference``) judges every answer.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (queries), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
``correct`` was decided on beside its limit, which are also the last
lines of standard error. Without a CUDA device, or with fewer than the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import data  # noqa: E402
from portbench.reference import (AT_LEAST, Reference, compare, judge,  # noqa: E402
                                 oracle_mask)
from portbench.spec import Bench  # noqa: E402
from portbench.trace import SPAN, collect, summary  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: top-level module names that no process of the benchmark may hold: JAX,
#: the JAX package (``repro``; the port is ``repro_torch``) and the JAX
#: package's benchmarks and smoke run
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks",
                       "chip_smoke"})
#: the program's kernel caches, at fixed paths inside the checkout (the
#: CUDA sources build into ``src/repro_torch/kernels/_build_out``)
CACHES = {"TRITON_CACHE_DIR": ".portbench_cache/triton",
          "TORCH_EXTENSIONS_DIR": ".portbench_cache/torch_extensions"}
INDEX = "emb"


def forbidden(modules) -> list[str]:
    """The module names whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def _program():
    """The port's modules the harness drives (imported here, so that a
    checkout without ``src/repro_torch`` fails before any result)."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.analysis.runtime import CompileCounter
    from repro_torch.api.db import NavixDB
    from repro_torch.core.navix import NavixConfig
    from repro_torch.kernels import gather_distance, quantized_gather_distance
    from repro_torch.query import operators
    from repro_torch.storage.columnar import GraphStore
    return dict(CompileCounter=CompileCounter, NavixDB=NavixDB,
                NavixConfig=NavixConfig, operators=operators,
                GraphStore=GraphStore,
                counters=(gather_distance, quantized_gather_distance))


def make_store(P: dict, cfg: dict, schema: dict, n: int):
    """The configuration's graph store over the generator's arrays: the
    vectors' table (``cID``) and, for the Wiki schema, Person, Resource
    and the PersonChunk, ResourceChunk and WikiLink relations."""
    store = P["GraphStore"]()
    table = cfg["table"]
    store.add_node_table(table, n, {"cID": schema["cid"]})
    if cfg["schema"] == "wiki":
        s = schema
        store.add_node_table("Person", s["n_person"], {
            "pID": np.arange(s["n_person"]), "birth_date": s["birth"]})
        store.add_node_table("Resource", s["n_resource"],
                             {"rID": np.arange(s["n_resource"])})
        store.add_rel_table("PersonChunk", "Person", table, s["p_owner"],
                            s["p_rows"])
        store.add_rel_table("ResourceChunk", "Resource", table,
                            s["r_owner"], s["r_rows"])
        store.add_rel_table("WikiLink", "Person", "Resource", s["wl_src"],
                            s["wl_dst"])
    return store


def make_plan(P: dict, cfg: dict, plan: dict, n: int):
    """The selection subquery of a traffic file's plan."""
    op = P["operators"]
    kind, sigma = plan["select"], plan["sigma"]
    if kind == "id_range":
        return op.Filter(op.NodeScan(cfg["table"]), "cID", "<",
                         value=int(n * sigma))
    persons = op.Filter(op.NodeScan("Person"), "birth_date", "range", lo=0,
                        hi=int(cfg["birth_days"] * sigma))
    if kind == "person_chunk":
        return op.HopJoin(persons, "PersonChunk", "fwd")
    if kind == "two_hop":
        return op.HopJoin(op.HopJoin(persons, "WikiLink", "fwd"),
                          "ResourceChunk", "fwd")
    raise ValueError(f"unknown selection {kind!r}")


def make_inputs(cfg: dict, cell: dict, seed: int) -> dict:
    """Everything the run hands the program and the reference alike: the
    rows, the schema's arrays, every plan's query blocks and each plan's
    oracle selection."""
    X, labels, centers = data.make_rows(cfg, seed)
    schema = data.make_schema(cfg, labels, seed)
    n = len(X)
    plans = cell["plans"]
    queries = [[data.make_queries(cfg, p["queries"], cell["batch"], X,
                                  centers, schema, seed, i, j)
                for j in range(cell["pool"])] for i, p in enumerate(plans)]
    masks = [oracle_mask(p["select"], p["sigma"], schema, n,
                         cfg.get("birth_days", 0)) for p in plans]
    return dict(X=X, schema=schema, queries=queries, masks=masks, n=n)


def _launches(P: dict) -> int:
    return sum(m.LAUNCHES for m in P["counters"])


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: float | None = None,
             log=print) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    t0 = T0 if t0 is None else t0
    P = _program()
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    dev = torch.device(device)
    inp = make_inputs(cfg, cell, seed)
    n = inp["n"]
    db = P["NavixDB"](make_store(P, cfg, inp["schema"], n), device=dev)
    ix = cfg["index"]
    # only the catalog holds the index, so an int8 entry frees its rows
    bstats = db.create_index(
        INDEX, cfg["table"], column="embedding", vectors=inp["X"],
        config=P["NavixConfig"](m_u=ix["m_u"],
                                ef_construction=ix["ef_construction"],
                                sample_rate=ix["sample_rate"],
                                metric=cfg["metric"],
                                batch_size=ix["morsel"]))[1]
    if cell["residency"] == "int8":
        db.quantize_index(INDEX)
    knns = [P["operators"].KnnSearch(child=make_plan(P, cfg, p, n),
                                     k=cell["k"], efs=cell["efs"],
                                     index=INDEX,
                                     heuristic=cell["heuristic"])
            for p in cell["plans"]]
    Q = inp["queries"]
    db.execute(knns[0], query=Q[0][0])                     # warm-up
    setup_s = time.perf_counter() - t0

    cc = P["CompileCounter"]()
    execs, answers = [], []
    prof, tracing = None, False
    n_plans = len(knns)
    with cc:
        cc.mark("window")
        launched = _launches(P)
        start = time.perf_counter()
        i = 0
        while True:
            if i % n_plans == 0:                     # a cycle's first plan
                now = time.perf_counter() - start
                if tracing:
                    span.__exit__(None, None, None)
                    prof.stop()
                    tracing = False
                if trace and prof is None and now >= seconds / 2:
                    prof = _profiler(dev)
                    prof.start()
                    span = torch.profiler.record_function(SPAN)
                    span.__enter__()
                    tracing = True
                elif i > 0 and now >= seconds and (prof is not None
                                                   or not trace):
                    break
            p, j = i % n_plans, (i // n_plans) % cell["pool"]
            rs = db.execute(knns[p], query=Q[p][j])
            execs.append({"plan": p, "queries": len(rs.ids),
                          "timings": rs.timings.as_dict(),
                          "distances": int(rs.stats.t_dc.sum()
                                           + rs.stats.upper_dc.sum()),
                          "profiled": tracing})
            answers.append((p, j, rs.ids, rs.dists, rs.mask))
            i += 1
        window_s = time.perf_counter() - start
        launched = _launches(P) - launched
    compiled = {k: cc.count(k, "window") for k in ("nvcc", "program")}
    if any(compiled.values()):
        raise RuntimeError(f"the window compiled: {compiled}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del db, rs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = Reference(inp["X"], cfg["metric"], dev)
    got = compare(ref, answers, Q, inp["masks"], cell["k"])
    del ref
    t_ref = time.perf_counter() - t_ref
    queries = sum(e["queries"] for e in execs)
    run = {"cell": cell, "config": cfg, "build_s": bstats.seconds,
           "executes": execs, "launches": launched, "queries": queries,
           "window_s": window_s, "trace": None}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": None, "attempted": queries, "failed": got["failed"]}
    t_trace = time.perf_counter()
    if trace:
        run["trace"] = summary(*collect(prof)) if prof is not None else None
        values = {}
        for m in bench.per_layer(name):
            v = bench.reader(m["name"])(run)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        t = run["trace"] or {"busy_s": 0.0, "window_s": 0.0}
        device_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["metrics"] = values
    else:
        e2e = {"qps": queries / window_s, "recall": got["recall"],
               "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in bench.end_to_end(name)}
    out["device"] = device_info
    if trace and run["trace"] is not None:
        out["breakdown"] = {k: run["trace"][k]
                            for k in ("device_ops", "idle_gaps")}
    out["correct"], checks = judge(got, cell["limits"])
    log(f"window: {len(execs)} executes, {queries} queries in "
        f"{window_s:.3f} s; {got['empty_answers']} empty answers; setup "
        f"{setup_s:.3f} s (build {bstats.seconds:.3f} s); reference "
        f"{t_ref:.3f} s, trace {time.perf_counter() - t_trace:.3f} s")
    for p, plan in enumerate(cell["plans"]):
        ms = [e["timings"]["total_ms"] for e in execs if e["plan"] == p]
        log(f"plan {p} {plan}: {len(ms)} executes, mean "
            f"{sum(ms) / max(len(ms), 1):.1f} ms; {got['by_plan'][p]}")
    for c, v in checks.items():
        log(f"{c} {v['value']!r} limit {v['limit']!r}"
            + (" (at least)" if c in AT_LEAST else ""))
    out["checks"] = checks
    return out


def _profiler(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    args = parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    bench = Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); this host has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    log(f"card (name, power.limit): {_card()}")
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), log=log)
    held = forbidden(sys.modules)
    if held:
        log(f"the process holds forbidden modules: {held}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
