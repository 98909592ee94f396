"""The harness's parts on their own: the reference against a naive loop,
the program's plan selections against the oracle's, the import guard, the
trace's reduction and the roofline readers."""

from __future__ import annotations

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from portbench import data, run
from portbench.reference import Reference, compare, oracle_mask
from portbench.spec import Bench
from portbench.tests.conftest import TEST_CELLS
from portbench.trace import summary

PKG = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_portbench_reference_topk_matches_a_naive_loop(metric):
    g = np.random.default_rng(0)
    X = g.standard_normal((300, 7)).astype(np.float32)
    Q = g.standard_normal((9, 7)).astype(np.float32)
    mask = g.random(300) < 0.2
    k = 12
    d, ids = Reference(X, metric, "cpu").topk(Q, mask, k)
    for i, q in enumerate(Q.astype(np.float64)):
        rows = []
        for j, x in enumerate(X.astype(np.float64)):
            if not mask[j]:
                continue
            if metric == "l2":
                dist = sum((a - b) ** 2 for a, b in zip(x, q))
            else:
                dist = 1 - float(x @ q) / np.linalg.norm(x) / np.linalg.norm(q)
            rows.append((dist, j))
        rows.sort()
        assert ids[i].tolist() == [j for _, j in rows[:k]]
        np.testing.assert_allclose(d[i].numpy(), [t for t, _ in rows[:k]],
                                   rtol=1e-12, atol=1e-12)


def test_portbench_reference_pads_small_selections():
    X = np.eye(5, dtype=np.float32)
    mask = np.array([True, False, True, False, False])
    d, ids = Reference(X, "l2", "cpu").topk(X[:1], mask, 4)
    assert ids[0].tolist() == [0, 2, -1, -1]
    assert torch.isinf(d[0, 2:]).all()


def test_portbench_compare_counts_each_fault():
    g = np.random.default_rng(1)
    X = g.standard_normal((200, 6)).astype(np.float32)
    Q = [[g.standard_normal((4, 6)).astype(np.float32)]]
    mask = g.random(200) < 0.5
    ref = Reference(X, "l2", "cpu")
    d, ids = ref.topk(Q[0][0], mask, 5)
    ids, d = ids.numpy(), d.numpy().astype(np.float32)

    def numbers(i, dd, sel=mask):
        return compare(ref, [(0, 0, i, dd, sel)], Q, [mask], 5)

    sound = numbers(ids, d)
    assert sound["recall"] == sound["plan_recall"] == 1.0
    assert sound["failed"] == 0 and sound["empty_share"] == 0
    assert sound["dist_gap"] < 1e-6
    assert numbers(ids, d, ~mask)["mask_rows"] == 200
    outside = ids.copy()
    outside[0, 1] = int(np.flatnonzero(~mask)[0])
    assert numbers(outside, d)["bad_answers"] == 1
    twice = ids.copy()
    twice[1, 2] = twice[1, 1]
    assert numbers(twice, d)["bad_answers"] == 1
    short = ids.copy()
    short[2, 3:] = -1
    got = numbers(short, d)
    assert got["empty_answers"] == 0 and got["failed"] == 0
    assert got["by_plan"][0]["short"] == 1
    short[2] = -1
    got = numbers(short, d)
    assert got["empty_answers"] == 1 and got["empty_share"] == 0.25
    assert got["plan_recall"] == got["recall"] == pytest.approx(0.75)
    moved = ids.copy()
    moved[3, 0] = moved[3, 4]
    assert numbers(moved, d)["dist_gap"] > 1e-3


@pytest.mark.parametrize("cell", ["gist960.f32.sweep",
                                  "wiki768.f32.correlated"])
def test_portbench_plan_selections_match_the_oracle(tiny_root, cell):
    """The program's prefilter of every plan of the cell (its store and
    plan operators) selects the rows the oracle works out from the
    generator's arrays, on the full cycle of the committed cell."""
    P = run._program()
    bench = Bench(tiny_root)
    c = bench.cell(cell)
    c["plans"] = (TEST_CELLS[cell][1] if cell in TEST_CELLS else json.loads(
        (PKG / "workloads" / f"{cell}.json").read_text()))["plans"]
    cfg = bench.config(c["config"])
    X, labels, _ = data.make_rows(cfg, 5)
    schema = data.make_schema(cfg, labels, 5)
    db = P["NavixDB"](run.make_store(P, cfg, schema, len(X)), device="cpu")
    for p in c["plans"]:
        got = db.prefilter(run.make_plan(P, cfg, p, len(X))).mask
        want = oracle_mask(p["select"], p["sigma"], schema, len(X),
                           cfg.get("birth_days", 0))
        assert np.array_equal(got, want), p


def test_portbench_forbidden_compares_top_level_names_whole():
    assert run.forbidden(["repro_torch", "repro_torch.api.db", "jax_like",
                          "reproduce", "numpy"]) == []
    assert run.forbidden(["repro", "repro.core.navix", "jax", "jaxlib",
                          "flax.linen", "benchmarks.bench_postfilter",
                          "chip_smoke"]) == sorted(
        ["repro", "repro.core.navix", "jax", "jaxlib", "flax.linen",
         "benchmarks.bench_postfilter", "chip_smoke"])


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_portbench_imports_no_jax_and_the_reference_no_program():
    files = [p for p in PKG.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 5
    for p in files:
        assert run.forbidden(_imports(p)) == [], p
    for name in ("reference.py", "data.py", "roofline.py", "trace.py"):
        tops = {m.split(".")[0] for m in _imports(PKG / name)}
        assert tops <= {"__future__", "numpy", "torch", "re",
                        "collections"}, name


def test_portbench_trace_summary():
    ms = 1_000_000
    span = (0, 100 * ms)
    dev = [(10 * ms, 30 * ms, "void (anonymous namespace)::"
            "gather_distance_tiled_kernel(float const*, int)"),
           (20 * ms, 40 * ms, "Memcpy DtoH"),
           (70 * ms, 90 * ms, "void (anonymous namespace)::"
            "gather_distance_tiled_kernel(float const*, int)"),
           (95 * ms, 120 * ms, "aten_sort")]
    host = [(40 * ms, 70 * ms, "aten::sort"),
            (45 * ms, 60 * ms, "cudaStreamSynchronize")]
    s = summary(span, dev, host)
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.055)
    names = dict(s["device_ops"])
    assert names["(anonymous namespace)::gather_distance_tiled_kernel"] == \
        pytest.approx(0.04)
    idle = dict(s["idle_gaps"])
    # 0-10 and 90-95 in no torch op; 40-70's middle in the synchronize
    assert idle == pytest.approx({"host python": 0.015,
                                  "cudaStreamSynchronize": 0.03})
    assert summary(None, dev, host) is None
    assert summary(span, [], host) is None


def test_portbench_roofline_readers():
    f32 = Bench(PKG.parent).reader("gather_distance_roofline")
    execs = [{"profiled": True, "distances": 1_000_000, "queries": 1024},
             {"profiled": False, "distances": 7, "queries": 1024}]
    k1 = "(anonymous namespace)::gather_distance_spread_kernel"
    k2 = "(anonymous namespace)::quantized_gather_distance_tiled_kernel"
    run_ = {"cell": {"residency": "f32"}, "config": {"dim": 960},
            "executes": execs,
            "trace": {"ops_s": {k1: 0.004, k2: 1.0, "other": 9.0}}}
    need = 1_000_000 * (3840 + 4) + 1024 * 3840
    assert f32(run_) == pytest.approx(100 * need / 3.35e12 / 0.004)
    run_["cell"]["residency"] = "int8"
    assert f32(run_) is None
    run_["cell"]["residency"] = "f32"
    run_["trace"] = None
    assert f32(run_) is None
