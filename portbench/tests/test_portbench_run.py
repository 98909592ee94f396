"""The harness end to end at a tiny size on the CPU: the command line, the
result line, the comparison that decides ``correct`` (sound runs pass;
the control and each fault the cells can have fail), and a cell, a
configuration and a per-layer metric added by files alone."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from portbench import run
from portbench.control import control
from portbench.faults import FAULTS
from portbench.reference import CHECKS
from portbench.spec import Bench
from portbench.tests.conftest import TINY_CELL

CELLS = ("gist960.f32.sweep", "wiki768.f32.correlated", "gist960.int8.sweep")


def _run(root, cell, seed=7, trace=False, seconds=0.3):
    return run.run_cell(Bench(root), cell, seed, seconds, trace,
                        device="cpu", t0=time.perf_counter(),
                        log=lambda *_: None)


def test_portbench_parse_args():
    a = run.parse_args(["--workload", "gist960.f32.sweep", "--seed",
                        str(2**31 + 17), "--seconds", "30", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "gist960.f32.sweep", 2**31 + 17, 30.0, 1)
    with pytest.raises(SystemExit):
        run.parse_args(["--workload", "x", "--seed", "1", "--seconds", "1",
                        "--trace", "2"])


def test_portbench_main_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert run.main(["--workload", "gist960.f32.sweep", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_portbench_line(tiny_root, cell, trace):
    out = _run(tiny_root, cell, trace=trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    bench = Bench(tiny_root)
    want = bench.per_layer(cell) if trace else bench.end_to_end(cell)
    got = set(out["metrics"])
    assert got <= {m["name"] for m in want}
    if not trace:       # a CPU run has no device trace to read
        assert got == {"qps", "recall", "setup_s"}
        assert 0.9 <= out["metrics"]["recall"]["value"] <= 1.0
    else:
        assert {"build_s", "search_ms", "prefilter_ms"} <= got
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(out["device"])
    assert list(out["checks"]) == list(CHECKS) == [
        "mask_rows", "bad_answers", "empty_share", "dist_gap", "recall",
        "plan_recall"]
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS[:2])
def test_portbench_same_seed_same_inputs(tiny_root, cell):
    bench = Bench(tiny_root)
    c = bench.cell(cell)
    cfg = bench.config(c["config"])
    a, b = (run.make_inputs(cfg, c, 2**31 + 3) for _ in range(2))
    other = run.make_inputs(cfg, c, 2**31 + 4)
    assert np.array_equal(a["X"], b["X"])
    assert all(np.array_equal(x, y) for p, q in zip(a["queries"],
                                                     b["queries"])
               for x, y in zip(p, q))
    assert all(np.array_equal(x, y) for x, y in zip(a["masks"], b["masks"]))
    assert not np.array_equal(a["X"], other["X"])


@pytest.mark.parametrize("cell", CELLS[:2])
def test_portbench_control_is_not_correct(tiny_root, cell):
    got = control(Bench(tiny_root), cell, 11, torch.device("cpu"))
    limit = Bench(tiny_root).cell(cell)["limits"]["dist_gap"]
    assert got["correct"] is False and got["dist_gap"] > limit


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_portbench_fault_is_not_correct(tiny_root, cell, fault):
    with FAULTS[fault]():
        out = _run(tiny_root, cell)
    assert out["correct"] is False


def test_portbench_window_runs_whole_cycles_and_profiles_one(tiny_root):
    """The window ends at a cycle's end, and a traced run profiles the
    first whole cycle that starts after half of the window."""
    seen = tiny_root / "executes.json"
    (tiny_root / "portbench" / "metrics" / "executes_seen.py").write_text(
        "import json\n"
        "def read(run):\n"
        f"    open({str(seen)!r}, 'w').write(json.dumps(run['executes']))\n"
        "    return len(run['executes'])\n")
    doc = json.loads((tiny_root / "BENCHMARK.json").read_text())
    doc["per_layer"].append({"name": "executes_seen", "unit": "executes",
                             "better": "higher", "layer": "test",
                             "source": "program_counter", "moves": "qps"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(doc))
    n_plans = len(Bench(tiny_root).cell(CELLS[0])["plans"])
    out = _run(tiny_root, CELLS[0], trace=True, seconds=1.0)
    assert out["correct"] is True
    execs = json.loads(seen.read_text())
    assert len(execs) % n_plans == 0 and len(execs) > n_plans
    assert [e["plan"] for e in execs] == [i % n_plans
                                          for i in range(len(execs))]
    prof = [i for i, e in enumerate(execs) if e["profiled"]]
    assert len(prof) == n_plans and prof[0] % n_plans == 0
    assert prof == list(range(prof[0], prof[0] + n_plans))


def test_portbench_added_by_files_alone(tiny_root):
    """A configuration, a cell and a per-layer metric, each one new file
    and one new entry in BENCHMARK.json, run with no file edited."""
    pkg = tiny_root / "portbench"
    cfg = json.loads((pkg / "configs" / "gist960_l2.json").read_text())
    cfg.update(name="gist512_l2", dim=16)
    (pkg / "configs" / "gist512_l2.json").write_text(json.dumps(cfg))
    cell = json.loads((pkg / "workloads" / "gist960.f32.sweep.json")
                      .read_text())
    cell["plans"] = cell["plans"][:1]
    (pkg / "workloads" / "gist512.f32.one.json").write_text(
        json.dumps(cell))
    (pkg / "metrics" / "queries_per_execute.py").write_text(
        "def read(run):\n"
        "    return run['queries'] / len(run['executes'])\n")
    doc = json.loads((tiny_root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "gist512_l2", "source": "test",
                           "file": "portbench/configs/gist512_l2.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "gist512.f32.one",
                             "config": "gist512_l2", "traffic": "one",
                             "chips": 1, "why": "test"})
    doc["per_layer"].append({"name": "queries_per_execute",
                             "unit": "queries", "better": "higher",
                             "source": "program_counter", "layer": "test",
                             "moves": "qps"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(doc))
    out = _run(tiny_root, "gist512.f32.one", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["queries_per_execute"]["value"] == TINY_CELL["batch"]
    assert "queries_per_execute" in out["metrics"]
    bench = Bench(tiny_root)
    assert bench.config("gist512_l2")["dim"] == 16
    # a metric without a workloads key applies to every cell
    assert "queries_per_execute" in {m["name"] for m in
                                     bench.per_layer("gist960.f32.sweep")}


@pytest.mark.cuda
def test_portbench_tiny_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in CELLS:
        out = run.run_cell(Bench(tiny_root), cell, 5, 0.3, True,
                           device="cuda", t0=time.perf_counter(),
                           log=lambda *_: None)
        assert out["correct"] is True
        assert out["device"]["busy_s"] > 0
