"""The control of ``correct``: the reference in the program's place, one
precision down.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

The configurations state float32 distances, so the control stores the
rows and the queries in bfloat16 (the step that would halve the gather's
bytes) and answers each execute of the cell's cycle with the exact
filtered kNN over those rounded values, in float32 with TF32 off, and
their distances. The oracle's selections stand in for the program's.
Then the same comparison as a run's judges it, over as many executes as
one pass over the cell's query pool. It must come out not correct. The
benchmark's own runs never run it; it needs no index, so no build.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench.reference import CHECKS, Reference, compare, judge
from portbench.run import ROOT, make_inputs
from portbench.spec import Bench


def control_answers(inp: dict, cell: dict, metric: str, device) -> list:
    """The control's answers, one per execute of a pass over the pool, in
    the program's order (plan ``i % plans``, block ``i // plans``)."""
    X = torch.as_tensor(inp["X"]).to(device)
    if metric == "cos":
        X = X / X.norm(dim=1, keepdim=True)
    low = Reference(X.to(torch.bfloat16).float().cpu().numpy(), metric,
                    device, dtype=torch.float32)
    n_plans = len(cell["plans"])
    out = []
    for i in range(n_plans * cell["pool"]):
        p, j = i % n_plans, i // n_plans
        Q = torch.as_tensor(inp["queries"][p][j]).to(device)
        if metric == "cos":
            Q = Q / Q.norm(dim=1, keepdim=True)
        Qb = Q.to(torch.bfloat16).float().cpu().numpy()
        _, ids = low.topk(Qb, inp["masks"][p], cell["k"])
        d = low.dists(Qb, ids.cpu().numpy())
        out.append((p, j, ids.cpu().numpy(),
                    d.float().cpu().numpy(), inp["masks"][p]))
    return out


def control(bench: Bench, name: str, seed: int, device) -> dict:
    """The numbers the control reads on ``seed``, with ``correct``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    inp = make_inputs(cfg, cell, seed)
    answers = control_answers(inp, cell, cfg["metric"], device)
    got = compare(Reference(inp["X"], cfg["metric"], device), answers,
                  inp["queries"], inp["masks"], cell["k"])
    correct, _ = judge(got, cell["limits"])
    return {"seed": seed, "correct": correct,
            **{c: got[c] for c in CHECKS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    for s in args.seeds.split(","):
        print(json.dumps(control(bench, args.workload, int(s),
                                 torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
