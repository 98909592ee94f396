"""Faults planted in the program, to read what ``correct`` makes of them.

    python3 -m portbench.faults --workload <cell> --fault <name> \
        --seeds 1,2,3 [--seconds 10]

Each fault is a context manager that breaks the timed path underneath a
run, as a later change might: a beam step that returns its state
unchanged, half of each batch left out (its lanes get the other half's
answers), one answer's id altered where it is produced. Under it a whole
run of the cell (set-up, window, the reference's comparison) prints the
numbers ``correct`` is decided on, one JSON line a seed, at the cell's own
size. The benchmark's own runs never plant one; the CPU tests plant each
at a tiny size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

from portbench import run
from portbench.reference import CHECKS
from portbench.spec import Bench


@contextlib.contextmanager
def state_unchanged():
    """The beam loop's step returns its state unchanged: each lane's beam
    keeps only its entry point."""
    run._program()
    from repro_torch.core import search_batch
    with mock.patch.object(search_batch, "_run_chunked",
                           lambda step, state, live_fn: state):
        yield


def _wrap_execute(wrap):
    run._program()
    from repro_torch.api.db import NavixDB
    execute = NavixDB.execute

    def patched(self, plan, query=None, **kw):
        return wrap(execute, self, plan, query, **kw)
    return mock.patch.object(NavixDB, "execute", patched)


@contextlib.contextmanager
def half_batch():
    """Half of each batch left out: its lanes get the other half's
    answers."""
    def half(execute, self, plan, query, **kw):
        h = len(query) // 2
        rs = execute(self, plan, query=query[:h], **kw)
        rs.ids = np.concatenate([rs.ids, rs.ids[:len(query) - h]])
        rs.dists = np.concatenate([rs.dists, rs.dists[:len(query) - h]])
        return rs
    with _wrap_execute(half):
        yield


@contextlib.contextmanager
def answer_altered():
    """One answer altered where it is produced: lane 0's nearest id
    becomes its farthest, its distance kept."""
    def altered(execute, self, plan, query, **kw):
        rs = execute(self, plan, query=query, **kw)
        rs.ids = rs.ids.copy()
        rs.ids[0, 0] = rs.ids[0, -1]
        return rs
    with _wrap_execute(altered):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.faults")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for var, rel in run.CACHES.items():
        os.environ[var] = str(run.ROOT / rel)
    bench = Bench(run.ROOT)
    for s in args.seeds.split(","):
        with FAULTS[args.fault]():
            out = run.run_cell(bench, args.workload, int(s), args.seconds,
                               False, t0=time.perf_counter(),
                               log=lambda *_: None)
        print(json.dumps({"fault": args.fault, "seed": int(s),
                          "correct": out["correct"],
                          **{c: out["checks"][c]["value"] for c in CHECKS}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
