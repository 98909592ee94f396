"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape) cell, run the cell's step once on
the production mesh -- 16x16 (single pod, 256 chips) and 2x16x16 (multi
pod, 512 chips), each a ``fake`` process group in this process -- with
every tensor a ``meta`` tensor placed by the sharding rules, and record a
chip's memory, op counts and roofline
(:func:`repro_torch.launch.dryrun_lib.run_cell`). ``--mesh one`` runs a
1x1 mesh: the roofline of one card, which a step on the card can be held
against (``--batch`` sets the batch that card holds). Failures (a layout
DTensor cannot run, an op with no sharding rule) are findings: each
record names its operator.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

MESHES = {"single": ("single_pod_16x16", dict(multi_pod=False)),
          "multi": ("multi_pod_2x16x16", dict(multi_pod=True)),
          "one": ("one_chip_1x1", None)}


def _meshes(choice: str) -> list[str]:
    return ["single", "multi"] if choice == "both" else [choice]


def _line(rec: dict) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        peak = rec["memory_analysis"]["peak_size_in_bytes"]
        extra = (f" bottleneck={r['bottleneck']}"
                 f" tC={r['t_compute_s']:.4f}s tM={r['t_memory_s']:.4f}s"
                 f" tN={r['t_collective_s']:.4f}s ({r['link']})"
                 f" mem/chip={peak / 2**30:.2f}GiB")
    elif status == "fail":
        extra = f" {rec['op']}: {rec['error'][:200]}"
    return f"[{status}] {rec['cell']} ({rec.get('wall_s', 0):.0f}s){extra}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both", "one"],
                    default="both")
    ap.add_argument("--batch", type=int, default=None,
                    help="override the shape's (global) batch")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.config.base import get_arch
    from repro_torch.launch.dryrun_lib import all_cells, batch_key, run_cell
    from repro_torch.launch.mesh import fake_mesh, make_production_mesh

    if args.all:
        cells = all_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    suffix = "" if args.batch is None else f"__b{args.batch}"

    failures = 0
    for choice in _meshes(args.mesh):
        mname, kw = MESHES[choice]
        ctx = (fake_mesh((1, 1), ("data", "model")) if kw is None
               else make_production_mesh(**kw))
        with ctx as mesh:
            for aid, sname in cells:
                path = outdir / f"{aid}__{sname}__{mname}{suffix}.json"
                if path.exists() and not args.force:
                    rec = json.loads(path.read_text())
                    print(f"[cached] {rec['cell']}: {rec['status']}")
                    failures += rec["status"] == "fail"
                    continue
                t0 = time.perf_counter()
                shape = get_arch(aid).shape(sname)
                over = ({} if args.batch is None
                        else {batch_key(shape): args.batch})
                rec = run_cell(aid, sname, mesh, mname, overrides=over)
                rec["wall_s"] = round(time.perf_counter() - t0, 2)
                path.write_text(json.dumps(rec, indent=2))
                failures += rec["status"] == "fail"
                print(_line(rec), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
