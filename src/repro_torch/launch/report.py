"""Render the dry run's tables from its JSON records (port of
``repro.launch.report``), with the H100's terms: the compute term at its
dense bf16 peak, the memory term at its device-memory rate, the
collective term over NVLink, and each chip's peak bytes against its
memory.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import pathlib

from repro_torch.common.hardware import TARGET

MESH_NAMES = ("single_pod_16x16", "multi_pod_2x16x16", "one_chip_1x1")


def fmt_bytes(b: float) -> str:
    return f"{b/2**30:.2f}"


def load(dirname: str):
    recs = []
    for f in sorted(glob.glob(f"{dirname}/*.json")):
        recs.append(json.loads(pathlib.Path(f).read_text()))
    return recs


def render(recs, mesh_filter: str) -> str:
    rows = []
    head = ("| cell | status | tC (s) | tM (s) | tN NVLink (s) | bottleneck | "
            "useful | roofline frac | peak/chip GiB | fits "
            f"{TARGET.hbm_bytes / 2**30:.0f} GiB | peak coll op |")
    rows.append(head)
    rows.append("|" + "---|" * 11)
    for r in recs:
        if mesh_filter not in r["cell"]:
            continue
        cell = r["cell"].replace(f"/{mesh_filter}", "")
        if r["status"] == "skip":
            rows.append(f"| {cell} | SKIP (documented) |" + " |" * 9)
            continue
        if r["status"] == "fail":
            rows.append(f"| {cell} | FAIL: {r.get('op')} |" + " |" * 9)
            continue
        roof = r["roofline"]
        coll = roof.get("coll_breakdown", {})
        peak_op = max(coll, key=coll.get) if any(coll.values()) else "-"
        peak = r["memory_analysis"]["peak_size_in_bytes"]
        rows.append(
            f"| {cell} | ok | {roof['t_compute_s']:.4f} "
            f"| {roof['t_memory_s']:.4f} | {roof['t_collective_s']:.4f} "
            f"| {roof['bottleneck']} | {roof['useful_flops_fraction']:.3f} "
            f"| {roof['roofline_fraction']:.4f} | {fmt_bytes(peak)} "
            f"| {'yes' if peak <= TARGET.hbm_bytes else 'no'} | {peak_op} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args()
    recs = load(args.dir)
    for mesh in MESH_NAMES:
        mine = [r for r in recs if mesh in r["cell"]]
        if not mine:
            continue
        counts = {s: sum(r["status"] == s for r in mine)
                  for s in ("ok", "skip", "fail")}
        print(f"\n### {mesh}  (ok={counts['ok']} skip={counts['skip']} "
              f"fail={counts['fail']})\n")
        print(render(recs, mesh))


if __name__ == "__main__":
    main()
