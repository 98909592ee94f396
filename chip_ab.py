#!/usr/bin/env python3
"""A/B of two trees of the port on one card: the f32 and int8 sigma sweeps
and single-query searches of ``chip_smoke.py`` (B = 1024, k = 100, efs =
200, the run's queries and masks), on one 1M x 960 index.

    git archive <parent> | tar -x -C _archive/parent
    git archive $(git write-tree) | tar -x -C _archive/final
    python3 chip_ab.py [PARENT_TREE CHANGE_TREE]   # default: those two

The index is built once, with the change tree's build, and saved as numpy
arrays under ``_archive/ab_graph``; then each side runs in its own process
from its tree's ``src``, in the order parent, change, change, parent, and
prints one ``AB`` JSON line of QPS per sigma and mean single-query ms. Compare the two
sides only within one call. Needs one CUDA device.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

# the saved index, inside the checkout (gitignored)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_archive",
                   "ab_graph")
TREES = {"parent": "_archive/parent", "change": "_archive/final"}
if len(sys.argv) == 3:
    TREES = {"parent": sys.argv[1], "change": sys.argv[2]}
TREES = json.loads(os.environ.get("AB_TREES", "null")) or TREES


def build():
    sys.path.insert(0, os.path.abspath(TREES["change"]))
    sys.path.insert(0, os.path.abspath(TREES["change"] + "/src"))
    import chip_smoke as cs
    from repro_torch.core.graph import FIELDS
    cs.phase_build_kernels()
    X = cs.make_data(cs.N)[0]
    idx = cs.phase_build(X)
    os.makedirs(OUT, exist_ok=True)
    for f in FIELDS:
        np.save(f"{OUT}/{f}.npy", getattr(idx.graph, f).cpu().numpy())


def run(side):
    tree = os.path.abspath(TREES[side])
    sys.path.insert(0, tree + "/src")
    import torch
    from repro_torch.configs.navix_paper import PAPER_INDEX, SELECTIVITIES
    from repro_torch.core.graph import FIELDS, graph_from_numpy
    from repro_torch.core.navix import NavixIndex
    from repro_torch.data.synthetic import gaussian_mixture
    import repro_torch
    assert repro_torch.__file__.startswith(tree), repro_torch.__file__
    g = graph_from_numpy({f: np.load(f"{OUT}/{f}.npy") for f in FIELDS})
    idx = NavixIndex.from_graph(g, PAPER_INDEX._replace(batch_size=2048))
    # the run's queries and masks, as chip_smoke.make_data / make_masks
    _, _, centers = gaussian_mixture(16, 960, 1000, seed=0)
    rng = np.random.default_rng(1)
    base = centers[rng.integers(0, len(centers), size=1024)]
    Q = (base + 0.3 * rng.normal(size=base.shape)).astype(np.float32)
    mrng = np.random.default_rng(2)
    masks = {s: mrng.random(g.n) < s for s in SELECTIVITIES}

    def qps(fn, mask):
        fn(Q, k=100, efs=200, semimask=mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(Q, k=100, efs=200, semimask=mask)
        torch.cuda.synchronize()
        return 1024 / (time.perf_counter() - t0)

    def single_ms(fn, mask):
        out = []
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(Q[i], k=100, efs=200, semimask=mask)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.mean(out))

    res = {"side": side,
           "f32": {s: qps(idx.search_many, m) for s, m in masks.items()}}
    qidx = idx.quantize_resident()
    res["int8"] = {s: qps(qidx.search_quantized_many, m)
                   for s, m in masks.items()}
    res["single_f32"] = single_ms(idx.search, masks[0.1])
    res["single_int8"] = single_ms(qidx.search_quantized, masks[0.1])
    print("AB " + json.dumps(res), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 2:
        run(sys.argv[1])
        sys.exit(0)
    t0 = time.perf_counter()
    build()
    print(f"[ab] built and saved in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for side in ("parent", "change", "change", "parent"):
        t1 = time.perf_counter()
        subprocess.run([sys.executable, __file__, side], check=True,
                       env={**os.environ, "AB_TREES": json.dumps(TREES)})
        print(f"[ab] {side} {time.perf_counter() - t1:.1f}s", flush=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
