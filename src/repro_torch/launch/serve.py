"""Serving launcher (port of ``repro.launch.serve``): stand up the
vector-search engine on a synthetic dataset and run a request workload
against it.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 8000 --requests 100
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 1500

The index is built and served on ``--device`` (default: the CUDA card; on
a host without one pass ``--device cpu``).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--d", type=int, default=48)
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--heuristic", default="adaptive_local")
    ap.add_argument("--device", default="cuda",
                    help="device the index is built and served on")
    args = ap.parse_args(argv)

    from repro_torch.core.navix import NavixConfig, NavixIndex
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.query.operators import Filter, NodeScan
    from repro_torch.serving.engine import SearchEngine
    from repro_torch.storage.columnar import GraphStore

    X, _, centers = gaussian_mixture(args.n, args.d, 16, seed=0)
    idx, stats = NavixIndex.create(X, NavixConfig(m_u=8, ef_construction=64),
                                   device=args.device)
    print(f"index: n={args.n} build={stats.seconds:.1f}s on {idx.device}")

    store = GraphStore()
    store.add_node_table("Chunk", args.n, {"cID": np.arange(args.n)})
    engine = SearchEngine(index=idx, store=store,
                          heuristic=args.heuristic, efs=4 * args.k)

    rng = np.random.default_rng(1)
    for i in range(args.requests):
        q = (centers[rng.integers(0, 16)] +
             0.3 * rng.normal(size=args.d)).astype(np.float32)
        sigma = rng.choice([1.0, 0.5, 0.2, 0.05])
        plan = (None if sigma == 1.0 else
                Filter(NodeScan("Chunk"), "cID", "<",
                       value=int(args.n * sigma)))
        engine.submit(q, plan=plan, k=args.k)
    responses = engine.drain()
    print(f"served {len(responses)} requests")
    print("latency:", engine.latency_summary())


if __name__ == "__main__":
    main()
