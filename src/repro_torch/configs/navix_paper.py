"""The paper's index and workload settings (port of
``repro.configs.navix_paper``)."""

from repro_torch.core.navix import NavixConfig

#: index hyperparameters exactly as the paper's evaluation (Section 5.1.5)
PAPER_INDEX = NavixConfig(m_u=32, ef_construction=200, sample_rate=0.05)

#: benchmark-scale index (same structure, laptop-sized)
BENCH_INDEX = NavixConfig(m_u=16, ef_construction=100, sample_rate=0.05)

#: dataset analogues of the paper's Table 2: (name, n_vectors, dim, metric)
BENCH_DATASETS = (
    ("gist-like", 20_000, 96, "l2"),
    ("tiny-like", 40_000, 48, "l2"),
    ("arxiv-like", 25_000, 64, "cos"),
    ("wiki-like", 30_000, 64, "cos"),
)

#: the paper's selectivity sweep (Figure 8)
SELECTIVITIES = (0.9, 0.75, 0.5, 0.4, 0.3, 0.2, 0.1, 0.05, 0.03, 0.01)

#: correlated-workload selectivities (Table 5)
CORR_SELECTIVITIES = (0.229, 0.15, 0.099, 0.051, 0.01)
