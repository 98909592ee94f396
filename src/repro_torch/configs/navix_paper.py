"""The paper's index and workload settings (port of
``repro.configs.navix_paper``)."""

from repro_torch.core.navix import NavixConfig

#: index hyperparameters exactly as the paper's evaluation (Section 5.1.5)
PAPER_INDEX = NavixConfig(m_u=32, ef_construction=200, sample_rate=0.05)

#: the paper's selectivity sweep (Figure 8)
SELECTIVITIES = (0.9, 0.75, 0.5, 0.4, 0.3, 0.2, 0.1, 0.05, 0.03, 0.01)

#: correlated-workload selectivities (Table 5)
CORR_SELECTIVITIES = (0.229, 0.15, 0.099, 0.051, 0.01)
