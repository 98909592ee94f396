"""Synthetic datasets (port of ``repro.data.synthetic``, the numpy part).

``gaussian_mixture`` is a copy of the reference's generator: the same seed
gives the same arrays, so the port and the reference index the same data.
"""

from __future__ import annotations

import numpy as np


def gaussian_mixture(n: int, d: int, n_clusters: int, seed: int = 0,
                     cluster_std: float = 0.35,
                     centers: np.ndarray | None = None):
    rng = np.random.default_rng(seed)
    if centers is None:
        centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    labels = rng.integers(0, n_clusters, size=n)
    X = centers[labels] + cluster_std * rng.normal(size=(n, d)).astype(np.float32)
    return X.astype(np.float32), labels, centers
