"""The benchmark's inputs, made from ``--seed`` on the host with numpy.

Copies of the generators the port's smoke run uses (``gaussian_mixture``
of ``repro_torch.data.synthetic``, and ``chip_smoke.py``'s ``make_data``,
``make_wiki`` and the Wiki query modes of ``make_queries``), rewritten
without their checks and driven by a configuration file's numbers. Every
array comes from a stream of its own, ``default_rng((stream, ..., seed))``,
so the same seed gives the same rows, schema and queries whatever order
they are made in, and a query block does not depend on how many blocks a
run makes before it. Nothing here imports the program or the reference.
"""

from __future__ import annotations

import numpy as np

ROWS, SCHEMA, QUERIES = 0, 1, 2     # the seed's streams
_MODES = {"uncorrelated": 0, "person": 1, "nonperson": 2}


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of ``seed`` (any whole number)."""
    return np.random.default_rng([*stream, seed % 2**64])


def gaussian_mixture(g: np.random.Generator, n: int, d: int, clusters: int,
                     std: float):
    """(rows f32[n, d], labels int[n], centers f32[clusters, d]): rows
    are their cluster's center plus ``std`` Gaussian noise."""
    centers = g.standard_normal((clusters, d), dtype=np.float32)
    labels = g.integers(0, clusters, size=n)
    X = g.standard_normal((n, d), dtype=np.float32)
    X *= np.float32(std)
    X += centers[labels]
    return X, labels, centers


def make_rows(cfg: dict, seed: int):
    """The configuration's rows, their cluster labels and the centers."""
    return gaussian_mixture(rng(seed, ROWS), cfg["n"], cfg["dim"],
                            cfg["clusters"], cfg["cluster_std"])


def make_schema(cfg: dict, labels: np.ndarray, seed: int) -> dict:
    """The generator's arrays of the configuration's schema.

    ``rows``: ``cid``, a permutation of the row ids, so that an id range
    selects rows uncorrelated with the vectors. ``wiki`` (the paper's
    Figure 7a): rows of the first ``person_clusters`` clusters are person
    chunks, dealt ``chunks_per_person`` to a person in a seeded order, the
    others resource chunks, ``chunks_per_resource`` to a resource; each
    person has a ``birth`` day in ``[0, birth_days)`` and
    ``links_per_person`` WikiLinks to random resources
    (``wl_src`` -> ``wl_dst``); ``person_of`` / ``resource_of`` give each
    row's owner or -1."""
    g = rng(seed, SCHEMA)
    n = len(labels)
    a = {"cid": g.permutation(n)}
    if cfg["schema"] == "rows":
        return a
    if cfg["schema"] != "wiki":
        raise ValueError(f"unknown schema {cfg['schema']!r}")
    is_person = labels < cfg["person_clusters"]
    p_rows = g.permutation(np.flatnonzero(is_person))
    r_rows = g.permutation(np.flatnonzero(~is_person))
    p_owner = np.arange(len(p_rows)) // cfg["chunks_per_person"]
    r_owner = np.arange(len(r_rows)) // cfg["chunks_per_resource"]
    n_person, n_resource = int(p_owner[-1]) + 1, int(r_owner[-1]) + 1
    links = cfg["links_per_person"]
    a.update(is_person=is_person, n_person=n_person, n_resource=n_resource,
             birth=g.integers(0, cfg["birth_days"], size=n_person),
             person_of=np.full(n, -1), resource_of=np.full(n, -1),
             p_rows=p_rows, p_owner=p_owner, r_rows=r_rows, r_owner=r_owner,
             wl_src=np.repeat(np.arange(n_person), links),
             wl_dst=g.integers(0, n_resource, size=n_person * links))
    a["person_of"][p_rows] = p_owner
    a["resource_of"][r_rows] = r_owner
    return a


def make_queries(cfg: dict, mode: str, b: int, X: np.ndarray,
                 centers: np.ndarray, schema: dict, seed: int,
                 plan: int, block: int) -> np.ndarray:
    """Query block ``block`` of plan ``plan``: f32[b, d].

    ``uncorrelated``: a random cluster's center plus ``query_noise``
    noise (``make_data``'s queries). ``person`` / ``nonperson``: a random
    person or resource chunk plus ``near_noise`` noise (``make_queries``'s
    modes), so that person-chunk selections correlate with them
    positively or negatively."""
    g = rng(seed, QUERIES, _MODES[mode], plan, block)
    d = X.shape[1]
    if mode == "uncorrelated":
        base = centers[g.integers(0, len(centers), size=b)]
        noise = cfg["query_noise"]
    else:
        pool = np.flatnonzero(schema["is_person"] == (mode == "person"))
        base = X[g.choice(pool, size=b)]
        noise = cfg["near_noise"]
    return (base + np.float32(noise)
            * g.standard_normal((b, d), dtype=np.float32)).astype(np.float32)
