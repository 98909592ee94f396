"""Synthetic datasets + correlation-controlled workloads (port of
``repro.data.synthetic``; paper Section 5.1).

The port's own copy of the reference generators: the same seed gives the
same arrays (numpy), so the port and the reference index, filter and query
the same data.

* ``gaussian_mixture``: clustered embeddings (cluster structure is what
  makes the directed heuristic and correlations meaningful);
* ``make_wiki_like``: the Wiki graph dataset's shape (Person / Resource /
  Chunk with PersonChunk / ResourceChunk / WikiLink, the paper's Figure
  7a), person chunks in their own region of the mixture so person queries
  correlate positively with person-chunk filters and non-person queries
  negatively;
* the plans of the paper's workloads and ``correlation_ratio``, the
  correlation metric ce = sigma_vq / sigma (paper Section 5.1.3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.distances import brute_force_topk
from repro_torch.query.operators import Filter, HopJoin, NodeScan, Plan
from repro_torch.storage.columnar import GraphStore


def gaussian_mixture(n: int, d: int, n_clusters: int, seed: int = 0,
                     cluster_std: float = 0.35,
                     centers: np.ndarray | None = None):
    rng = np.random.default_rng(seed)
    if centers is None:
        centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    labels = rng.integers(0, n_clusters, size=n)
    X = centers[labels] + cluster_std * rng.normal(size=(n, d)).astype(np.float32)
    return X.astype(np.float32), labels, centers


@dataclasses.dataclass
class WikiLike:
    store: GraphStore
    embeddings: np.ndarray          # f32[n_chunks, d]
    chunk_is_person: np.ndarray     # bool[n_chunks]
    person_centers: np.ndarray
    resource_centers: np.ndarray
    seed: int

    @property
    def n_chunks(self) -> int:
        return self.embeddings.shape[0]


def make_wiki_like(n_person: int = 600, n_resource: int = 2000,
                   chunks_per_person: int = 6, chunks_per_resource: int = 3,
                   d: int = 64, n_person_clusters: int = 12,
                   n_resource_clusters: int = 40, seed: int = 0) -> WikiLike:
    """Build the Wiki-analogue property graph (Figure 7a schema)."""
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(n_person_clusters, d)).astype(np.float32)
    rc = rng.normal(size=(n_resource_clusters, d)).astype(np.float32)

    # --- chunks ----------------------------------------------------------
    p_chunk_src, p_chunk_dst, embs, is_person = [], [], [], []
    r_chunk_src, r_chunk_dst = [], []
    person_cluster = rng.integers(0, n_person_clusters, size=n_person)
    resource_cluster = rng.integers(0, n_resource_clusters, size=n_resource)

    cid = 0
    for p in range(n_person):
        for _ in range(chunks_per_person):
            embs.append(pc[person_cluster[p]] +
                        0.35 * rng.normal(size=d).astype(np.float32))
            is_person.append(True)
            p_chunk_src.append(p)
            p_chunk_dst.append(cid)
            cid += 1
    for r in range(n_resource):
        for _ in range(chunks_per_resource):
            embs.append(rc[resource_cluster[r]] +
                        0.35 * rng.normal(size=d).astype(np.float32))
            is_person.append(False)
            r_chunk_src.append(r)
            r_chunk_dst.append(cid)
            cid += 1

    embeddings = np.stack(embs).astype(np.float32)
    is_person = np.asarray(is_person)
    n_chunks = cid

    # --- shuffle chunk ids so id-range filters are uncorrelated -----------
    perm = rng.permutation(n_chunks)
    inv = np.argsort(perm)
    embeddings = embeddings[inv]
    is_person = is_person[inv]
    p_chunk_dst = perm[np.asarray(p_chunk_dst)]
    r_chunk_dst = perm[np.asarray(r_chunk_dst)]

    store = GraphStore()
    store.add_node_table("Person", n_person, {
        "pID": np.arange(n_person),
        # birth dates as integer days; range filters control selectivity
        "birth_date": rng.integers(0, 36500, size=n_person),
    })
    store.add_node_table("Resource", n_resource, {"rID": np.arange(n_resource)})
    store.add_node_table("Chunk", n_chunks, {
        "cID": np.arange(n_chunks),
        "is_person": is_person,
    })
    store.add_rel_table("PersonChunk", "Person", "Chunk",
                        np.asarray(p_chunk_src), np.asarray(p_chunk_dst))
    store.add_rel_table("ResourceChunk", "Resource", "Chunk",
                        np.asarray(r_chunk_src), np.asarray(r_chunk_dst))
    # WikiLink: each person links to a few resources
    wl_src = np.repeat(np.arange(n_person), 4)
    wl_dst = rng.integers(0, n_resource, size=n_person * 4)
    store.add_rel_table("WikiLink", "Person", "Resource", wl_src, wl_dst)

    return WikiLike(store=store, embeddings=embeddings,
                    chunk_is_person=is_person, person_centers=pc,
                    resource_centers=rc, seed=seed)


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Workload:
    name: str
    queries: np.ndarray            # f32[n_q, d]
    plan: Plan                     # the selection subquery Q_S
    target_sigma: float


def uncorrelated_plan(sigma: float, n_chunks: int) -> Plan:
    """MATCH (c:Chunk) WHERE c.cID < MAX_CHUNK_ID * sigma (paper 5.1.3)."""
    return Filter(NodeScan("Chunk"), "cID", "<", value=int(n_chunks * sigma))


def person_chunk_plan(store: GraphStore, sigma_of_person: float,
                      date_lo: int = 0) -> Plan:
    """MATCH (p:Person)-[:PersonChunk]->(c:Chunk)
    WHERE p.birth_date in [lo, hi)  (paper's correlated Q_S)."""
    hi = date_lo + int(36500 * sigma_of_person)
    return HopJoin(Filter(NodeScan("Person"), "birth_date", "range",
                          lo=date_lo, hi=hi), "PersonChunk", "fwd")


def two_hop_plan(store: GraphStore, sigma_of_person: float) -> Plan:
    """(p:Person)-[:WikiLink]->(r:Resource)-[:ResourceChunk]->(c:Chunk)
    -- the graph-RAG 2-hop workload (paper Section 5.7.1)."""
    hi = int(36500 * sigma_of_person)
    persons = Filter(NodeScan("Person"), "birth_date", "range", lo=0, hi=hi)
    resources = HopJoin(persons, "WikiLink", "fwd")
    return HopJoin(resources, "ResourceChunk", "fwd")


def make_queries(data: WikiLike, n_q: int, mode: str, seed: int = 1) -> np.ndarray:
    """Query vectors, generated the way the paper generates them
    (Section 5.1.3): 'person' queries are questions ABOUT persons, i.e.
    they live next to actual person chunks (positive correlation with
    person-chunk filters, ce ~ 3); 'nonperson' queries live next to
    resource chunks (negative, ce ~ 0.03); 'uncorrelated' samples the
    global mixture."""
    rng = np.random.default_rng(seed)
    d = data.embeddings.shape[1]
    if mode == "uncorrelated":
        ids = rng.integers(0, data.n_chunks, size=n_q)
        base = data.embeddings[ids]
    elif mode == "person":
        pids = np.flatnonzero(data.chunk_is_person)
        base = data.embeddings[rng.choice(pids, size=n_q)]
    elif mode == "nonperson":
        rids = np.flatnonzero(~data.chunk_is_person)
        base = data.embeddings[rng.choice(rids, size=n_q)]
    else:
        raise ValueError(mode)
    noise = 0.15 if mode != "uncorrelated" else 0.25
    return (base + noise * rng.normal(size=(n_q, d))).astype(np.float32)


def correlation_ratio(X, queries: np.ndarray, mask: np.ndarray,
                      k: int = 100, metric: str = "l2",
                      device: str | torch.device | None = None) -> float:
    """ce = sigma_vq / sigma (paper Section 5.1.3): the fraction of v_Q's
    global kNNs that fall in S, normalized by |S|/|V|.

    The kNNs come from ``repro_torch.core.distances.brute_force_topk`` on
    ``device`` (CUDA unless the caller passes ``device="cpu"``). ``X`` is
    f32[n, d], numpy or a tensor (a tensor already on ``device`` is not
    copied).
    """
    sigma = float(mask.mean())
    if sigma == 0.0:
        return float("nan")
    dev = resolve_device(device)
    _, ids = brute_force_topk(
        torch.as_tensor(queries, dtype=torch.float32, device=dev),
        torch.as_tensor(X, dtype=torch.float32, device=dev), k, metric)
    ids = ids.cpu().numpy()
    in_s = mask[np.maximum(ids, 0)] & (ids >= 0)
    sigma_vq = in_s.mean(axis=1)
    return float(np.mean(sigma_vq) / sigma)
