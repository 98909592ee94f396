"""Host-side neighbor sampling for minibatch GNN training, GraphSAGE-style
(port of ``repro.data.graph_sampler``).

Uniform fanout sampling over a CSR graph, producing fixed-size padded
blocks (seeds first, then the hop-1 and hop-2 frontiers) whose layout is
``repro_torch.models.api.input_specs``'s for the kind "graph_minibatch".
Edges are (src, dst) pairs in *block-local* indices with -1 padding; the
GNN masks the padding. Everything here is host numpy over the port's own
``storage.columnar.CSR``; the numpy calls are the reference's, in its
order, so the same seed gives the same graph and the same blocks bit for
bit (a vectorised sampler would draw another random stream).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.storage.columnar import CSR, csr_from_edges


def random_power_law_graph(n: int, avg_degree: int, d_feat: int,
                           seed: int = 0, alpha: float = 1.5):
    """Synthetic power-law graph (degree skew like social/product graphs):
    ``(csr, feats f32[n, d_feat])``; destinations drawn with weight
    rank^-(alpha / 2), sources uniform."""
    rng = np.random.default_rng(seed)
    m = n * avg_degree
    # preferential-attachment-ish target distribution
    w = (1.0 / np.arange(1, n + 1) ** (alpha / 2))
    w /= w.sum()
    src = rng.integers(0, n, size=m)
    dst = rng.choice(n, size=m, p=w)
    csr = csr_from_edges(src.astype(np.int64), dst.astype(np.int64), n)
    feats = rng.normal(size=(n, d_feat)).astype(np.float32)
    return csr, feats


def random_mesh_graph(n: int, d_feat: int, seed: int = 0):
    """Bounded-degree mesh-like graph (a grid with diagonals, both
    directions), MeshGraphNet's native regime; n is cut to a square."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    n = side * side
    idx = np.arange(n).reshape(side, side)
    src, dst = [], []
    for sh in ((0, 1), (1, 0), (1, 1)):
        a = idx[: side - sh[0] or None, : side - sh[1] or None].ravel()
        b = idx[sh[0]:, sh[1]:].ravel()
        src += [a, b]
        dst += [b, a]
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    csr = csr_from_edges(src, dst, n)
    feats = rng.normal(size=(n, d_feat)).astype(np.float32)
    return csr, feats


@dataclasses.dataclass
class NeighborSampler:
    csr: CSR
    fanouts: tuple[int, ...] = (15, 10)
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def block_sizes(self, n_seeds: int) -> tuple[int, int]:
        """(node rows, edge rows) of a block of ``n_seeds`` seeds."""
        n = n_seeds
        nodes = n_seeds
        edges = 0
        for f in self.fanouts:
            e = n * f
            edges += e
            nodes += e
            n = e
        return nodes, edges

    def sample_block(self, seeds: np.ndarray) -> dict[str, np.ndarray]:
        """Padded arrays: node_ids int64[n_pad] (-1 pad), edge_src /
        edge_dst int64[e_pad] (block-local, -1 pad), and the counts of
        real nodes and edges. Seeds occupy positions [0, len(seeds))."""
        seeds = np.asarray(seeds, dtype=np.int64)
        n_pad, e_pad = self.block_sizes(len(seeds))
        node_ids = np.full(n_pad, -1, np.int64)
        edge_src = np.full(e_pad, -1, np.int64)
        edge_dst = np.full(e_pad, -1, np.int64)
        node_ids[: len(seeds)] = seeds

        frontier = np.arange(len(seeds))           # block-local positions
        write_n = len(seeds)
        write_e = 0
        for f in self.fanouts:
            next_frontier = []
            for pos in frontier:
                u = node_ids[pos]
                if u < 0:
                    continue
                nbrs = self.csr.neighbors(int(u))
                if len(nbrs) == 0:
                    continue
                take = self._rng.choice(nbrs, size=min(f, len(nbrs)),
                                        replace=len(nbrs) < f)
                for v in take:
                    node_ids[write_n] = v
                    # message flows sampled-neighbor -> center
                    edge_src[write_e] = write_n
                    edge_dst[write_e] = pos
                    next_frontier.append(write_n)
                    write_n += 1
                    write_e += 1
            frontier = np.asarray(next_frontier, dtype=np.int64)
        return {"node_ids": node_ids, "edge_src": edge_src,
                "edge_dst": edge_dst, "n_real_nodes": write_n,
                "n_real_edges": write_e}

    def block_batch(self, seeds: np.ndarray, feats: np.ndarray,
                    targets: np.ndarray, d_edge: int = 4) -> dict:
        """A model-ready batch of numpy arrays: the block's gathered node
        features and targets (zeros on padding), int32 edges, zero edge
        features of width ``d_edge``, and a node mask that holds the loss
        to the seeds."""
        blk = self.sample_block(seeds)
        ids = blk["node_ids"]
        ok = ids >= 0
        nf = np.zeros((len(ids), feats.shape[1]), np.float32)
        nf[ok] = feats[ids[ok]]
        tg = np.zeros((len(ids), targets.shape[1]), np.float32)
        tg[ok] = targets[ids[ok]]
        ef = np.zeros((len(blk["edge_src"]), d_edge), np.float32)
        mask = np.zeros(len(ids), bool)
        mask[: len(seeds)] = True                  # loss on seeds only
        return {"node_feats": nf,
                "edge_src": blk["edge_src"].astype(np.int32),
                "edge_dst": blk["edge_dst"].astype(np.int32),
                "edge_feats": ef, "node_targets": tg, "node_mask": mask}
