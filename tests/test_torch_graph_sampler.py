"""The port's graph sampler against the JAX package's.

``random_power_law_graph``, ``random_mesh_graph``, ``NeighborSampler``'s
``block_sizes``, ``sample_block`` and ``block_batch`` give the reference's
arrays bit for bit from the same seeds (host numpy on both sides, the same
calls in the same order); consecutive blocks from one sampler too, so the
random stream advances alike. The reference's own block test is mirrored.
"""

import numpy as np
import pytest

from repro.data import graph_sampler as jgs
from repro_torch.data import graph_sampler as gs


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def graphs():
    return {"power_law": (gs.random_power_law_graph(600, 8, 12, seed=3),
                          jgs.random_power_law_graph(600, 8, 12, seed=3)),
            "mesh": (gs.random_mesh_graph(420, 6, seed=1),
                     jgs.random_mesh_graph(420, 6, seed=1))}


@pytest.mark.parametrize("kind", ["power_law", "mesh"])
def test_generators_equal_reference(graphs, kind):
    (csr, feats), (jcsr, jfeats) = graphs[kind]
    _same({"offsets": csr.offsets, "targets": csr.targets, "feats": feats},
          {"offsets": jcsr.offsets, "targets": jcsr.targets,
           "feats": jfeats})


def test_power_law_alpha_reaches_the_law():
    a = gs.random_power_law_graph(300, 4, 2, seed=0, alpha=2.0)
    b = jgs.random_power_law_graph(300, 4, 2, seed=0, alpha=2.0)
    np.testing.assert_array_equal(a[0].targets, b[0].targets)


@pytest.mark.parametrize("kind", ["power_law", "mesh"])
@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10), (4,)])
def test_blocks_equal_reference(graphs, kind, fanouts):
    (csr, feats), (jcsr, jfeats) = graphs[kind]
    s = gs.NeighborSampler(csr, fanouts=fanouts, seed=7)
    js = jgs.NeighborSampler(jcsr, fanouts=fanouts, seed=7)
    assert s.block_sizes(16) == js.block_sizes(16)
    rng = np.random.default_rng(0)
    targets = rng.normal(size=(feats.shape[0], 3)).astype(np.float32)
    for _ in range(3):                  # the stream advances alike
        seeds = rng.integers(0, feats.shape[0], size=16)
        _same(s.sample_block(seeds), js.sample_block(seeds))
        _same(s.block_batch(seeds, feats, targets, d_edge=4),
              js.block_batch(seeds, jfeats, targets, d_edge=4))


def test_seeds_with_no_neighbors_leave_padding():
    csr, _ = gs.random_power_law_graph(50, 1, 2, seed=0)
    lonely = np.flatnonzero(csr.degrees() == 0)
    assert len(lonely)
    s = gs.NeighborSampler(csr, fanouts=(3,), seed=0)
    js = jgs.NeighborSampler(jgs.random_power_law_graph(50, 1, 2, seed=0)[0],
                             fanouts=(3,), seed=0)
    seeds = np.concatenate([lonely[:2], [int(np.argmax(csr.degrees()))]])
    blk = s.sample_block(seeds)
    _same(blk, js.sample_block(seeds))
    assert blk["n_real_edges"] == 3 and (blk["edge_src"][3:] == -1).all()


def test_neighbor_sampler_block():
    csr, feats = gs.random_power_law_graph(500, avg_degree=8, d_feat=12,
                                           seed=0)
    s = gs.NeighborSampler(csr, fanouts=(5, 3), seed=0)
    block = s.sample_block(np.arange(16))
    n_pad = 16 * (1 + 5 + 15)
    assert block["node_ids"].shape[0] == n_pad
    assert (block["edge_dst"] < n_pad).all()
    # every real edge's endpoints map to real block nodes
    ok = block["edge_src"] >= 0
    assert (block["node_ids"][block["edge_src"][ok]] >= 0).all()
    # seeds come first
    np.testing.assert_array_equal(block["node_ids"][:16], np.arange(16))
