"""meshgraphnet [arXiv:2010.03409]: encode-process-decode GNN, 15 processor
layers, d_hidden=128, sum aggregation, 2-layer MLPs (port of
``repro.configs.meshgraphnet``).

The shape set spans three GNN regimes: full-batch small (Cora-like),
sampled minibatch on a large power-law graph (Reddit-like, fanout 15-10),
full-batch large (ogbn-products scale), and batched small graphs
(molecules)."""

from repro_torch.config.base import ArchDef, GNNConfig, ShapeSpec, register_arch

CONFIG = GNNConfig(
    arch_id="meshgraphnet",
    n_layers=15, d_hidden=128, aggregator="sum", mlp_layers=2,
    in_node_dim=16, in_edge_dim=4, out_dim=3,
)

SMOKE = GNNConfig(
    arch_id="meshgraphnet-smoke",
    n_layers=3, d_hidden=32, aggregator="sum", mlp_layers=2,
    in_node_dim=8, in_edge_dim=4, out_dim=3,
    compute_dtype="float32", remat=False,
)

SHAPES = (
    ShapeSpec("full_graph_sm", "graph_full",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeSpec("minibatch_lg", "graph_minibatch",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout1": 15, "fanout2": 10, "d_feat": 602}),
    ShapeSpec("ogb_products", "graph_full",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeSpec("molecule", "graph_batched",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16}),
)

ARCH = register_arch(ArchDef(
    arch_id="meshgraphnet", config=CONFIG, smoke_config=SMOKE, shapes=SHAPES,
    description="MeshGraphNet encode-process-decode (segment-sum MP)",
    source="arXiv:2010.03409",
))
