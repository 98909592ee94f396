"""bst [arXiv:1905.06874]: Behavior Sequence Transformer (Alibaba):
embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256,
interaction=transformer over [behavior sequence; target item]."""

from repro_torch.config.base import ArchDef, RecsysConfig, register_arch
from repro_torch.configs.recsys_shapes import (RECSYS_SHAPES, field_vocabs,
                                         multi_hot_sizes, smoke_vocabs)

N_FIELDS = 8

CONFIG = RecsysConfig(
    arch_id="bst", model="bst",
    n_sparse=N_FIELDS, embed_dim=32, mlp_dims=(1024, 512, 256),
    interaction="transformer-seq", seq_len=20, n_blocks=1, n_heads=8,
    field_vocabs=field_vocabs(N_FIELDS),
    multi_hot_sizes=multi_hot_sizes(N_FIELDS),
    item_vocab=5_000_000,
)

SMOKE = RecsysConfig(
    arch_id="bst-smoke", model="bst",
    n_sparse=4, embed_dim=16, mlp_dims=(32, 16),
    interaction="transformer-seq", seq_len=6, n_blocks=1, n_heads=4,
    field_vocabs=smoke_vocabs(4), multi_hot_sizes=multi_hot_sizes(4),
    item_vocab=500,
)

ARCH = register_arch(ArchDef(
    arch_id="bst", config=CONFIG, smoke_config=SMOKE, shapes=RECSYS_SHAPES,
    description="Behavior Sequence Transformer (1 block, 8 heads)",
    source="arXiv:1905.06874",
))
