"""dien [arXiv:1809.03672]: embed_dim=18 seq_len=100 gru_dim=108
mlp=200-80, interaction=AUGRU (interest evolution over the behavior
sequence with attentional update gates)."""

from repro_torch.config.base import ArchDef, RecsysConfig, register_arch
from repro_torch.configs.recsys_shapes import (RECSYS_SHAPES, field_vocabs,
                                         multi_hot_sizes, smoke_vocabs)

N_FIELDS = 8   # user/context categorical fields beside the behavior seq

CONFIG = RecsysConfig(
    arch_id="dien", model="dien",
    n_sparse=N_FIELDS, embed_dim=18, mlp_dims=(200, 80),
    interaction="augru", seq_len=100, gru_dim=108,
    field_vocabs=field_vocabs(N_FIELDS),
    multi_hot_sizes=multi_hot_sizes(N_FIELDS),
    item_vocab=5_000_000,
)

SMOKE = RecsysConfig(
    arch_id="dien-smoke", model="dien",
    n_sparse=4, embed_dim=6, mlp_dims=(24, 12), interaction="augru",
    seq_len=12, gru_dim=16,
    field_vocabs=smoke_vocabs(4), multi_hot_sizes=multi_hot_sizes(4),
    item_vocab=500,
)

ARCH = register_arch(ArchDef(
    arch_id="dien", config=CONFIG, smoke_config=SMOKE, shapes=RECSYS_SHAPES,
    description="DIEN (GRU interest extraction + AUGRU evolution)",
    source="arXiv:1809.03672 (unverified)",
))
