"""wide-deep [arXiv:1606.07792]: n_sparse=40 embed_dim=32 mlp=1024-512-256,
interaction=concat, plus the linear "wide" path over sparse features."""

from repro_torch.config.base import ArchDef, RecsysConfig, register_arch
from repro_torch.configs.recsys_shapes import (RECSYS_SHAPES, field_vocabs,
                                         multi_hot_sizes, smoke_vocabs)

N_FIELDS = 40

CONFIG = RecsysConfig(
    arch_id="wide-deep", model="wide_deep",
    n_sparse=N_FIELDS, embed_dim=32, mlp_dims=(1024, 512, 256),
    interaction="concat",
    field_vocabs=field_vocabs(N_FIELDS),
    multi_hot_sizes=multi_hot_sizes(N_FIELDS),
    item_vocab=1_000_000,
)

SMOKE = RecsysConfig(
    arch_id="wide-deep-smoke", model="wide_deep",
    n_sparse=6, embed_dim=8, mlp_dims=(32, 16), interaction="concat",
    field_vocabs=smoke_vocabs(6), multi_hot_sizes=multi_hot_sizes(6),
    item_vocab=500,
)

ARCH = register_arch(ArchDef(
    arch_id="wide-deep", config=CONFIG, smoke_config=SMOKE,
    shapes=RECSYS_SHAPES,
    description="Wide & Deep CTR (concat interaction + wide linear path)",
    source="arXiv:1606.07792",
))
