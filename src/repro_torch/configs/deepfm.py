"""deepfm [arXiv:1703.04247]: n_sparse=39 embed_dim=10 mlp=400-400-400,
interaction=FM (pairwise via the sum-square identity) + linear terms."""

from repro_torch.config.base import ArchDef, RecsysConfig, register_arch
from repro_torch.configs.recsys_shapes import (RECSYS_SHAPES, field_vocabs,
                                         multi_hot_sizes, smoke_vocabs)

N_FIELDS = 39

CONFIG = RecsysConfig(
    arch_id="deepfm", model="deepfm",
    n_sparse=N_FIELDS, embed_dim=10, mlp_dims=(400, 400, 400),
    interaction="fm",
    field_vocabs=field_vocabs(N_FIELDS),
    multi_hot_sizes=multi_hot_sizes(N_FIELDS),
    item_vocab=1_000_000,
)

SMOKE = RecsysConfig(
    arch_id="deepfm-smoke", model="deepfm",
    n_sparse=5, embed_dim=6, mlp_dims=(24, 24), interaction="fm",
    field_vocabs=smoke_vocabs(5), multi_hot_sizes=multi_hot_sizes(5),
    item_vocab=500,
)

ARCH = register_arch(ArchDef(
    arch_id="deepfm", config=CONFIG, smoke_config=SMOKE, shapes=RECSYS_SHAPES,
    description="DeepFM CTR (FM + deep tower)",
    source="arXiv:1703.04247",
))
