"""gemma-7b [arXiv:2403.08295]: 28L d_model=3072 16H (GQA kv=16, i.e. MHA)
d_ff=24576 vocab=256000, GeGLU, head_dim=256, RoPE, tied embeddings with
sqrt(d) scaling."""

from repro_torch.config.base import ArchDef, LMConfig, register_arch
from repro_torch.configs.lm_shapes import lm_shapes

CONFIG = LMConfig(
    arch_id="gemma-7b",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000, activation="geglu",
    rope_theta=10000.0, tie_embeddings=True, embedding_scale=True,
)

SMOKE = LMConfig(
    arch_id="gemma-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab_size=512, activation="geglu",
    param_dtype="float32", compute_dtype="float32", remat=False,
    optimizer="adamw",
)

ARCH = register_arch(ArchDef(
    arch_id="gemma-7b", config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(long_context_ok=False),
    description="Gemma 7B dense decoder (GeGLU, MHA, 256k vocab)",
    source="arXiv:2403.08295; hf",
))
