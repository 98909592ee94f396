"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base family]:
32L d_model=1536 24H (GQA kv=8) vocab=49155; MoE 40 experts top-8,
d_ff_expert=512, SwiGLU, tied embeddings."""

from repro_torch.config.base import ArchDef, LMConfig, MoEConfig, register_arch
from repro_torch.configs.lm_shapes import lm_shapes

CONFIG = LMConfig(
    arch_id="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, activation="swiglu",
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                  n_shared_experts=0, capacity_factor=1.25),
    rope_theta=10000.0, tie_embeddings=True, embedding_scale=False,
    optimizer="adamw",
)

SMOKE = LMConfig(
    arch_id="granite-moe-smoke",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8,
    d_ff=64, vocab_size=256, activation="swiglu",
    moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=32, n_shared_experts=0),
    embedding_scale=False, param_dtype="float32", compute_dtype="float32",
    remat=False, optimizer="adamw",
)

ARCH = register_arch(ArchDef(
    arch_id="granite-moe-3b-a800m", config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(long_context_ok=False),
    description="IBM Granite 3B-A800M MoE (40e top-8)",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
