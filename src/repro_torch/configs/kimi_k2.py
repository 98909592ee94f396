"""kimi-k2-1t-a32b [arXiv:2501.kimi2; paper-table, unverified]: 61L
d_model=7168 64H (GQA kv=8, head_dim=128) vocab=163840; MoE with 384
experts, top-8 routing, d_ff_expert=2048, +1 shared expert (K2 design).

~1T total / ~32B active parameters. Uses Adafactor: even fully sharded
over 512 chips, Adam's 2x fp32 state for 1T params (8TB) would exceed
16GB/chip HBM together with bf16 params + grads."""

from repro_torch.config.base import ArchDef, LMConfig, MoEConfig, register_arch
from repro_torch.configs.lm_shapes import lm_shapes

CONFIG = LMConfig(
    arch_id="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840, activation="swiglu",
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, capacity_factor=1.25),
    rope_theta=50000.0, tie_embeddings=False, embedding_scale=False,
    optimizer="adafactor",
)

SMOKE = LMConfig(
    arch_id="kimi-k2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512, activation="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared_experts=1),
    tie_embeddings=False, embedding_scale=False,
    param_dtype="float32", compute_dtype="float32", remat=False,
    optimizer="adamw",
)

ARCH = register_arch(ArchDef(
    arch_id="kimi-k2-1t-a32b", config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(long_context_ok=False),
    description="Kimi K2 trillion-param MoE (384e top-8 + shared)",
    source="arXiv:2501.kimi2 (paper-table; unverified)",
))
