"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: 24L d_model=1024 16H (kv=16)
d_ff=2816 vocab=151936, SwiGLU, QKV bias, tied embeddings."""

from repro_torch.config.base import ArchDef, LMConfig, register_arch
from repro_torch.configs.lm_shapes import lm_shapes

CONFIG = LMConfig(
    arch_id="qwen1.5-0.5b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=2816, vocab_size=151936, activation="swiglu", qkv_bias=True,
    rope_theta=1_000_000.0, tie_embeddings=True, embedding_scale=False,
)

SMOKE = LMConfig(
    arch_id="qwen1.5-0.5b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=176, vocab_size=512, activation="swiglu", qkv_bias=True,
    embedding_scale=False, param_dtype="float32", compute_dtype="float32",
    remat=False, optimizer="adamw",
)

ARCH = register_arch(ArchDef(
    arch_id="qwen1.5-0.5b", config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(long_context_ok=False),
    description="Qwen1.5 0.5B dense decoder (QKV bias)",
    source="hf:Qwen/Qwen1.5-0.5B",
))
