"""gemma2-9b [arXiv:2408.00118]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; alternating local(4096-window)/global attention, attn logit
softcap 50, final logit softcap 30, sandwich (pre+post) RMSNorms, GeGLU.

The only assigned LM that runs long_500k: its local layers are
sub-quadratic sliding-window attention (hybrid pattern)."""

from repro_torch.config.base import ArchDef, LMConfig, register_arch
from repro_torch.configs.lm_shapes import lm_shapes

CONFIG = LMConfig(
    arch_id="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000, activation="geglu",
    attn_pattern="local_global", local_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0, post_norms=True,
    rope_theta=10000.0, tie_embeddings=True, embedding_scale=True,
)

SMOKE = LMConfig(
    arch_id="gemma2-9b-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, activation="geglu",
    attn_pattern="local_global", local_window=16,
    attn_logit_softcap=50.0, final_logit_softcap=30.0, post_norms=True,
    param_dtype="float32", compute_dtype="float32", remat=False,
    optimizer="adamw",
)

ARCH = register_arch(ArchDef(
    arch_id="gemma2-9b", config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(long_context_ok=True),
    description="Gemma-2 9B (local+global alternating, logit softcap)",
    source="arXiv:2408.00118; hf",
))
