"""The LM-family shape set (shared by all 5 LM archs; port of
``repro.configs.lm_shapes``).

``decode_*`` / ``long_*`` drive serve-side ``decode_step`` (one new token
against a KV cache of seq_len), not train_step. ``long_500k`` requires
sub-quadratic attention: it runs only for the hybrid local+global arch
(gemma2-9b) and is recorded as a documented skip (``FULL_ATTN_SKIP``) for
the pure full-attention archs.
"""

from repro_torch.config.base import ShapeSpec

FULL_ATTN_SKIP = ("long-context decode requires sub-quadratic attention; "
                  "this arch is pure full attention (every layer would need "
                  "the complete 512k-token KV cache) -- documented skip per "
                  "assignment instructions")


def lm_shapes(long_context_ok: bool) -> tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_4k", "train",
                  {"seq_len": 4096, "global_batch": 256}),
        ShapeSpec("prefill_32k", "prefill",
                  {"seq_len": 32768, "global_batch": 32}),
        ShapeSpec("decode_32k", "decode",
                  {"seq_len": 32768, "global_batch": 128}),
        ShapeSpec("long_500k", "decode",
                  {"seq_len": 524288, "global_batch": 1},
                  skip_reason=None if long_context_ok else FULL_ATTN_SKIP),
    )
