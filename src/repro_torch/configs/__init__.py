"""Index presets and the arch registry (counterpart of ``repro.configs``).

Importing this package registers the five LM archs (gemma-7b, gemma2-9b,
qwen1.5-0.5b, granite-moe-3b-a800m, kimi-k2-1t-a32b), the four recsys
archs and meshgraphnet with ``repro_torch.config.base``; resolve them with
``get_arch("<id>")``.
"""

from repro_torch.configs import (bst, deepfm, dien, gemma2_9b,  # noqa: F401
                                 gemma_7b, granite_moe, kimi_k2,
                                 meshgraphnet, qwen15_05b, wide_deep)
from repro_torch.configs import navix_paper  # noqa: F401
