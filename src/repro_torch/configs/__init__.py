"""Index presets and the arch registry (counterpart of ``repro.configs``).

Importing this package registers the recsys archs and meshgraphnet with
``repro_torch.config.base``; resolve them with ``get_arch("<id>")``.
"""

from repro_torch.configs import (bst, deepfm, dien, meshgraphnet,  # noqa: F401
                                 wide_deep)
from repro_torch.configs import navix_paper  # noqa: F401
