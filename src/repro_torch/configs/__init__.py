"""Index presets and the arch registry (counterpart of ``repro.configs``).

Importing this package registers the recsys archs with
``repro_torch.config.base``; resolve them with ``get_arch("<id>")``.
"""

from repro_torch.configs import bst, deepfm, dien, wide_deep  # noqa: F401
from repro_torch.configs import navix_paper  # noqa: F401
