"""Unified NavixDB query API (counterpart of ``repro.api``).

The paper's native-integration claim, as a Python surface: one ``NavixDB``
owns the graph store, an index catalog (CREATE_HNSW_INDEX), and query
execution (QUERY_HNSW_INDEX as a plan operator), with a fluent builder and
a program cache underneath.
"""

from repro_torch.api.builder import Q  # noqa: F401
from repro_torch.api.db import (IndexEntry, NavixDB, ResultSet,  # noqa: F401
                                StageTimings)
from repro_torch.api.plan_compile import ProgramCache, ProgramKey  # noqa: F401
