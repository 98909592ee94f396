"""Model code (counterpart of ``repro.models``): the recsys parameter tree
and its retrieval step."""
