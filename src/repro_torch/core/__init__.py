"""Index structures and search engines (counterpart of ``repro.core``)."""
