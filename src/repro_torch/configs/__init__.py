"""Index and workload presets (counterpart of ``repro.configs``)."""
