"""Checkpointing: index/graph persistence (port of ``repro.checkpoint``)."""
