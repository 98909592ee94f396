"""Synthetic datasets (counterpart of ``repro.data``)."""
