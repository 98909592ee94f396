"""Synthetic datasets and the GNN neighbor sampler (counterpart of
``repro.data``)."""
