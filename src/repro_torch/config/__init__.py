"""Typed configuration (counterpart of ``repro.config``)."""
