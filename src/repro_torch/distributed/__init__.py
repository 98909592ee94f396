"""Sharding policies and activation hints over a torch ``DeviceMesh``
(counterpart of ``repro.distributed``)."""
