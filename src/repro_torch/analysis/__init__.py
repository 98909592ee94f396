"""Runtime verification guards (port of the runtime side of
``repro.analysis``)::

    from repro_torch.analysis.runtime import CompileCounter, instrument_locks

The reference's static side (navilint, ``python -m repro.analysis``)
models JAX tracing and is not ported; it sweeps this package as it is.
"""
