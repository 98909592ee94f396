"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``):
filtered kNN through ``NavixDB.execute``. ``python3 -m portbench.run``
runs one cell once; ``BENCHMARK.json`` at the repository's root lists the
cells, configurations and metrics."""
