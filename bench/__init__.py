"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

``python -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``.  Everything that belongs to one
configuration, traffic mix, kind of work or per-layer metric is a file of
its own, found by name (:mod:`bench.registry`).
"""
