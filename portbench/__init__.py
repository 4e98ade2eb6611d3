"""The benchmark of the PyTorch and CUDA port of Sparseloop (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Configurations, traffic mixes and per-layer metrics are files
of their own under ``configs/``, ``traffic/`` and ``metrics/``, found by
the names ``BENCHMARK.json`` gives; ``reference/`` is the frozen scalar
model that decides ``correct``.
"""
