"""The benchmark of ``astroz_tpu_torch`` on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: it makes the
cell's catalog from the seed, drives the program's public entries with
the cell's traffic for the window, checks what the timed requests
produced against the plain reference in ``portbench/reference/``, and
prints one JSON line. Configurations, traffic mixes and metrics are
files of their own under ``configs/``, ``traffic/`` and ``metrics/``,
found by the names in ``BENCHMARK.json``.
"""
