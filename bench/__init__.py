"""The benchmark of the port ``repro_torch`` on one NVIDIA GPU.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name: ``cells/<cell>.json`` (its
configuration, entry driver, traffic and limits), ``configs/<config>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``.
"""
