"""The benchmark of ``flowstate_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by its name
(``loader.py``); the plain reference that decides ``correct`` is in
``reference/`` and imports nothing of the program.
"""
