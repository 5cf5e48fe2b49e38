"""The benchmark of ``repro_torch`` on one NVIDIA H100: a data-driven harness.

``python port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout runs one cell of ``BENCHMARK.json``.  The cell's
file (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``) and its traffic kind (``traffic/<kind>.py``); each
per-layer metric is read by ``metrics/<metric>.py``.  A new cell, configuration,
traffic mix or metric is a new file and a ``BENCHMARK.json`` entry.
"""
