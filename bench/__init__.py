"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints its result as the last
line of standard output. Everything that belongs to one configuration,
cell, traffic mix or metric sits in a file of its own, found by name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<mix>.json`` and ``metrics/<metric>.py``; a configuration's
topology, in ``programs/<topology>.py`` and ``reference/<topology>.py``,
which its ``"topology"`` key names (``chain`` where it is absent).
"""
