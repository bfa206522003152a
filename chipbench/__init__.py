"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one GPU.

``python chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell needs is found by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (which names its
driver, ``drivers/<driver>.py``), ``metrics/<metric>.py`` for each
per-layer metric, and ``reference/<kind>.py`` for the plain reference.
"""
