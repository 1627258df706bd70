"""The benchmark of ``bayesnmf_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload NAME --seed S --seconds T --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. The
harness finds everything by name: a configuration in ``configs/``, a
traffic mix in ``traffic/``, a cell's correctness limits in
``workloads/``, a metric's reader in ``metrics/``, a configuration's
plain reference in ``reference/`` and its model's work count in
``counts/``; a new cell, mix, model or metric is new files.
"""
