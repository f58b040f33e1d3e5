"""The benchmark of seigen_tpu_torch on NVIDIA H100s (see BENCHMARK.json).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once.  ``reference/`` is the plain
reference that decides ``correct``; ``counts.py`` the operation and byte
counts; ``configs/``, ``traffic/``, ``workloads/`` and ``metrics/`` hold
one file per configuration, run mix, cell and per-layer metric.
"""
