"""The benchmark of flake_tpu_torch's device pipeline on one NVIDIA H100.

    python3 -m flakebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``cells/<cell>.json``) names a configuration (``configs/``) and a
traffic mix (``traffic/``); the metrics are the readers in ``metrics/``.
Each is found by its name, so a new cell, mix or metric is a new file.
"""
