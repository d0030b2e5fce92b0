"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration
in ``configs/<config>.json`` with its plain reference in
``reference/<config>.py``, its traffic mix in ``traffic/<mix>.json``, its
limits in ``cells/<cell>.json``, each metric's reader in
``metrics/<metric>.py`` and each layer's operation count in
``costs/<layer>.py``. Nothing here imports JAX or the JAX package.
"""
