"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything a
cell needs is found by name: its configuration in ``configs/``, its
traffic mix in ``traffic/`` (read by the generator module the mix
names), its correctness limits in ``limits/``, each per-layer metric's
reader in ``metrics/`` and its family's plain reference in
``reference/``.  Nothing here imports JAX or the JAX package ``repro``.
"""
