"""The benchmark of the PyTorch and CUDA port (``mllm_sparse_retrieval_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line. Everything a cell needs is found by name:
its configuration in ``configs/``, its traffic mix in ``traffic/`` (whose
``kind`` names the generator and runner in ``kinds/``), its comparison
limits in ``limits/`` and each per-layer metric's reader in ``metrics/``.
The plain reference that decides ``correct`` lives in ``reference/`` and
imports nothing of the port. See README.md.
"""
