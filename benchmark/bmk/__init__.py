"""The harness of the port's benchmark (``python benchmark/run.py``).

It reads ``BENCHMARK.json`` at the checkout's root and, by name, a
configuration (``benchmark/configs/<name>.json``), a traffic mix
(``benchmark/mixes/<name>.json``) and one reader per per-layer metric
(``benchmark/metrics/<name>.py``).  It imports the program
(``busca_tpu_torch``) only as the system under test, and never ``jax`` or
``busca_tpu``.
"""
