"""The benchmark of the PyTorch and CUDA port, ``hnsw_tpu_torch``.

``BENCHMARK.json`` at the root of the repository names its cells; each
configuration, traffic mix and per-layer metric is a file of its own here,
found by name (``spec.py``). ``run.py`` runs one cell once; ``reference.py``
is the plain reference that decides ``correct``. See README.md.
"""
