"""The benchmark of ``alevin_fry_tpu_torch``: ``run.py`` runs one cell of
``BENCHMARK.json``; see ``README.md``."""
