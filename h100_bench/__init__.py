"""The benchmark of ``ryolo_tpu_torch`` on one NVIDIA H100: ``run.py`` runs
one cell of ``BENCHMARK.json`` (see ``PERF.md``)."""
