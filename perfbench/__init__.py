"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; everything a cell
needs (its configuration, traffic mix, metric readers, kernel classes and
correctness limits) is a file of its own under this folder, found by the
name that ``BENCHMARK.json`` gives it.  See ``README.md``.
"""
