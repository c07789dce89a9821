"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; everything that belongs to
one configuration, traffic mix or per-layer metric is a file of its own,
found by its name (``configs/``, ``workloads/``, ``metrics/``), and each
kind of traffic is a driver (``drivers/``).  ``reference/`` is the plain
PyTorch model that decides ``correct``; it imports nothing of the port.
"""
