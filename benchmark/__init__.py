"""The benchmark of video_layout_generation_tpu_torch on one NVIDIA H100.

``run.py`` runs one cell once. Everything that belongs to one model
configuration, one traffic mix or one per-layer metric sits in a file of
its own (``configs/``, ``traffic/``, ``limits/``, ``metrics/``), found by
the name that ``BENCHMARK.json`` gives it. ``reference/`` is the plain
float32 PyTorch that decides ``correct`` and counts the work; it imports
nothing of the port.
"""
