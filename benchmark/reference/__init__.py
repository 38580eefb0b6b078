"""Plain float32 PyTorch reference of the measured paths (GridNet,
CoordGridNet, HNED, VGG19 to relu4_4, the loss, Adam, the K-step recipe,
the edge-mode rollout) and the count of their work. It imports neither
JAX nor anything of the port: ``benchmark/tests/test_bench_reference.py``
checks that with ``ast``."""
