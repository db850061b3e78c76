"""The benchmark harness of the PyTorch and CUDA port: cells found by name
in ``BENCHMARK.json``, their configurations, traffic mixes, limits and
per-layer metric readers found as files by name."""
