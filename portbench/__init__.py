"""portbench: the benchmark of the PyTorch and CUDA port (``src/repro_torch``)
on one NVIDIA H100. ``run.py`` runs one cell once; ``BENCHMARK.json`` at the
checkout's root names its cells and metrics. It imports nothing of JAX or
of the JAX package (``src/repro``), and its reference nothing of the port."""
