"""Per-layer metrics, one file each, named as in ``BENCHMARK.json``: each
defines ``read(run) -> float | None``, ``run`` being what the cell's mode
hands over after a traced run (``portbench.modes.train.TraceRun``). A
reader that finds nothing to read returns None, and the metric is left out
of the result."""
