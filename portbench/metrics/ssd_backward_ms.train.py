"""ssd_backward_ms.train: device ms per training step of the SSD's backward
in torch ops (``kernels.ops.ssd_backward``, as ``kernels.ops.SSDScan``
calls it: the chunk decomposition recomputed in fp32 and differentiated, in
the benchmark's range ``portbench.ssd_backward``)."""
from portbench.timeline import device_us


def read(run):
    if getattr(run, "mode", None) != "train":
        return None
    us = device_us(run.timeline.in_range("ssd_backward"))
    return us / 1e3 / run.steps if us > 0 else None
