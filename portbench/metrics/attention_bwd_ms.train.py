"""attention_bwd_ms.train: device ms per training step of the attention's
backward in torch ops (``kernels.flash_attention.attention_backward``, as
``kernels.ops.Attention`` calls it, in the benchmark's range
``portbench.attention_backward``)."""
from portbench.timeline import device_us


def read(run):
    if getattr(run, "mode", None) != "train":
        return None
    us = device_us(run.timeline.in_range("attention_backward"))
    return us / 1e3 / run.steps if us > 0 else None
