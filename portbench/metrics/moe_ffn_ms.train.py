"""moe_ffn_ms.train: device ms per training step of the MoE FFN
(``models.transformer.moe_ffn``, in the benchmark's range
``portbench.moe_ffn``): its forward, its remat recompute (the range opens
again inside the backward) and its backward, the kernels of the backward
nodes tied to the range's forward ops by the profiler's sequence numbers
(``portbench.timeline.Timeline.backward_of``)."""
from portbench.timeline import device_us


def read(run):
    if getattr(run, "mode", None) != "train":
        return None
    us = device_us(run.timeline.in_range("moe_ffn")) + device_us(run.timeline.backward_of("moe_ffn"))
    return us / 1e3 / run.steps if us > 0 else None
