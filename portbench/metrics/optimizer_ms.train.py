"""optimizer_ms.train: device ms per training step of the kernels launched
inside the optimizer update (``training.train_step.opt_update``, in the
benchmark's range ``portbench.opt_update``)."""
from portbench.timeline import device_us


def read(run):
    if getattr(run, "mode", None) != "train":
        return None
    us = device_us(run.timeline.in_range("opt_update"))
    return us / 1e3 / run.steps if us > 0 else None
