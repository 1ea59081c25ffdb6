"""forward_ms.train: device ms per training step of the kernels and copies
launched inside the program's span ``repro_torch.forward`` (the loss's
forward of each microbatch, ``training.train_step.accumulate_grads``; the
remat recompute runs in the backward and is not in it), put down to their
host ops as ``portbench/spans.py`` does."""
from portbench import spans


def read(run):
    s = spans.of(run)
    if s is None or "forward" not in s.spans:
        return None
    return s.device_ms(s.inside("forward"))
