"""backward_ms.train: device ms per training step of the kernels and copies
launched while the program's span ``repro_torch.backward`` (each
microbatch's ``loss.backward()``) is open, on any thread: the autograd
engine's thread does not nest under the main thread's span, so its ops are
matched by host time (``portbench/spans.py``, ``Spans.during``). The remat
recompute is in it."""
from portbench import spans


def read(run):
    s = spans.of(run)
    if s is None or "backward" not in s.spans:
        return None
    return s.device_ms(s.during("backward"))
