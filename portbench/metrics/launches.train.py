"""launches.train: the kernels launched while the program's span
``repro_torch.train_step`` is open, per training step: the device's kernels
(copies and fills left out) whose host op started inside the span on any
thread. A kernel that the port launches through ctypes is linked to no host
op; it counts with the op of the event before it on its stream
(``portbench/spans.py``)."""
from portbench import spans


def read(run):
    s = spans.of(run)
    if s is None:
        return None
    return sum(not d.name.startswith(spans.COPIES) for d in s.launched_by(s.during(spans.STEP))) / s.steps
