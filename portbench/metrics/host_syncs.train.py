"""host_syncs.train: the calls that block the host until the device is done
(``portbench/spans.py`` ``SYNCS``: stream, device and event synchronizes
and the blocking ``cudaMemcpy``) made while the program's span
``repro_torch.train_step`` is open, on any thread, per training step."""
from portbench import spans


def read(run):
    s = spans.of(run)
    if s is None:
        return None
    return sum(e.name in spans.SYNCS for e in s.during(spans.STEP)) / s.steps
