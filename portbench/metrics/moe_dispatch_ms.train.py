"""moe_dispatch_ms.train: device ms per training step of the program's span
``repro_torch.moe.dispatch`` in ``models.moe._moe_tokens`` (the capacity,
``dispatch`` and the gather of the tokens into the (E, C, d) expert buffer):
its forward, its remat recompute (the span opens again inside the backward)
and the backward nodes tied to its forward ops by sequence number
(``portbench/spans.py``, ``Spans.layer_ms``)."""
from portbench import spans


def read(run):
    s = spans.of(run)
    if s is None or "moe.dispatch" not in s.spans:
        return None
    return s.layer_ms("moe.dispatch")
