"""moe_combine_ms.train: device ms per training step of the program's span
``repro_torch.moe.combine`` in ``models.moe._moe_tokens`` (each token's
gathers of its expert outputs and their adds): its forward, its remat
recompute (the span opens again inside the backward) and the backward nodes
tied to its forward ops by sequence number (``portbench/spans.py``,
``Spans.layer_ms``)."""
from portbench import spans


def read(run):
    s = spans.of(run)
    if s is None or "moe.combine" not in s.spans:
        return None
    return s.layer_ms("moe.combine")
