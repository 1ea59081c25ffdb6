"""moe_experts_ms.train: device ms per training step of the program's span
``repro_torch.moe.experts`` in ``models.moe._moe_tokens`` (the experts'
three batched matmuls, the GLU and the gates): its forward, its remat
recompute (the span opens again inside the backward) and the backward nodes
tied to its forward ops by sequence number (``portbench/spans.py``,
``Spans.layer_ms``)."""
from portbench import spans


def read(run):
    s = spans.of(run)
    if s is None or "moe.experts" not in s.spans:
        return None
    return s.layer_ms("moe.experts")
