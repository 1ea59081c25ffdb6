"""moe_slots_live_pct.train: the share of the MoE's expert slots that hold a
token, in %: 100 · the program's counter ``moe.slots_live`` over
``moe.slots`` (``repro_torch/trace.py``, counted in ``models.moe.dispatch``
over the profiled steps). The other slots read the pad row, and the expert
matmuls multiply them all the same. Read only where the run's trace holds
the program's spans, so that counts left from another profile in the
process cannot reach the line."""
from portbench import spans


def read(run):
    if spans.of(run) is None:
        return None
    from repro_torch import trace

    c = trace.counters()
    if not c.get("moe.slots"):
        return None
    return 100.0 * c["moe.slots_live"] / c["moe.slots"]
