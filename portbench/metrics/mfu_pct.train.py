"""mfu_pct.train: the model FLOPs of the window's steps (portbench/flops.py:
6 × the active matmul parameters per token plus 3 × the causal attention
products; recompute not counted) over the window's wall time × the card's
dense bf16 peak (989 TFLOP/s), in %. Read on the step clock of the traced
run's window, which is timed as the untraced run's is."""
from portbench.flops import PEAKS


def read(run):
    w = getattr(run, "window", None)
    if getattr(run, "mode", None) != "train" or not w or not w["steps"]:
        return None
    return 100.0 * w["steps"] * run.flops_per_step / (w["seconds"] * PEAKS["bf16_flops_per_s"])
