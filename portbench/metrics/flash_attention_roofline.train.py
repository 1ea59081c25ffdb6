"""flash_attention_roofline.train: the flash kernel's share of its roofline
over the forward calls of the profiled training steps (the forward and the
remat recompute), in %: Σ of each call's least time (portbench/flops.py
``flash_bound_s``, from the shapes recorded at each call of
``kernels.ops.flash_attention``) over Σ of the device time of the flash
kernels (by name, ``portbench.timeline.FLASH_KERNELS``). The kernel is launched
through ctypes, which the profiler ties to no host op, so the kernels are
found by name, and the reading is given only where their count is the
count of recorded calls."""
from portbench.flops import flash_bound_s
from portbench.timeline import is_flash


def read(run):
    calls = getattr(run, "calls", {}).get("flash_attention") if getattr(run, "mode", None) == "train" else None
    if not calls:
        return None
    kernels = [e for e in run.timeline.device if is_flash(e)]
    if len(kernels) != len(calls):
        return None
    return 100.0 * sum(flash_bound_s(*call) for call in calls) * 1e6 / sum(
        e.time_range.elapsed_us() for e in kernels)
