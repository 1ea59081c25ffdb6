"""ssd_scan_roofline.train: the forward SSD's share of its roofline over the
forward calls of the profiled training steps (the forward and the remat
recompute), in %: Σ of each call's least time (portbench/flops.py
``ssd_scan_bound_s``: the call's own inputs and outputs and its products,
from the shapes recorded at each call of ``kernels.ops.ssd_scan``) over Σ of
the device time of all the work launched inside the benchmark's range
``portbench.ssd_scan`` around those calls, whatever kernels compute it. The
port launches its SSD kernels through ctypes, which the profiler ties to no
host op, so each device event is put down to the runtime call that launched
it (``portbench.spans``). The reading is given only where the range opened
once for each recorded call and launched device work."""
from portbench import spans
from portbench.flops import ssd_scan_bound_s
from portbench.timeline import PREFIX

RANGE = "ssd_scan"


def read(run):
    calls = getattr(run, "calls", {}).get(RANGE) if getattr(run, "mode", None) == "train" else None
    s = spans.of(run) if calls else None
    if s is None:
        return None
    inside = run.timeline.in_range(RANGE)
    if sum(e.name == PREFIX + RANGE for e in inside) != len(calls):
        return None
    us = sum(d.time_range.elapsed_us() for d in s.launched_by(inside))
    return 100.0 * sum(ssd_scan_bound_s(*call) for call in calls) * 1e6 / us if us > 0 else None
