"""device_idle_pct.train: 1 − (the device's busy time per step, kernels and
copies, from the steps profiled on the device alone) / (the wall time per
step of the window, timed without a profiler), in %. The profiled steps'
own wall time (``device.window_s``) runs longer by the profiler's cost."""


def read(run):
    if getattr(run, "mode", None) != "train" or run.busy_s <= 0 or not run.window["steps"]:
        return None
    return 100.0 * (1.0 - (run.busy_s / run.busy_steps) / (run.window["seconds"] / run.window["steps"]))
