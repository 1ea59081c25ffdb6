"""The training mode: the port's train step on its own shapes, timed, traced
and checked against the plain reference.

Set-up builds the model (``repro_torch.models.build_model``) under the
training entry's allocator (``launch/train.py::train_allocator``), loads the
benchmark's weights (:mod:`portbench.weights`) into it, makes the train state
(``training.train_step.init_state``) and the step (``make_train_step``, fp32
masters, AdamW, remat) and drives that step through its first
``CHECKED_STEPS`` steps: the reference follows them, and they warm up
every shape the window uses. The window then calls the same step on new
batches, each drawn on the host and copied to the card inside its step
(from pinned memory, without a wait). It keeps ``AHEAD_S`` seconds of steps
queued on the card ahead of the one it waits for, so that the card stays fed
while the host stands still; once ``seconds`` have passed it sends nothing
more and waits for all it sent. ``train_tokens_per_s`` is all the tokens of
the steps sent in the window over the wall time from its start to that
last wait's end.

What differs between model families (the fields the program's config is
held to, the weights, the reference's loss, the model FLOPs, the calls
wrapped in ranges) is the family's (``portbench/families``, by the model
block's ``family``); the run, its window and its check are one for all.

With ``trace`` the benchmark's ranges (:mod:`portbench.timeline`) wrap the
optimizer update and the family's calls (the MoE FFN, the attention
backward and the flash call; the SSD's backward and its forward) for the
whole run, and ``torch.profiler`` records ``profile_steps`` more steps after
the window; the per-layer readers (``portbench/metrics``) read them.

After the window the peak memory is read, the program's state is freed and
the reference runs the checked steps again from the same weights and
batches (:mod:`portbench.check`).
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import torch

from portbench import check, families, generator, timeline, weights
from portbench.reference import train as reference

CHECKED_STEPS = 3  # the set-up's first steps, which the reference follows
ATTRIBUTION_STEPS = 1  # steps profiled with the host's ops: ~140k host events a step for granite-moe
AHEAD_S = 6.0  # seconds of steps queued ahead of the one waited for: a host stall of up to that costs no card time


def program_config(m: dict):
    """The port's registered config of ``m["arch"]`` cut to ``m["n_layers"]``."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(m["arch"]), n_layers=m["n_layers"])


def model_block(cfg, family) -> dict:
    """The port's config ``cfg`` as the fields of ``family``'s model block,
    with the attributes the family fixes."""
    return {f: getattr(cfg, family.ATTRS.get(f, f)) for f in family.FIELDS} | {f: getattr(cfg, f) for f in family.FIXED}


def verify(cfg, m: dict) -> None:
    """The program's config must be the configuration file's model, field
    by field, and of the model block's family: the benchmark measures what
    its file says."""
    family = families.of(m)
    got = model_block(cfg, family)
    want = {f: m[f] for f in family.FIELDS} | family.FIXED
    wrong = {f: (got[f], want[f]) for f in want if got[f] != want[f]}
    if wrong:
        raise ValueError(f"the program's {m['arch']} is not the configuration's: {wrong} (program, file)")


def _to(batch: dict, dev) -> dict:
    """The batch on ``dev``; on the card copied from pinned memory, queued
    behind the steps before it rather than waiting for them."""
    if dev.type != "cuda":
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(dev, non_blocking=True) for k, v in batch.items()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _event(dev):
    """An event recorded on ``dev``'s stream now (on the CPU, nothing to wait for)."""
    if dev.type != "cuda":
        return _Done()
    e = torch.cuda.Event(enable_timing=True, blocking=True)
    e.record()
    return e


class _Done:
    def synchronize(self) -> None:
        pass


def first_grad_norms(state: dict, b1: float) -> dict:
    """Each leaf's norm of step 1's gradient as AdamW got it, from its first
    moment after that step: m = (1 − b1)·g."""
    from repro_torch.convert import flatten

    return {k: float(torch.linalg.vector_norm(v)) / (1 - b1) for k, v in flatten(state["opt"]["m"]).items()}


@torch.no_grad()
def first_grad_units(state: dict) -> dict:
    """Each leaf's step-1 gradient as AdamW got it (its first moment, a
    multiple of it) over its norm, on the host in the reference's pieces:
    the direction that the reference's is held against."""
    from repro_torch.convert import flatten

    return {k: reference.unit_on_host(k, v) for k, v in flatten(state["opt"]["m"]).items()}


@torch.no_grad()
def change_norms(params: dict, m: dict, seed: int, dev) -> dict:
    """Each leaf's norm of its change from the weights it was given, each
    drawn again alone."""
    return {name: float(torch.linalg.vector_norm(weights.draw(m, seed, i, dev).sub_(params[name])))
            for i, (name, _, _) in enumerate(weights.leaf_specs(m))}


class TraceRun:
    """What the per-layer readers read, from two profiles after the window:
    ``busy_s`` over ``busy_steps`` steps profiled on the device alone (the
    host's ops unrecorded, so the steps keep nearly their pace), and
    ``timeline`` over ``steps`` steps with the host's ops (for the ranges;
    the host runs slower under it), with the shapes of the calls that the
    family records (``calls``: range → [shape, …]: the flash calls, the SSD
    calls) in those; the benchmark's ``ranges``; and the window's step clock
    and a step's model FLOPs."""

    def __init__(self, busy_s, busy_steps, tl, steps, window, calls, ranges, flops_per_step):
        self.mode = "train"
        self.busy_s, self.busy_steps, self.timeline, self.steps = busy_s, busy_steps, tl, steps
        self.window, self.calls, self.ranges, self.flops_per_step = window, calls, ranges, flops_per_step


def profiled(step, state, batches, first: int, traffic: dict, dev, window: dict, calls: dict,
             recording: list, flops_per_step: float, log) -> dict:
    """The two profiles after the window: ``profile_steps`` steps with the
    device's activity alone (busy time, window length, the busiest kernels),
    then ``ATTRIBUTION_STEPS`` with the host's ops too (the ranges, the idle
    gaps by host op, the recorded calls' shapes)."""
    from torch.profiler import ProfilerActivity, profile

    device = [ProfilerActivity.CUDA] if dev.type == "cuda" else []

    def steps(k, activities, at):
        with profile(activities=activities) as prof:
            t = time.perf_counter()
            for j in range(k):
                step(state, _to(batches.batch(at + j), dev))
                _sync(dev)
            wall = time.perf_counter() - t
        t = time.perf_counter()
        tl = timeline.Timeline(prof.events())
        return tl, wall, time.perf_counter() - t

    k = traffic["profile_steps"]
    busy_tl, wall, read_a = steps(k, device or [ProfilerActivity.CPU], first)
    busy = busy_tl.busy_us() / 1e6
    kb = ATTRIBUTION_STEPS
    recording[0] = True
    tl, wall_b, read_b = steps(kb, [ProfilerActivity.CPU] + device, first + k)
    recording[0] = False
    names = tuple(calls)
    ranges = {name: (round(timeline.device_us(tl.in_range(name)) / 1e3, 3),
                     round(timeline.device_us(tl.backward_of(name)) / 1e3, 3)) for name in names}
    log(f"[trace] device alone: {k} steps in {wall:.3f} s, busy {busy:.3f} s, {len(busy_tl.device)} device "
        f"events, read in {read_a:.1f} s; with the host: {kb} steps in {wall_b:.3f} s, "
        f"{len(tl.device)} device events, {len(tl.host)} host events, read in {read_b:.1f} s; device ms by range "
        f"(inside, its backward nodes) {ranges}; calls recorded {({n: len(c) for n, c in calls.items() if c})}; "
        f"flash kernels {sum(map(timeline.is_flash, tl.device))}")
    return {"run": TraceRun(busy, k, tl, kb, window, calls, names, flops_per_step), "busy_s": busy,
            "window_s": wall,
            "breakdown": {"device_ops": busy_tl.top_kernels(), "idle_gaps": tl.idle_gaps()}}


def run(spec: dict, seed: int, seconds: float, trace_on: bool, device: str, started: float,
        cfg=None, log=print) -> dict:
    """One run of a training cell. ``spec``: the cell's ``config``,
    ``traffic`` and ``cell`` files; ``started``: the process's start on
    ``time.time()``'s clock. ``cfg`` replaces the port's registered config
    (the tests' small models); it is held to the configuration all the same."""
    from repro_torch.launch.train import train_allocator
    from repro_torch.models import build_model
    from repro_torch.training import train_step as ts
    from repro_torch.training.optimizer import OptimizerConfig

    marks = []

    def mark(what):
        marks.append(f"{what} {time.time() - started:.2f}")

    mark("imports")
    m, traffic, cell = spec["config"]["model"], spec["traffic"], spec["cell"]
    cfg = cfg if cfg is not None else program_config(m)
    verify(cfg, m)
    family = families.of(m)
    dev = torch.device(device)
    opt = traffic["optimizer"]
    opt_cfg = OptimizerConfig(**opt)
    batches = generator.TokenBatches(traffic, m["vocab"], seed)
    checked = CHECKED_STEPS
    flops_per_step = family.flops_per_token(m, traffic["seq"]) * batches.tokens_per_batch

    targets = {"opt_update": (ts, "opt_update")} | family.targets() if trace_on else {}
    calls, recording = {name: [] for name in targets}, [False]

    def recorder(name, shape):
        def on_call(*args, **kwargs):
            if recording[0]:
                calls[name].append(shape(*args, **kwargs))

        return on_call

    targets = {name: (owner, attr, *(recorder(name, s) for s in shape))
               for name, (owner, attr, *shape) in targets.items()}

    out: dict = {"attempted": 0, "failed": 0, "breakdown": None, "run": None}
    with train_allocator(dev), timeline.patched(targets):
        model = build_model(cfg, dev)
        mark("model")
        params = dict(model.named_parameters())
        specs = weights.leaf_specs(m)
        shapes = {n: tuple(p.shape) for n, p in params.items()}
        if shapes != {n: s for n, s, _ in specs}:
            raise ValueError(f"the program's parameters {shapes} are not the configuration's leaves")
        for i, (name, _, _) in enumerate(specs):
            weights.fill_(params[name].data, m, seed, i)
        mark("weights")
        state = ts.init_state(model, None, opt_cfg)
        mark("state")
        step = ts.make_train_step(model, ts.TrainConfig(opt=opt_cfg, accum_steps=traffic["microbatches"],
                                                        remat=traffic["remat"]))

        prog = {"loss": [], "grad_norm": [], "first_grad": {}, "change": {}}
        reading_s, step_s = 0.0, []
        for i in range(checked):
            t = time.perf_counter()
            state, metrics = step(state, _to(batches.batch(i), dev))
            prog["loss"].append(float(metrics["loss"]))
            prog["grad_norm"].append(float(metrics["grad_norm"]))
            step_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            if i == 0:
                prog["first_grad"] = first_grad_norms(state, opt["b1"])
                units = first_grad_units(state)
            if i == checked - 1:
                prog["change"] = change_norms(params, m, seed, dev)
            reading_s += time.perf_counter() - t
            mark(f"step {i + 1}")
        _sync(dev)
        out["setup_s"] = time.time() - started - reading_s
        log(f"[setup] {out['setup_s']:.3f} s ({reading_s:.3f} s of readings for the check left out; seconds "
            f"from the process's start: {', '.join(marks)}); losses {prog['loss']}")

        # steps queued ahead, from the set-up's last (warm) step; each step's
        # end is an event, and the step `ahead` back is the one waited for
        ahead = max(1, round(AHEAD_S / step_s[-1]))
        events = [_event(dev)]
        n, t0, sent = 0, time.perf_counter(), []
        while time.perf_counter() - t0 < seconds:
            if len(events) > ahead:
                events[-ahead].synchronize()
            t = time.perf_counter()
            state, _ = step(state, _to(batches.batch(checked + n), dev))
            sent.append(time.perf_counter() - t)
            events.append(_event(dev))
            n += 1
        _sync(dev)
        t1 = time.perf_counter()
        window = {"steps": n, "seconds": t1 - t0, "tokens": n * batches.tokens_per_batch}
        out["attempted"] = n
        out["train_tokens_per_s"] = window["tokens"] / window["seconds"]
        ends = [round(a.elapsed_time(b), 1) for a, b in zip(events, events[1:])] if dev.type == "cuda" else []
        log(f"[window] {n} steps in {window['seconds']:.3f} s, {out['train_tokens_per_s']:.1f} tokens/s; "
            f"{ahead} queued ahead (set-up step {1e3 * step_s[-1]:.1f} ms); host ms to send a step: median "
            f"{1e3 * statistics.median(sent):.1f}, max {1e3 * max(sent):.1f}; card ms between step ends {ends}")

        if trace_on:
            out.update(profiled(step, state, batches, checked + n, traffic, dev, window, calls, recording,
                                flops_per_step, log))
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del state, step, model, params, metrics
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the reference's state (fp32 parameters, gradients and both moments:
        # 64.8 GB for qwen2-moe at 6 layers, 21.5 GB for mamba2-1.3b) grows in
        # the same segments
        t = time.perf_counter()
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            ref = reference.follow(m, traffic, lambda i: weights.draw(m, seed, i, dev),
                                   [batches.batch(i) for i in range(checked)], dev, against=units)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        del units
    values = check.numbers(prog, ref)
    out["values"] = values
    out["correct"], out["checks"] = check.judge(values, cell["limits"])
    log(f"[check] reference {time.perf_counter() - t:.1f} s; losses {ref['loss']}; "
        f"grad norms program {prog['grad_norm']} reference {ref['grad_norm']}; "
        f"median first-gradient leaf {statistics.median(ref['first_grad'].values()):.6g}")
    uncompared = {n: v for n, v in values.items() if n not in out["checks"]}
    if uncompared:
        log(f"[check] read, not compared (no limit in the cell): {uncompared}")
    for key in ("first_grad", "change"):
        log(f"[check] widest {key} leaves (program, reference): {check.worst_leaves(prog, ref, key)}")
    log(f"[check] leaves whose step-1 directions differ most: "
        f"{sorted(ref['first_dir'].items(), key=lambda kv: -kv[1])[:3]}")
    out["readings"] = {"program": prog, "reference": ref}
    return out
