"""The program's spans in a trace (``portbench/spans.py``): on a real CPU
profile of a small cell's train step (nesting, the remat recompute, the
backward by sequence number), and the eight readers on synthetic events,
device work included, and on a run with no spans."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from portbench.generator import TokenBatches
from portbench.tests.small import small_cell
from portbench.tests.test_portbench_result import fake_out
from portbench.timeline import EVALUATE, Timeline

CELL = "qwen2-moe-a2.7b.l6.train.b4x512"
READERS = ("forward_ms.train", "backward_ms.train", "moe_dispatch_ms.train", "moe_experts_ms.train",
           "moe_combine_ms.train", "moe_slots_live_pct.train", "host_syncs.train", "launches.train")


@pytest.fixture(autouse=True)
def _clean_tally():
    from repro_torch import trace

    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def cpu_spans():
    """One train step of the small cell (2 layers, 2 microbatches, remat)
    under the CPU profiler."""
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_step import TrainConfig, init_state, make_train_step

    spec, cfg = small_cell(CELL, dtype="float32")
    traffic = spec["traffic"]
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    opt = OptimizerConfig(**traffic["optimizer"])
    state = init_state(model, torch.Generator().manual_seed(0), opt)
    step = make_train_step(model, TrainConfig(opt=opt, accum_steps=traffic["microbatches"], remat=traffic["remat"]))
    batch = {k: torch.from_numpy(v) for k, v in TokenBatches(traffic, cfg.vocab, 5).batch(0).items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    return spans.Spans(Timeline(prof.events())), cfg


def test_spans_nest_on_a_real_profile(cpu_spans):
    s, cfg = cpu_spans
    assert s.steps == 1
    assert len(s.spans["moe.dispatch"]) == cfg.n_layers * 2 * 2  # forward and recompute, 2 microbatches
    first = [e for e in s.inside("moe.dispatch") if s.tl.node[id(e)] is None]
    again = [e for e in s.inside("moe.dispatch") if s.tl.node[id(e)] is not None]
    assert first and again  # the forward, and the recompute inside a backward node
    assert all({"train_step", "microbatch", "forward", "layer", "moe.dispatch"} <= s.labels[id(e)] for e in first)
    assert all({"layer", "moe.dispatch"} <= s.labels[id(e)] and "forward" not in s.labels[id(e)] for e in again)
    recompute = {id(e) for e in s.recompute()}
    assert {id(e) for e in again} <= recompute


def test_backward_by_sequence_number_on_a_real_profile(cpu_spans):
    s, _ = cpu_spans
    for part in ("moe.dispatch", "moe.combine", "moe.experts"):
        back = s.backward_of(part)
        assert back, part
        ids = {id(e) for e in back}
        assert not ids & {id(e) for e in s.inside(part)} and not ids & {id(e) for e in s.recompute()}
    nodes = {e.name for e in s.backward_of("moe.dispatch") if e.name.startswith(EVALUATE)}
    assert any("IndexBackward" in n for n in nodes), nodes  # the token gather's backward
    assert not {id(e) for e in s.backward_of("moe.dispatch")} & {id(e) for e in s.backward_of("moe.combine")}
    during = {id(e) for e in s.during("backward")}
    assert {id(e) for e in s.backward_of("moe.combine")} <= during and {id(e) for e in s.recompute()} <= during


def ev(name, start, end, thread=1, seq=-1, fwd_thread=None, eid=0, device=False):
    return SimpleNamespace(name=name, thread=thread, sequence_nr=seq, fwd_thread=fwd_thread or thread, scope=0, id=eid,
                           time_range=SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, is_async=False, kernels=[],
                           is_user_annotation=name.startswith(spans.PREFIX) and device, device_resource_id=7)


def synthetic_run():
    """One step: a forward with a dispatch (launch 101, a sync), its
    backward node on the engine's thread (102), a node that recomputes the
    layer (a dispatch, 103, and an attention matmul, 106) before its own
    work (107), the optimizer (104 and a fill, 105)."""
    P = spans.PREFIX
    host = [
        ev(P + "train_step", 0, 100), ev(P + "microbatch", 1, 60), ev(P + "forward", 2, 20), ev(P + "layer", 3, 19),
        ev(P + "moe.dispatch", 4, 11), ev("aten::index", 5, 9, seq=7), ev("cudaLaunchKernel", 6, 7, eid=101),
        ev("aten::mul", 9.5, 10.5, seq=3), ev("cudaStreamSynchronize", 12, 13), ev(P + "backward", 21, 59),
        ev(EVALUATE + "IndexBackward0", 25, 40, thread=2, seq=7, fwd_thread=1),
        ev("cudaLaunchKernel", 26, 27, thread=2, eid=102),
        ev(EVALUATE + "MulBackward0", 41, 58, thread=2, seq=3, fwd_thread=1), ev(P + "layer", 42, 54, thread=2),
        ev(P + "moe.dispatch", 43, 50, thread=2), ev("cudaLaunchKernel", 44, 45, thread=2, eid=103),
        ev("aten::mm", 51, 53, thread=2, seq=40), ev("cudaLaunchKernel", 51.5, 52, thread=2, eid=106),
        ev("cudaLaunchKernel", 55, 56, thread=2, eid=107),
        ev(P + "optimizer", 61, 90), ev("cudaLaunchKernel", 62, 63, eid=104), ev("cudaMemsetAsync", 64, 65, eid=105),
    ]
    device = [ev("kernel_a", 6.5, 16.5, eid=101, device=True), ev("kernel_b", 26.5, 46.5, eid=102, device=True),
              ev("kernel_c", 46.5, 51.5, eid=103, device=True), ev("kernel_d", 52, 57, eid=106, device=True),
              ev("kernel_e", 57, 61, eid=107, device=True), ev("kernel_f", 63, 103, eid=104, device=True),
              ev("Memset (Device)", 103, 104, eid=105, device=True), ev(P + "train_step", 6.5, 104, device=True)]
    return SimpleNamespace(mode="train", timeline=Timeline(host + device), steps=1)


def test_readers_on_synthetic_events():
    from repro_torch import trace

    run = synthetic_run()
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("moe.slots", 200)
        trace.count("moe.slots_live", torch.tensor(50))
    got = {name: harness.reader(name)(run) for name in READERS}
    assert got == pytest.approx({
        "forward_ms.train": 0.010,  # 101
        "backward_ms.train": 0.034,  # 102, 103, 106, 107: every thread, recompute included
        "moe_dispatch_ms.train": 0.039,  # 101 and the recompute's 103, and the tied nodes' 102 and 107, not 106
        "moe_experts_ms.train": None, "moe_combine_ms.train": None,  # no such span opened
        "moe_slots_live_pct.train": 25.0,
        "host_syncs.train": 1.0,
        "launches.train": 6.0,  # every kernel of the step, the fill left out
    })
    s = spans.of(run)
    # gaps at 16.5 (the forward's layer open), 51.5 (the recompute's layer), 61 (the optimizer)
    assert s.idle_gaps() == [["layer", pytest.approx(10.5e-6)], ["optimizer", pytest.approx(2e-6)]]
    assert all(v is not None for v in s.launcher.values())


def test_readers_read_nothing_without_spans():
    from repro_torch import trace

    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("moe.slots", 200)  # a tally left from another profile
        trace.count("moe.slots_live", 50)
    bare = synthetic_run()
    bare.timeline.host = [e for e in bare.timeline.host if not e.name.startswith(spans.PREFIX)]
    for run in (fake_out()["run"], bare, SimpleNamespace(mode="serve")):
        assert {name: harness.reader(name)(run) for name in READERS} == dict.fromkeys(READERS)


def test_trace_report_on_synthetic_events():
    from portbench.tools.trace_report import report

    r = report(synthetic_run())
    assert r["span_ms"] == {"moe.dispatch": pytest.approx(0.039)}
    assert r["phase_ms"] == pytest.approx({"forward": 0.010, "backward": 0.034, "recompute": 0.010, "clip": 0.0,
                                           "optimizer": 0.041, "step": 0.085})
    assert r["span_kernels"]["moe.dispatch"][0] == ["kernel_b", pytest.approx(0.020)]
    assert r["unlaunched"] == 0 and r["counters"] == {}
    with pytest.raises(ValueError):
        report(fake_out()["run"])
