"""The last line of a run, and the runner's refusals without a card or
without the port beside it."""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import harness

BENCH = harness.benchmark()
CELL = BENCH["workloads"][0]["name"]
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 123}


def fake_out(value=0.01):
    run = SimpleNamespace(mode="train", window={"steps": 10, "seconds": 10.0, "tokens": 20480},
                          flops_per_step=5.4e12, busy_s=2.4, busy_steps=3, steps=1, calls={},
                          timeline=SimpleNamespace(device=[], in_range=lambda name: [], backward_of=lambda name: []))
    checks = {n: {"value": value, "limit": 0.1} for n in ("loss", "grad_norm", "first_grad", "change")}
    return {"correct": True, "attempted": 10, "failed": 0, "train_tokens_per_s": 2048.0, "setup_s": 20.0,
            "run": run, "busy_s": 2.4, "window_s": 3.3,
            "breakdown": {"device_ops": [["k", 1.0]], "idle_gaps": [["aten::mm", 0.1]]}, "checks": checks}


@pytest.mark.parametrize("trace_on", [False, True])
def test_last_line_keys(trace_on):
    line = harness.result_line(fake_out(), BENCH, CELL, trace_on, DEVICE)
    want = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace_on else []) + ["checks"]
    assert list(line) == want
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert ("busy_s" in line["device"]) == trace_on
    metrics = set(line["metrics"])
    if trace_on:
        assert metrics == {"mfu_pct.train", "device_idle_pct.train"}  # the fake trace has no kernels to read
        assert line["metrics"]["mfu_pct.train"]["value"] == pytest.approx(100 * 10 * 5.4e12 / (10 * 989e12))
    else:
        assert metrics == {"train_tokens_per_s", "setup_s"}
    json.loads(json.dumps(line, allow_nan=False))


def test_a_reading_that_is_no_number_is_printed_as_text():
    line = harness.result_line(fake_out(math.inf), BENCH, CELL, False, DEVICE)
    assert line["checks"]["loss"] == {"value": "inf", "limit": 0.1}
    json.loads(json.dumps(line, allow_nan=False))


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch.models", "jaxtyping", "repro", "repro.core.db", "jax.numpy", "flax", "portbench"]
    assert harness.forbidden_modules(names) == ["flax", "jax.numpy", "repro", "repro.core.db"]


def test_runner_needs_a_card(capsys):
    from portbench import run

    assert run.main(["--workload", CELL, "--seed", str(2**31 + 5), "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_runner_fails_beside_no_port(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone: no result, a code
    other than 0 (3 here, where there is no card; 5 on the card)."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "7", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert done.returncode != 0 and done.stdout == ""


def test_runner_without_the_port_exits_5(tmp_path, monkeypatch, capsys):
    import torch

    from portbench import run

    monkeypatch.setattr(run, "ROOT", tmp_path)
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.main(["--workload", CELL, "--seed", "7", "--seconds", "1"]) == 5
    assert capsys.readouterr().out == ""


def _event(name, start, end, eid=0, device=False, kernels=()):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, thread=1, sequence_nr=-1, fwd_thread=1, scope=0, id=eid, is_async=False,
                           time_range=SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, kernels=list(kernels),
                           is_user_annotation=False)


def ssd_run(calls=2):
    """A traced step of two SSD calls at the cell's shape, each in the range
    ``portbench.ssd_scan`` and launching three kernels (300, 50 and 100 µs:
    the two SSD kernels through the driver API, the recurrence between them
    through the runtime); a matmul launched outside it (50 µs); 3 ms of
    kernels tied to an op under the range ``portbench.ssd_backward``.
    ``calls`` shapes are recorded."""
    from portbench.timeline import Timeline

    shape = (1, 4096, 64, 64, 1, 128, 256, 2)
    host = [_event("repro_torch.train_step", 0, 100)]
    device = []
    for i, start in enumerate((1, 11)):
        eid = 200 + 10 * i
        host += [_event("portbench.ssd_scan", start, start + 9), _event("cuLaunchKernel", start + 1, start + 2, eid),
                 _event("cudaLaunchKernel", start + 3, start + 4, eid + 1),
                 _event("cuLaunchKernel", start + 5, start + 6, eid + 2)]
        device += [_event("void ssd_states_kernel<__nv_bfloat16, 64>(Params)", 1000 * i, 1000 * i + 300, eid, True),
                   _event("void inter_chunk<float>(Params)", 1000 * i + 300, 1000 * i + 350, eid + 1, True),
                   _event("void ssd_output_kernel<__nv_bfloat16, 64>(Params)", 1000 * i + 350, 1000 * i + 450,
                          eid + 2, True)]
    host += [_event("cudaLaunchKernel", 21, 22, 230), _event("portbench.ssd_backward", 30, 60),
             _event("aten::mul", 31, 59, kernels=[SimpleNamespace(duration=1000.0)] * 3)]
    device.append(_event("ampere_bf16_gemm", 3000, 3050, 230, True))
    run = fake_out()["run"]
    run.calls = {"ssd_scan": [shape] * calls, "ssd_backward": []}
    run.timeline = Timeline(host + device)
    return run, shape


def test_ssd_readers_on_synthetic_events():
    from portbench import flops

    run, shape = ssd_run()
    assert harness.reader("ssd_scan_roofline.train")(run) == pytest.approx(
        100 * 2 * flops.ssd_scan_bound_s(*shape) * 1e6 / 900)  # every kernel inside the range, the matmul not
    assert harness.reader("ssd_backward_ms.train")(run) == pytest.approx(3.0)
    assert harness.reader("flash_attention_roofline.train")(run) is None  # no flash call recorded
    assert harness.reader("ssd_scan_roofline.train")(ssd_run(calls=3)[0]) is None  # a recorded call with no range
    assert harness.reader("ssd_scan_roofline.train")(fake_out()["run"]) is None  # no call, no trace


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_ssd_metrics_only_in_the_ssd_cell(workload):
    out = fake_out()
    out["run"] = ssd_run()[0]
    metrics = set(harness.result_line(out, BENCH, workload, True, DEVICE)["metrics"])
    ssd = {"ssd_scan_roofline.train", "ssd_backward_ms.train"}
    assert (ssd <= metrics) if workload.startswith("mamba2") else not (ssd & metrics)
