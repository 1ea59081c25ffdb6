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
                          flops_per_step=5.4e12, busy_s=2.4, busy_steps=3, steps=1, flash_calls=[],
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
