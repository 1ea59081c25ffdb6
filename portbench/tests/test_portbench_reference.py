"""The plain reference against the port's train step at the reduced size on
the CPU, and the faults that the comparison must catch.

Each run here is a whole run of the cell's mode (set-up, a short window, the
reference, the check) on the CPU, the card's look skipped."""
from __future__ import annotations

import time

import pytest

from portbench import check, harness, weights
from portbench.modes import train
from portbench.reference import train as reference
from portbench.tests.small import CONFIGS, small_cell, small_config

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def run(workload, seed=2**31 + 17, dtype="bfloat16", **traffic):
    spec, cfg = small_cell(workload, dtype=dtype, **traffic)
    return spec, train.run(spec, seed, 0.05, False, "cpu", time.time(), cfg=cfg, log=lambda *a: None)


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_follows_the_port_in_fp32(config):
    """In fp32 the port's three steps and the reference's agree to rounding,
    for every configuration file (a cell of each tied and untied
    embeddings): the reference is the same function, written apart."""
    spec, cfg = small_config(config, dtype="float32")
    out = train.run(spec, 2**31 + 17, 0.05, False, "cpu", time.time(), cfg=cfg, log=lambda *a: None)
    assert max(out["values"].values()) < 1e-4, out["values"]


@pytest.mark.parametrize("workload", CELLS)
def test_program_in_bf16_stays_near_the_reference(workload):
    """The served precision at the reduced size: near the fp32 reference (the
    cells' limits are set at their own sizes, on the card)."""
    _, out = run(workload, seq=32 if "4096" in workload else 16)
    assert max(out["values"].values()) < 0.05, out["values"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_leaves_the_reference_and_the_port_hold_are_the_same():
    from repro_torch.models import build_model

    for config in CONFIGS:
        spec, cfg = small_config(config)
        m = spec["config"]["model"]
        shapes = {n: tuple(p.shape) for n, p in build_model(cfg, "cpu").named_parameters()}
        assert shapes == {n: s for n, s, _ in weights.leaf_specs(m)}


def test_weights_draw_again_the_same():
    spec, _ = small_config(CONFIGS[0])
    m = spec["config"]["model"]
    for i, (name, _, std) in enumerate(weights.leaf_specs(m)):
        a, b = weights.draw(m, 5, i, "cpu"), weights.draw(m, 5, i, "cpu")
        assert a.equal(b) and (std == 0 or not a.equal(weights.draw(m, 6, i, "cpu")))
        if name in ("embed", "out_embed"):
            assert not a[m["vocab"]:].any()


def _control_numbers(spec, seed, device):
    """The control's numbers: the reference with float8 products, against
    the float32 reference, on the cell's batches and weights."""
    m, traffic = spec["config"]["model"], spec["traffic"]
    batches = [train.generator.TokenBatches(traffic, m["vocab"], seed).batch(i) for i in range(train.CHECKED_STEPS)]

    def follow(precision, **kw):
        return reference.follow(m, traffic, lambda i: weights.draw(m, seed, i, device), batches, device, precision,
                                **kw)

    ctrl = follow("fp8", keep_first=True)
    return check.numbers(ctrl, follow("fp32", against=ctrl.pop("first_unit")))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [99, 2**31 + 3, 7])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_cell(workload, seed):
    """The control, the reference computed with float8 products put in the
    program's place, against the float32 reference at the cell's own size:
    not correct by the cell's limits. The limits are the full-size cell's,
    so this runs on the card (the fp32 state alone is 64.8 GB); at the
    CPU's reduced sizes the control's first gradient norm reads inside them
    on some seeds."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    from portbench.tools import readings

    spec = harness.cell_spec(harness.benchmark(), workload)
    values = check.numbers(*readings.control(spec, seed, torch.device("cuda")))
    correct, checks = check.judge(values, spec["cell"]["limits"])
    assert not correct, checks


@pytest.mark.parametrize("seed", [99, 2**31 + 3, 7])
@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_far_above_rounding(workload, seed):
    """The control's path at the reduced size on the CPU: its widest number
    lies far above the fp32 port's (under 1e-4,
    ``test_reference_follows_the_port_in_fp32``), so the comparison sees its
    products' rounding."""
    spec, _ = small_cell(workload, seq=32 if "4096" in workload else 16)
    values = _control_numbers(spec, seed, "cpu")
    assert max(values.values()) > 3e-3, values


def _unchanged(ts, monkeypatch):
    def no_update(cfg, grads, opt_state, params):
        opt_state["count"] = opt_state["count"] + 1
        return params, opt_state, 0.0

    monkeypatch.setattr(ts, "opt_update", no_update)


def _half_batch(ts, monkeypatch):
    from portbench.tools.readings import half_batch

    monkeypatch.setattr(ts, "accumulate_grads", half_batch(ts)[1])


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_faults_come_out_not_correct(workload, fault, monkeypatch):
    """The timed path broken underneath: a step that returns its state
    unchanged, or that leaves half of the batch out and takes the mean over
    the rest. (One card: no exchange between chips to leave out.)"""
    from repro_torch.training import train_step as ts

    {"state_unchanged": _unchanged, "half_batch": _half_batch}[fault](ts, monkeypatch)
    _, out = run(workload, dtype="float32")  # sound runs read ~1e-7 here: a fault is all that shows
    assert not out["correct"], out["checks"]
