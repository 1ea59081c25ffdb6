"""The plain reference against the port's train step at the reduced size on
the CPU, and the faults that the comparison must catch.

Each run here is a whole run of the cell's mode (set-up, a short window, the
reference, the check) on the CPU, the card's look skipped."""
from __future__ import annotations

import time

import pytest
import torch

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
    """Each leaf draws the same bits again; a seeded leaf other bits from
    another seed, a published value the same from every seed."""
    for config in CONFIGS:
        spec, _ = small_config(config)
        m = spec["config"]["model"]
        for i, (name, _, init) in enumerate(weights.leaf_specs(m)):
            a, b = weights.draw(m, 5, i, "cpu"), weights.draw(m, 5, i, "cpu")
            assert a.equal(b) and a.equal(weights.draw(m, 6, i, "cpu")) != init.seeded, name
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


def _sequential_ssd(X, A, B, C):
    """h_t = exp(A_t)·h_{t−1} + x_t B_tᵀ, y_t = h_t C_t, head by head (head i
    reads group i // (h / g)), one step at a time."""
    b, t, h, p = X.shape
    g, n = B.shape[2], B.shape[3]
    group = torch.arange(h) // (h // g)
    state = X.new_zeros(b, h, p, n)
    ys = []
    for s in range(t):
        state = torch.exp(A[:, s])[..., None, None] * state + X[:, s, :, :, None] * B[:, s, group][:, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, s, group]))
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("t, chunk", [(64, 16), (80, 32), (20, 32)])  # chunks that divide t, a ragged last one, one short
def test_mamba2_reference_ssd_is_the_sequential_scan(t, chunk):
    """The reference's SSD (Listing 1 over chunks) is the recurrence it
    stands for, in fp64, to rounding."""
    from portbench.reference.mamba2 import ssd

    g = torch.Generator().manual_seed(t + chunk)
    b, h, p, groups, n = 2, 4, 3, 2, 5
    X, B, C = (torch.randn(*s, generator=g, dtype=torch.float64) for s in ((b, t, h, p), (b, t, groups, n),
                                                                           (b, t, groups, n)))
    A = -torch.rand(b, t, h, generator=g, dtype=torch.float64) * 0.5  # log-decays dt·A ≤ 0
    y, final = ssd(X, A, B, C, chunk)
    y_ref, final_ref = _sequential_ssd(X, A, B, C)
    assert torch.allclose(y, y_ref, rtol=1e-10, atol=1e-10) and torch.allclose(final, final_ref, rtol=1e-10, atol=1e-10)


def _mamba2_over_chunks():
    """The small Mamba-2 (chunk 32) on rows of 80: three chunks, the last
    ragged."""
    return small_config("mamba2-1.3b", mix="train.b4x512", dtype="float32", seq=80)


def test_mamba2_reference_follows_the_port_over_chunks():
    """The port's Mamba2LM through make_train_step and the reference's
    follow, in fp32 from the same seeded weights: the same losses, gradient
    norms and per-leaf changes over the 3 checked steps, each gap under 1e-4:
    fp32 rounding over 2 layers, 3 chunks and 3 AdamW steps read 4e-8 to
    5e-7 on three seeds, and the control 1e-3 or more (below)."""
    spec, cfg = _mamba2_over_chunks()
    out = train.run(spec, 2**33 + 5, 0.05, False, "cpu", time.time(), cfg=cfg, log=lambda *a: None)
    assert max(out["values"].values()) < 1e-4, out["values"]


@pytest.mark.parametrize("seed", [3, 2**35 + 1])
def test_mamba2_control_reads_above_those_tolerances(seed):
    """The control (bf16 activations, fp8 in_proj, out_proj and head) on the
    same rows of three chunks: far above the fp32 port's 1e-4."""
    spec, _ = _mamba2_over_chunks()
    values = _control_numbers(spec, seed, "cpu")
    assert max(values.values()) > 3e-3, values


def _moe_leaf_specs_before_families(m):
    """The MoE decoder's leaves as the benchmark listed them before it had
    families: (name, shape, std), std 0 for zeros."""
    d, L, H, K, hd = m["d_model"], m["n_layers"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    E, ff, V = m["n_experts"], m["d_ff"], weights.padded_vocab(m)
    specs = [("embed", (V, d), d**-0.5), ("ln1", (L, d), 0.0), ("ln_f", (d,), 0.0),
             ("attn.wq", (L, d, H * hd), d**-0.5), ("attn.wk", (L, d, K * hd), d**-0.5),
             ("attn.wv", (L, d, K * hd), d**-0.5), ("attn.wo", (L, H * hd, d), (H * hd) ** -0.5)]
    if m["attention_bias"]:
        specs += [("attn.bq", (L, H * hd), 0.0), ("attn.bk", (L, K * hd), 0.0), ("attn.bv", (L, K * hd), 0.0)]
    specs += [("ln2", (L, d), 0.0), ("moe.router", (L, d, E), d**-0.5),
              ("moe.we_gate", (L, E, d, ff), d**-0.5), ("moe.we_up", (L, E, d, ff), d**-0.5),
              ("moe.we_down", (L, E, ff, d), ff**-0.5)]
    if m["n_shared_experts"]:
        fs = m["n_shared_experts"] * ff
        specs += [("moe.ws_gate", (L, d, fs), d**-0.5), ("moe.ws_up", (L, d, fs), d**-0.5),
                  ("moe.ws_down", (L, fs, d), fs**-0.5), ("moe.ws_gate_scalar", (L, d), d**-0.5)]
    if not m["tie_embeddings"]:
        specs.append(("out_embed", (V, d), d**-0.5))
    return specs


def _moe_draw_before_families(m, seed, index):
    name, shape, std = _moe_leaf_specs_before_families(m)[index]
    t = torch.empty(shape)
    if std == 0.0:
        return t.zero_()
    t.normal_(0.0, std, generator=torch.Generator().manual_seed(weights.leaf_seed(seed, index)))
    if name in ("embed", "out_embed"):
        t[m["vocab"]:] = 0
    return t


@pytest.mark.parametrize("config", ["qwen2-moe-a2.7b", "granite-moe-1b-a400m"])
def test_moe_leaves_are_drawn_as_before_families(config):
    """The MoE cells read the same weights: at the full size the same leaves
    in the same order with the same stds, and at the small size the same
    bits for two seeds."""
    m = harness.load("configs", config)["model"]
    assert [(n, s, i.std) for n, s, i in weights.leaf_specs(m)] == _moe_leaf_specs_before_families(m)
    small = small_config(config)[0]["config"]["model"]
    for seed in (11, 2**40 + 9):
        for i in range(len(weights.leaf_specs(small))):
            assert weights.draw(small, seed, i, "cpu").equal(_moe_draw_before_families(small, seed, i))
