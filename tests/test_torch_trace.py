"""The port's spans and counters (``repro_torch/trace.py``): nothing without a
profiler, each span of a train step as often as the step opens it under
one, and the MoE's slot counters against a recount from ``dispatch``'s
outputs."""
from __future__ import annotations

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.moe import capacity, dispatch
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig, init_state, make_train_step


@pytest.fixture(autouse=True)
def _clean_tally():
    trace.reset()
    yield
    trace.reset()


def span_counts(prof) -> Counter:
    return Counter(e.name[len(trace.PREFIX):] for e in prof.events() if e.name.startswith(trace.PREFIX))


def test_no_profiler_no_span_and_no_count():
    assert not trace.recording()
    assert trace.span("train_step") is trace.NULL and trace.span("moe.dispatch") is trace.NULL
    trace.count("moe.slots", 7)
    trace.count("moe.slots_live", torch.tensor(3))
    assert trace.counters() == {}

    @trace.spanned("rope")
    def f(a, *, b):
        return a + b

    assert f(1, b=2) == 3 and f.__name__ == "f"


def test_spans_and_counts_open_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.recording()
        with trace.span("clip"):
            trace.count("moe.slots", 5)
            trace.count("moe.slots", torch.tensor(2))
            trace.count("moe.slots_live", torch.tensor(1, dtype=torch.int64))
    assert span_counts(prof) == Counter({"clip": 1})
    assert trace.counters() == {"moe.slots": 7.0, "moe.slots_live": 1.0}
    trace.reset()
    assert trace.counters() == {}


def test_train_step_spans_under_remat_and_two_microbatches():
    torch.manual_seed(0)
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    model = build_model(cfg, "cpu")
    opt = OptimizerConfig()
    state = init_state(model, torch.Generator().manual_seed(0), opt)
    step = make_train_step(model, TrainConfig(opt=opt, accum_steps=2, remat=True))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=g) for k in ("tokens", "labels")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    n = span_counts(prof)
    L = cfg.n_layers
    assert (n["train_step"], n["microbatch"], n["forward"], n["backward"], n["clip"], n["optimizer"]) == (1, 2, 2, 2, 1, 1)
    assert n["rope"] == 2  # once a forward: outside the layers, so not recomputed
    for part in ("layer", "moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared"):
        assert n[part] == L * 2 * 2, part  # each layer of each microbatch, forward and recompute
    c = trace.counters()
    assert c["train_step"] == 1
    N, k, E = 2 * 16, cfg.top_k, cfg.n_experts
    assert c["moe.slots"] == L * 2 * 2 * E * capacity(N, k, E, cfg.capacity_factor)
    assert c["moe.assigned"] == L * 2 * 2 * N * k
    assert c["moe.slots_live"] + c["moe.dropped"] == c["moe.assigned"]


def test_attention_backward_span():
    q, k, v = (torch.randn(1, 8, 2, 4, requires_grad=True) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ops.Attention.apply(q, k, v, True, None, 4).sum().backward()
    assert span_counts(prof) == Counter({"attention.backward": 1})
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("skew", [0.0, 0.9])
def test_slot_counters_recount_dispatch(skew):
    """``moe.slots_live`` is the table's entries that name a token and
    ``moe.dropped`` the routed entries with no slot, with and without
    experts routed past their capacity (which lose slot 0 too)."""
    N, k, E = 96, 2, 6
    g = torch.Generator().manual_seed(3)
    scores = torch.rand(N, E, generator=g)
    scores[:, 0] += skew * 10 * (torch.rand(N, generator=g) < skew)  # most tokens to expert 0
    top_p, top_i = torch.topk(torch.softmax(scores, -1), k, dim=-1)
    C = capacity(N, k, E, 1.0)
    with profile(activities=[ProfilerActivity.CPU]):
        table, _, slots = dispatch(top_i, top_p / top_p.sum(-1, keepdim=True), E, C)
    c = trace.counters()
    live, dropped = int((table < N).sum()), int((slots == E * C).sum())
    assert (c["moe.slots"], c["moe.slots_live"], c["moe.assigned"], c["moe.dropped"]) == (E * C, live, N * k, dropped)
    counts = torch.bincount(top_i.reshape(-1), minlength=E)
    assert bool((counts > C).any()) == (skew > 0)


@pytest.mark.parametrize("skew", [0.0, 0.9])
def test_row_counters_recount_the_gathers(skew):
    """``moe.rows_gathered`` and ``moe.rows_zeroed`` over a dispatch, the
    gathers of ``ops.MoEDispatch`` and ``MoECombine`` and their backwards:
    each direction copies the live slots once and zeroes the dead slots (the
    dispatch's gather and the combine's backward) and the tokens that lost
    every expert (the combine's sum and the dispatch's backward)."""
    N, k, E, d = 96, 2, 6, 8
    g = torch.Generator().manual_seed(3)
    scores = torch.rand(N, E, generator=g)
    scores[:, 0] += skew * 10 * (torch.rand(N, generator=g) < skew)
    top_p, top_i = torch.topk(torch.softmax(scores, -1), k, dim=-1)
    C = capacity(N, k, E, 1.0)
    xt = torch.randn(N, d, generator=g, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]):
        table, _, slots = dispatch(top_i, top_p / top_p.sum(-1, keepdim=True), E, C)
        xe = ops.MoEDispatch.apply(xt, table, slots)
        ops.MoECombine.apply(xe * 2, slots, table).sum().backward()
    c = trace.counters()
    live, unplaced = int((table < N).sum()), int((slots == E * C).all(1).sum())
    assert (c["moe.rows_gathered"], c["moe.rows_zeroed"]) == (4 * live, 2 * (E * C - live + unplaced))
