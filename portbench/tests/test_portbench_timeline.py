"""The trace reduction on the CPU profiler: a range's ops, the backward nodes
tied to its forward ops by sequence number (also under remat), and the
device's busy time as a union of intervals."""
from __future__ import annotations

from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from portbench import timeline


def toy_trace(remat: bool):
    inner, outer = torch.nn.Linear(8, 8), torch.nn.Linear(8, 8)

    def moe(x):
        return torch.relu(inner(x)) * 2.0

    def block(x):
        return outer(wrapped(x))

    wrapped = timeline.annotated("moe_ffn", moe)
    x = torch.randn(4, 8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        y.sum().backward()
    return timeline.Timeline(prof.events())


def names(events):
    return {e.name for e in events}


def test_range_and_its_backward_without_remat():
    tl = toy_trace(remat=False)
    assert {"aten::linear", "aten::relu", "aten::mul"} <= names(tl.in_range("moe_ffn"))
    back = names(tl.backward_of("moe_ffn"))
    assert {"AddmmBackward0", "ReluBackward0", "MulBackward0"} <= back
    assert "aten::threshold_backward" in back
    # the outer Linear's backward is not the range's
    outer_nodes = [e for e in tl.host if e.name == "AddmmBackward0"]
    assert len(outer_nodes) == 2 and sum(e in tl.backward_of("moe_ffn") for e in outer_nodes) == 1


def test_range_recompute_counts_as_the_range_under_remat():
    tl = toy_trace(remat=True)
    ranges = [e for e in tl.host if e.name == timeline.PREFIX + "moe_ffn"]
    assert len(ranges) == 2  # the forward and its recompute inside the backward
    recompute = [e for e in tl.in_range("moe_ffn") if e.name == "aten::relu"]
    assert len(recompute) == 2
    back = tl.backward_of("moe_ffn")
    assert {"ReluBackward0", "MulBackward0"} <= names(back)
    assert not set(map(id, back)) & set(map(id, tl.in_range("moe_ffn")))


def test_patched_restores_what_it_wraps():
    owner = SimpleNamespace(f=lambda a: a + 1)
    original = owner.f
    seen = []
    with timeline.patched({"f": (owner, "f", lambda a: seen.append(a))}):
        assert owner.f(2) == 3 and owner.f is not original
    assert owner.f is original and seen == [2]


def event(start, end, name="k"):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start),
                           name=name)


def test_busy_time_is_a_union_and_gaps_are_named():
    tl = timeline.Timeline([])
    tl.device = [event(0, 10), event(5, 12), event(20, 30), event(30, 31)]
    host = SimpleNamespace(time_range=SimpleNamespace(start=11, end=25, elapsed_us=lambda: 14), name="aten::mm",
                           thread=1)
    tl.host = [host]
    assert tl.busy_us() == 12 + 11
    assert tl.idle_gaps() == [["aten::mm", 8 / 1e6]]
    assert tl.top_kernels(1) == [["k", (10 + 7 + 10 + 1) / 1e6]]
