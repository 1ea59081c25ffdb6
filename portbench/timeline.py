"""The reduction of a ``torch.profiler`` trace to device times: the device's
busy time, the kernels inside the benchmark's ranges, the backward kernels
of a forward range, the busiest kernels and the longest idle gaps.

The arithmetic of ranges and busy time is copied from the program's
``launch/profile_serve.py`` (``annotated``, ``device_time``), with one
change: a kernel belongs to a range when the host op that launched
it (the profiler ties each kernel to one, ``FunctionEvent.kernels``) lies
inside the range on the host, where the program's script asks where the
kernel starts on the device.

A range's backward: the profiler gives each op that autograd records in the
forward a sequence number, and the backward node that differentiates it
(``autograd::engine::evaluate_function: XBackward0``) the same number and
the forward's thread. A kernel launched under such a node belongs to the
range whose forward ops carry that number. Under remat the range runs again
inside the backward; those kernels are the range's own (its recompute), and
the nodes that differentiate them are still the first forward's.
"""
from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager

from torch.autograd import DeviceType
from torch.profiler import record_function

PREFIX = "portbench."
EVALUATE = "autograd::engine::evaluate_function: "
BACKWARD_SCOPE = 1  # at::RecordScope::BACKWARD_FUNCTION

FLASH_KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_kernel")  # the port's flash kernel, bf16 and fp32


def is_flash(e) -> bool:
    return any(k in e.name for k in FLASH_KERNELS)


def annotated(name: str, fn, on_call=None):
    """``fn`` inside a profiler range named ``PREFIX + name``; ``on_call``
    (if given) sees each call's arguments first."""
    label = PREFIX + name

    def wrapper(*args, **kwargs):
        if on_call is not None:
            on_call(*args, **kwargs)
        with record_function(label):
            return fn(*args, **kwargs)

    wrapper.__wrapped__ = fn
    return wrapper


@contextmanager
def patched(targets: dict):
    """``{name: (owner, attribute)}``: each attribute replaced by
    :func:`annotated` for the block, restored after it. A value may be
    ``(owner, attribute, on_call)``."""
    saved = []
    try:
        for name, target in targets.items():
            owner, attr, *hook = target
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, annotated(name, fn, *hook))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(PREFIX)


def _is_backward_node(e) -> bool:
    return e.sequence_nr >= 0 and (e.name.startswith(EVALUATE) or e.scope == BACKWARD_SCOPE)


class Timeline:
    """The events of one profiled window: the device's kernels and copies
    with their times, and the host's events nested per thread, each with its
    device time (the kernels the profiler tied to it, ``FunctionEvent.
    kernels``), the benchmark's ranges around it and the backward node it
    runs in."""

    def __init__(self, events):
        events = list(events)
        self.device = [e for e in events if e.device_type == DeviceType.CUDA and not _is_annotation(e)]
        self.host = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
        self.labels: dict[int, frozenset] = {}  # id(event) → the ranges around it (itself included)
        self.node: dict[int, object] = {}  # id(event) → the innermost backward node around it, or None
        by_thread = defaultdict(list)
        for e in self.host:
            by_thread[e.thread].append(e)
        for evs in by_thread.values():  # events nest on a thread: a stack of the open ones
            stack: list = []
            for e in sorted(evs, key=lambda e: (e.time_range.start, -e.time_range.end)):
                while stack and (e.time_range.start >= stack[-1].time_range.end
                                 or e.time_range.end > stack[-1].time_range.end):
                    stack.pop()
                parent = stack[-1] if stack else None
                labels = self.labels[id(parent)] if parent is not None else frozenset()
                if e.name.startswith(PREFIX):
                    labels = labels | {e.name[len(PREFIX):]}
                self.labels[id(e)] = labels
                self.node[id(e)] = e if _is_backward_node(e) else (self.node[id(parent)] if parent is not None else None)
                stack.append(e)

    def busy_us(self) -> float:
        """Device time in which a kernel or a copy ran: the union of their
        intervals."""
        spans = sorted((e.time_range.start, e.time_range.end) for e in self.device)
        total, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def in_range(self, name: str) -> list:
        """The host events inside the range ``PREFIX + name`` (and the range)."""
        return [e for e in self.host if name in self.labels[id(e)]]

    def forward_keys(self, name: str) -> set[tuple[int, int]]:
        """(thread, sequence number) of the ops autograd recorded inside the
        range ``PREFIX + name``."""
        return {(e.thread, e.sequence_nr) for e in self.in_range(name)
                if e.sequence_nr >= 0 and not _is_backward_node(e)}

    def backward_of(self, name: str) -> list:
        """The host events inside the backward nodes that differentiate the
        range's forward ops, and not inside the range itself (its recompute)."""
        keys = self.forward_keys(name)
        out = []
        for e in self.host:
            node = self.node[id(e)]
            if node is not None and name not in self.labels[id(e)] and (node.fwd_thread, node.sequence_nr) in keys:
                out.append(e)
        return out

    def top_kernels(self, n: int = 10) -> list[list]:
        """[[kernel name, seconds], …]: the ``n`` kernels of most device time."""
        by = defaultdict(float)
        for e in self.device:
            by[e.name] += e.time_range.elapsed_us()
        return [[k, v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """[[what the host was doing, seconds], …]: the device's idle gaps
        between its first and last work, summed by the innermost host op that
        spanned each gap's start (the shortest of each thread's innermost),
        the ``n`` longest."""
        spans = sorted((e.time_range.start, e.time_range.end) for e in self.device)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        hosts = sorted(self.host, key=lambda e: (e.time_range.start, -e.time_range.end))
        stacks: dict = defaultdict(list)  # thread → its open ops, outermost first (ops nest on a thread)
        by, i = defaultdict(float), 0
        for a, b in gaps:
            while i < len(hosts) and hosts[i].time_range.start <= a:
                op = hosts[i]
                stack = stacks[op.thread]
                while stack and stack[-1].time_range.end < op.time_range.start:
                    stack.pop()
                stack.append(op)
                i += 1
            inner = None
            for stack in stacks.values():
                while stack and stack[-1].time_range.end < a:
                    stack.pop()
                if stack and (inner is None or stack[-1].time_range.elapsed_us() < inner.time_range.elapsed_us()):
                    inner = stack[-1]
            by[inner.name if inner is not None else "no host op"] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def device_us(events) -> float:
    """The device time of the kernels and copies the profiler tied to
    ``events`` (each kernel is tied to the one host op that launched it)."""
    return sum(k.duration for e in events for k in e.kernels)
