"""The program's own spans (``repro_torch/trace.py``: ranges named
``repro_torch.<span>``) in a traced run's timeline, and the device work and
runtime calls under them.

The spans nest per thread, as ``Timeline`` nests the benchmark's ranges; the
walk here is its own, for the program's prefix. Each device event is put
down to the CUDA API call that launched it (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaMemcpyAsync``, …): CUPTI gives the call and the
work it launched one correlation id, the ``id`` of both events. The call is
a host event on the launching thread, inside the spans open there, and so is
found for a kernel that the port launches through ctypes as well, which the
profiler ties to no op (``FunctionEvent.kernels``).

Three ways to be under a span:

- ``inside(name)``: the host ops nested in a ``name`` span on its thread (a
  layer's recompute under remat opens its spans again, inside the backward);
- ``during(name)``: the host ops on any thread that start while a ``name``
  span is open: the autograd engine runs the backward on a thread of its own
  on the card, whose ops do not nest under the main thread's ``backward``;
- ``backward_of(name)``: the ops inside the backward nodes that
  differentiate the span's forward ops, tied by sequence number as
  ``Timeline.backward_of`` ties them, and not inside a ``layer`` span: under
  remat a layer's recompute runs inside the first backward node that needs
  one of its saved tensors, and is the recompute's, not that node's.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

PREFIX = "repro_torch."
STEP = "train_step"
LAYER = "layer"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")  # block the host
COPIES = ("Memcpy", "Memset")  # device events that are no kernel
RUNTIME = re.compile(r"cu(da)?[A-Z]")  # the name of a CUDA API call (``cuda…``, ``cu…``)


def _start(e):
    return e.time_range.start


class Spans:
    """The program's spans over a :class:`portbench.timeline.Timeline`."""

    def __init__(self, tl):
        self.tl = tl
        self.labels: dict[int, frozenset] = {}  # id(host event) → the spans around it, itself included
        self.spans: dict[str, list] = defaultdict(list)  # span name → its events, by start
        by_thread = defaultdict(list)
        for e in tl.host:
            by_thread[e.thread].append(e)
        for evs in by_thread.values():
            stack: list = []
            for e in sorted(evs, key=lambda e: (e.time_range.start, -e.time_range.end)):
                while stack and (e.time_range.start >= stack[-1].time_range.end
                                 or e.time_range.end > stack[-1].time_range.end):
                    stack.pop()
                labels = self.labels[id(stack[-1])] if stack else frozenset()
                if e.name.startswith(PREFIX):
                    name = e.name[len(PREFIX):]
                    labels = labels | {name}
                    self.spans[name].append(e)
                self.labels[id(e)] = labels
                stack.append(e)
        for evs in self.spans.values():
            evs.sort(key=_start)
        self.spans = dict(self.spans)
        self.steps = len(self.spans.get(STEP, ()))

        runtime = {e.id: e for e in tl.host if RUNTIME.match(e.name)}
        self.launcher = {id(d): runtime.get(d.id) for d in tl.device}  # the runtime call that launched it, or None

    def inside(self, name: str) -> list:
        return [e for e in self.tl.host if name in self.labels[id(e)]]

    def during(self, name: str) -> list:
        spans = self.spans.get(name, [])
        starts = [e.time_range.start for e in spans]
        out = []
        for e in self.tl.host:
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start < spans[i].time_range.end:
                out.append(e)
        return out

    def backward_of(self, name: str) -> list:
        keys = {(e.thread, e.sequence_nr) for e in self.inside(name)
                if e.sequence_nr >= 0 and self.tl.node[id(e)] is None}
        out = []
        for e in self.tl.host:
            node = self.tl.node[id(e)]
            if node is not None and LAYER not in self.labels[id(e)] and (node.fwd_thread, node.sequence_nr) in keys:
                out.append(e)
        return out

    def recompute(self) -> list:
        """The ops of the remat recompute: inside a ``layer`` span inside a
        backward node."""
        return [e for e in self.tl.host if self.tl.node[id(e)] is not None and LAYER in self.labels[id(e)]]

    def launched_by(self, ops) -> list:
        """The device events launched by the runtime calls among ``ops``."""
        ids = {id(e) for e in ops}
        return [d for d in self.tl.device if id(self.launcher[id(d)]) in ids]

    def device_ms(self, ops) -> float:
        """Device ms a step of the events that ``ops`` launched."""
        return sum(d.time_range.elapsed_us() for d in self.launched_by(ops)) / 1e3 / self.steps

    def layer_ms(self, name: str) -> float:
        """Device ms a step of span ``name``: its forward, its recompute and
        the backward nodes tied to its forward ops."""
        return self.device_ms(self.inside(name) + self.backward_of(name))

    def idle_gaps(self, n: int = 10) -> list[list]:
        """[[span, seconds], …]: the device's idle gaps between its first and
        last work, summed by the innermost program span open at each gap's
        start (the shortest open on any thread; "none" outside them all), the
        ``n`` longest."""
        intervals = sorted((d.time_range.start, d.time_range.end) for d in self.tl.device)
        gaps, end = [], None
        for a, b in intervals:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        opened = sorted((e for evs in self.spans.values() for e in evs), key=_start)
        by = defaultdict(float)
        for a, b in gaps:
            inner = None
            for e in opened:
                if e.time_range.start > a:
                    break
                if a < e.time_range.end and (inner is None or e.time_range.elapsed_us() < inner.time_range.elapsed_us()):
                    inner = e
            by[inner.name[len(PREFIX):] if inner is not None else "none"] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


_last: list = [None, None]  # (timeline, its Spans): the readers of one run share one walk


def of(run):
    """The program's spans in ``run``'s traced timeline, or None where the
    run has no device trace or no ``repro_torch.train_step`` span (a program
    without spans, or a run of no train step)."""
    tl = getattr(run, "timeline", None)
    if getattr(run, "mode", None) != "train" or not getattr(tl, "host", None) or not tl.device:
        return None
    if _last[0] is not tl:
        _last[:] = [tl, Spans(tl)]
    spans = _last[1]
    return spans if spans.steps else None
