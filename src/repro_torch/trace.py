"""Spans and counters on the port's training path, read from a
``torch.profiler`` trace.

``span(name)`` opens the profiler range ``repro_torch.<name>``
(``torch.profiler.record_function``) while a torch profiler records, so the
range sits on the same clock as the device trace; otherwise it returns one
shared null context and the path pays a flag test. ``spanned(name)`` is the
same as a decorator, decided at each call. ``count(name, value)`` adds a host
number or a 0-d device tensor (kept on the device, with no copy to the host)
to a module-level tally, also only while a profiler records; ``counters()``
sums it (one wait for the device, after the profile) and ``reset()`` clears
it. There is no other switch: no profiler, no ranges and no counts.

Spans (``repro_torch.`` + name):

- ``train_step``: the body of ``training.train_step.make_train_step``'s step;
- ``microbatch``: each microbatch's forward and backward in
  ``accumulate_grads``;
- ``forward``: the loss's forward (``model.loss``) of a microbatch;
- ``backward``: its ``loss.backward()``; the autograd engine runs the
  backward nodes on a thread of its own on the card, whose ops do not nest
  under this range, so a reader matches them by host time;
- ``clip``: ``clip_by_global_norm``; ``optimizer``: ``opt_update``;
- ``rope``: ``models.common.rope_tables``;
- ``layer``: each layer (``models.common.run_layer``); under remat its
  recompute opens it again inside a backward node, which is how a reader
  tells the recompute from that node's own backward;
- ``moe.route`` (router, softmax, top-k, aux loss), ``moe.dispatch``
  (capacity, ``dispatch``, the token gather into the expert buffer),
  ``moe.experts`` (the three batched matmuls, the GLU and the gates),
  ``moe.combine`` (each token's gathers and adds) and ``moe.shared`` (the
  shared experts), in ``models.moe._moe_tokens``;
- ``attention.backward``, ``ssd.backward``, ``rglru.backward``: the
  backward of ``kernels.ops.Attention``, ``SSDScan`` and ``RGLRU``;
- ``whisper.encode``: ``models.whisper.WhisperModel.encode``.

Under remat a layer's spans open again inside ``backward``, in its recompute.

Counters:

- ``train_step``: the train steps counted;
- ``moe.slots``: the expert slots (E·C) of each dispatch;
- ``moe.slots_live``: the slots that hold a token (the rest are rows of
  zeros, multiplied all the same);
- ``moe.assigned``: the routed (token, expert) entries (N·k);
- ``moe.dropped``: the routed entries that got no slot;
- ``moe.rows_gathered``: the rows the MoE's two gather kernels copy, in the
  forward (``models.moe.dispatch``) and in the backward
  (``kernels.ops.MoEDispatch``, ``MoECombine``);
- ``moe.rows_zeroed``: the output rows they write as zeros without a read
  (dead slots, tokens that lost every expert).

A layer's recompute under remat counts again, as its spans open again.
"""
from __future__ import annotations

import functools
import threading
from contextlib import nullcontext

from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
NULL = nullcontext()  # what span returns with no profiler recording

_tally: dict = {}
_lock = threading.Lock()


def recording() -> bool:
    """Whether a torch profiler records now."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """The range ``repro_torch.<name>`` while a profiler records, else :data:`NULL`."""
    if not _profiler._is_profiler_enabled:
        return NULL
    return _profiler.record_function(PREFIX + name)


def spanned(name: str):
    """Decorator: each call of the function inside :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value) -> None:
    """Adds ``value`` (a number, or a 0-d tensor, kept on its device until
    :func:`counters` sums it there) to the counter ``name`` while a profiler
    records."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _tally.setdefault(name, []).append(value)


def counters() -> dict[str, float]:
    """The counters' sums since :func:`reset`, as floats: each device's
    tensors summed on it and copied to the host at once."""
    import torch

    with _lock:
        items = [(k, list(vs)) for k, vs in _tally.items()]
    out, by_device = {}, {}
    for k, vs in items:
        out[k] = float(sum(v for v in vs if not isinstance(v, torch.Tensor)))
        for v in vs:
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, {}).setdefault(k, []).append(v.detach().double().reshape(()))
    for sums in by_device.values():
        names = list(sums)
        values = torch.stack([torch.stack(sums[k]).sum() for k in names]).tolist()
        for k, v in zip(names, values):
            out[k] += v
    return out


def reset() -> None:
    with _lock:
        _tally.clear()
