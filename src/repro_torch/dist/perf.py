"""§Perf variant switches.

Each flag gates one optimization that must stay mathematically equivalent
to the baseline path (``tests/test_torch_dist.py`` holds each against the
flag off, and against the reference's variant). Flags are ambient
(:func:`perf_context`) rather than threaded through call signatures, so a
variant can be toggled around an unmodified model call.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass


@dataclass(frozen=True)
class PerfConfig:
    save_dot_outputs: bool = False  # V1: remat saves the two post-product tensors of a layer
    moe_local_dispatch: bool = False  # V2: per-data-shard MoE routing
    sharded_decode_attn: bool = False  # V3/V5: flash-decode over the kv_seq sharded on `model`
    causal_chunk_growth: bool = False  # V4: growing causal attention chunks
    cast_weights_early: bool = False  # V6: stacked weights cast to the compute dtype before the layer
    bf16_rowparallel: bool = False  # V9: explicit row-parallel reduce-scatter + all-gather in bf16


_active: contextvars.ContextVar[PerfConfig] = contextvars.ContextVar("repro_torch_dist_perf", default=PerfConfig())


def perf() -> PerfConfig:
    """The ambient variant config (all-baseline when none installed)."""
    return _active.get()


@contextlib.contextmanager
def perf_context(cfg: PerfConfig):
    token = _active.set(cfg)
    try:
        yield cfg
    finally:
        _active.reset(token)


def under_current_flags(fn):
    """``fn`` run under the flags in effect now, and the mesh context
    (:func:`repro_torch.dist.under_current_mesh`), wherever it is called. A
    remat recompute runs in the backward, after the caller's
    :func:`perf_context` may have exited, and must take the forward's path."""
    from repro_torch.dist import under_current_mesh

    cfg = perf()
    fn = under_current_mesh(fn)

    def run(*args, **kwargs):
        with perf_context(cfg):
            return fn(*args, **kwargs)

    return run
