"""The work of each CUDA kernel, from its arguments' shapes and dtypes, and a
tally of it.

Each function returns a :class:`Cost`: the FLOPs the kernel's function needs
(the useful products: masked pairs and padding excluded, multiply and add
counted as two) and the bytes it must move (each input read once, each
output written once). The bound of a kernel is the larger of the two over
the card's rates (``chip_smoke.py``'s ``bound``).

The kernels' meta route (:mod:`.ops`) has shapes and no values, so it counts
a kernel by these functions; the CUDA route counts the same way while a
:func:`tally` is active, so a meta run and a card run of one step count
alike. Paged decode's work depends on the lengths: the CUDA route reads
them, a meta tensor has none, and the meta route counts every sequence at
its page table's capacity (the dry run's decode cells decode at a full
cache, where the two agree).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np

F32 = 4


class Cost(NamedTuple):
    flops: int
    bytes: int


def attention_pairs(T: int, S: int, causal: bool = True, window: int | None = None) -> int:
    """The (query, key) pairs the mask keeps: query t sees key s where
    s ≤ t (causal) and t − s < window, as ``ref.mha_reference``."""
    t = np.arange(T, dtype=np.int64)
    hi = np.minimum(S, t + 1) if causal else np.full(T, S, dtype=np.int64)
    lo = np.maximum(0, t - window + 1) if window is not None else np.zeros(T, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None) -> Cost:
    """q (B,T,H,hd), k/v (B,S,K,hd): QKᵀ and PV over the kept pairs; q, k,
    v read and the output written."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    return Cost(4 * hd * H * B * attention_pairs(T, S, causal, window),
                2 * q.numel() * q.element_size() + k.numel() * k.element_size() + v.numel() * v.element_size())


def paged_keys(pages_k, page_table, lengths) -> int:
    """Σ lengths: read from a CUDA or CPU tensor; on meta, every sequence at
    its table's capacity."""
    if lengths.is_meta:
        return page_table.shape[0] * page_table.shape[1] * pages_k.shape[1]
    return int(lengths.sum())


def paged_decode(q, pages_k, pages_v, page_table, lengths) -> Cost:
    """q (B,H,hd) over each sequence's ``length`` keys of pages (P,page,K,hd):
    the K and V rows of those keys, q, the output, the table and lengths."""
    _, H, hd = q.shape
    K = pages_k.shape[2]
    keys = paged_keys(pages_k, page_table, lengths)
    return Cost(4 * H * hd * keys,
                keys * K * hd * (pages_k.element_size() + pages_v.element_size()) + 2 * q.numel() * q.element_size()
                + page_table.numel() * page_table.element_size() + lengths.numel() * lengths.element_size())


def ssd_states(x, dA, B_, C_, chunk: int) -> Cost:
    """x (b,t,h,p), dA (b,t,h), B_/C_ (b,t,g,n) → y_diag (b,nc,h,cs,p) and
    the chunk states (b,nc,h,p,n), fp32. Per chunk: C·Bᵀ over its causal
    pairs once per group, then per head (C·Bᵀ ⊙ L)·x over those pairs and
    the state Bᵀ·x."""
    b, t, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    nc = -(-t // chunk)
    tri = chunk * (chunk + 1) // 2
    return Cost(b * nc * (g * 2 * tri * n + h * (2 * tri * p + 2 * chunk * p * n)),
                x.numel() * x.element_size() + dA.numel() * dA.element_size()
                + B_.numel() * B_.element_size() + C_.numel() * C_.element_size()
                + F32 * b * nc * h * (chunk * p + p * n))


def ssd_output(x, dA, C_, chunk: int) -> Cost:
    """y = y_diag + exp(cum)·(C·H_inᵀ) for x (b,t,h,p): y_diag
    (b,nc,h,cs,p), dA and H_in (b,nc,h,p,n), all fp32, and C_ (b,t,g,n)
    read; y written in x's dtype."""
    b, t, h, p = x.shape
    n = C_.shape[3]
    nc = -(-t // chunk)
    return Cost(2 * b * nc * h * chunk * p * n,
                F32 * (b * nc * h * chunk * p + dA.numel() + b * nc * h * p * n) + C_.numel() * C_.element_size()
                + x.numel() * x.element_size())


def rglru_scan(x, r, i, lam, h0=None) -> Cost:
    """x, r, i (B,T,W) read and y written in x's dtype; λ read and h_last
    written in fp32 (h0 read where given). Six FLOPs an element: r·base,
    2·log a, 1 − e, i·x, β·u, a·h + (the exponentials and the square root
    beside them)."""
    B, T, W = x.shape
    return Cost(6 * B * T * W,
                B * T * W * (x.element_size() + r.element_size() + i.element_size() + x.element_size())
                + F32 * W + F32 * B * W + (F32 * B * W if h0 is not None else 0))


# ---------------------------------------------------------------------------
# the tally (a module global, not a context variable: the autograd engine
# runs a CUDA backward, and a remat recompute in it, on a thread of its own)
# ---------------------------------------------------------------------------

class Tally:
    """Calls, FLOPs and bytes per kernel name."""

    def __init__(self):
        self.calls: dict[str, int] = {}
        self.flops: dict[str, int] = {}
        self.bytes: dict[str, int] = {}

    def add(self, name: str, cost: Cost) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.flops[name] = self.flops.get(name, 0) + cost.flops
        self.bytes[name] = self.bytes.get(name, 0) + cost.bytes

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())


_active: Tally | None = None


@contextlib.contextmanager
def tally():
    """Count every kernel call of the meta and CUDA routes while active."""
    global _active
    outer, _active = _active, Tally()
    try:
        yield _active
    finally:
        _active = outer


def counting() -> bool:
    return _active is not None


def record(name: str, cost: Cost) -> None:
    if _active is not None:
        _active.add(name, cost)
