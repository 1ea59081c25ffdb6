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

:func:`launches_per_call` and :func:`train_step_launches` give how many
times a model's serving calls and train steps launch each kernel, from its
config: what a run on the card is checked against, and what the meta
step's tally counts.
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


def gather_rows(src, idx, live_rows: int | None = None) -> Cost:
    """src (M, d) through idx (R,): the rows of src read once (all M, or
    ``live_rows`` where the caller knows how many distinct rows the indices
    reach), idx read, the (R, d) output written. No arithmetic."""
    row = src.shape[1] * src.element_size()
    read = src.shape[0] if live_rows is None else live_rows
    return Cost(0, read * row + idx.numel() * idx.element_size() + idx.shape[0] * row)


def gather_sum_rows(src, places, live_rows: int | None = None) -> Cost:
    """src (M, d) summed through places (N, k): k − 1 adds an output element;
    the rows of src read once (as :func:`gather_rows`), places read, the
    (N, d) output written."""
    N, k = places.shape
    d = src.shape[1]
    read = src.shape[0] if live_rows is None else live_rows
    return Cost(N * max(k - 1, 0) * d,
                (read + N) * d * src.element_size() + places.numel() * places.element_size())


# the kernels that a backward launches: {kernel: the kernel whose backward it
# is}. The MoE's two gathers are each other's backward (``ops.MoEDispatch``,
# ``ops.MoECombine``)
BACKWARD_OF = {"gather_rows": "gather_sum_rows", "gather_sum_rows": "gather_rows"}


def launches_per_call(cfg) -> dict[str, tuple[int, int]]:
    """{kernel: (launches per prefill or training forward, per decode
    call)} of a model config: one per layer of the kernel's kind (whisper:
    its encoder's self-attention, and its decoder's self- and
    cross-attention in the forward, self and cross in decode; a MoE layer:
    the dispatch's ``gather_rows`` and the combine's ``gather_sum_rows`` in
    both); kernels not listed launch never."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"ssd_states": (L, 0), "ssd_output": (L, 0)}
    if cfg.family == "hybrid":
        n_attn = sum(cfg._layer_kind(i) == "A" for i in range(L))
        return {"rglru_scan": (L - n_attn, 0), "flash_attention": (n_attn, 0), "paged_decode": (0, n_attn)}
    if cfg.family == "audio":
        return {"flash_attention": (cfg.enc_layers + 2 * L, 0), "paged_decode": (0, 2 * L)}
    if cfg.family == "moe":
        return {"flash_attention": (L, 0), "paged_decode": (0, L), "gather_rows": (L, L), "gather_sum_rows": (L, L)}
    return {"flash_attention": (L, 0), "paged_decode": (0, L)}


def train_step_launches(cfg, accum_steps: int, remat: bool) -> dict[str, int]:
    """{kernel: launches in one train step of ``accum_steps`` microbatches}:
    each layer's kernel once in every microbatch's forward and, under
    ``remat``, once more when the backward recomputes the layer; and once a
    microbatch in the backward of each forward call whose backward is a
    kernel (:data:`BACKWARD_OF`). The other backwards (``ops.Attention``,
    ``SSDScan``, ``RGLRU``) launch none. Every layer is a remat region of its
    own, whisper's encoder layers too, so the encoder's, the decoder's self-
    and its cross-attention calls all come twice a microbatch; kernels not
    listed launch never."""
    passes = 2 if remat else 1
    per_call = launches_per_call(cfg)
    out = {k: n * passes * accum_steps for k, (n, _) in per_call.items() if n}
    for k, fwd in BACKWARD_OF.items():
        if per_call.get(fwd, (0, 0))[0]:
            out[k] = out.get(k, 0) + per_call[fwd][0] * accum_steps
    return out


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
