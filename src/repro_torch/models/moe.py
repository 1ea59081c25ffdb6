"""Mixture-of-Experts FFN with sort-based capacity dispatch: the port of
``repro/models/moe.py::_moe_tokens``.

Tokens are routed top-k in fp32, their (token, expert) slots sorted by
expert id (stably), gathered into an ``(E, C, d)`` capacity-bounded buffer,
run through batched per-expert GLU matmuls in the compute dtype, gated by
their routing weights and summed back per token. Slots past an expert's
capacity ``C`` are dropped; the Switch aux loss keeps the router near
uniform. qwen2-moe's shared experts are a dense GLU of width
``n_shared_experts · d_ff`` behind a per-token fp32 sigmoid gate.

Two rules are written out where the reference leaves them to its scatters:

- **Slot 0 of an overflowing expert.** The reference writes every dropped
  slot to ``(expert, 0)`` with the pad token and gate 0, and on the CPU those
  writes land after the kept one and win: an expert routed more than ``C``
  slots also loses the token in its slot 0. :func:`dispatch` states this as a
  rule (``live`` below) and builds the table by gathers, so no write races.
- **The combine.** The reference scatter-adds the ``E·C`` expert outputs
  into their tokens in the order of the flattened table, i.e. ascending
  expert id for each token. :func:`moe_ffn` adds each token's ≤ k outputs
  in that order, one after another, with no atomics: the result is the same
  bits in every call.

The dispatch's gather and the combine's sums run through
``kernels.ops.MoEDispatch`` and ``MoECombine``: ``dispatch``'s ``table`` and
``slots`` are inverse maps, so each one's backward is the other's forward, a
row gather (a hand-written kernel on the card) with no accumulation into a
shared row, and no pad row is appended.

§Perf V2 (:func:`moe_ffn_local`): under a mesh whose data dims split the
batch, each data rank routes its own batch shard through the same body, its
capacity taken from its local token count, and the ranks average the aux
loss (and, given the global batch, gather the outputs). Under the train
step's batch split the baseline gathers the tokens and routes them all
(:func:`moe_ffn`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import dist as rdist
from repro_torch import trace
from repro_torch.dist import Axes
from repro_torch.dist.perf import perf
from repro_torch.kernels import ops
from .common import glu_activation, init_truncated_normal_, sigmoid


def moe_params(cfg, L: int, p) -> nn.ParameterDict:
    """The reference's ``init_moe`` tree for ``L`` stacked layers, each leaf
    made by ``p(*shape)``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    moe = {"router": p(L, d, E), "we_gate": p(L, E, d, ff), "we_up": p(L, E, d, ff), "we_down": p(L, E, ff, d)}
    if cfg.n_shared_experts:
        ffs = cfg.n_shared_experts * ff
        moe.update(ws_gate=p(L, d, ffs), ws_up=p(L, d, ffs), ws_down=p(L, ffs, d), ws_gate_scalar=p(L, d))
    return nn.ParameterDict(moe)


def moe_axes(cfg) -> dict:
    """The reference's logical axes of the MoE tree."""
    p = {
        "router": Axes("layers", "param_embed", None),
        "we_gate": Axes("layers", "experts", "param_embed", "mlp"),
        "we_up": Axes("layers", "experts", "param_embed", "mlp"),
        "we_down": Axes("layers", "experts", "mlp", "param_embed"),
    }
    if cfg.n_shared_experts:
        p["ws_gate"] = Axes("layers", "param_embed", "mlp")
        p["ws_up"] = Axes("layers", "param_embed", "mlp")
        p["ws_down"] = Axes("layers", "mlp", "param_embed")
        p["ws_gate_scalar"] = Axes("layers", "param_embed")
    return p


@torch.no_grad()
def init_moe_(moe: nn.ParameterDict, cfg, generator: torch.Generator) -> None:
    """The reference's stds: ``d^-½`` for the router, the experts' gate and
    up and the shared gate, up and scalar gate; ``d_ff^-½`` for the experts'
    down, ``(n_shared·d_ff)^-½`` for the shared down."""
    d = cfg.d_model
    for name in ("router", "we_gate", "we_up", "ws_gate", "ws_up", "ws_gate_scalar"):
        if name in moe:
            init_truncated_normal_(moe[name], d**-0.5, generator)
    init_truncated_normal_(moe["we_down"], cfg.d_ff**-0.5, generator)
    if cfg.n_shared_experts:
        init_truncated_normal_(moe["ws_down"], (cfg.n_shared_experts * cfg.d_ff) ** -0.5, generator)


def capacity(N: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert, by the reference's expression: padded up to a
    multiple of 64 (at least 64) and capped at N."""
    C = int((N * k / E) * capacity_factor) + 1
    return min(max(64, -(-C // 64) * 64), N)


def dispatch(top_i: torch.Tensor, top_p: torch.Tensor, E: int, C: int):
    """top_i, top_p (N, k) → (table (E, C) of token ids, N where a slot holds
    none; gates (E, C) fp32, 0 there; slots (N, k): each token's places in
    the flattened ``(E·C)`` expert outputs in ascending expert id, ``E·C``
    where the token lost that expert).

    A routed slot is live when its position in its expert's group is under C
    and it is not position 0 of an expert routed more than C slots (the
    reference's overwrite, module docstring)."""
    N, k = top_i.shape
    dev = top_i.device
    flat_e = top_i.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    experts = torch.arange(E, device=dev)
    grp_start = torch.searchsorted(sorted_e, experts, side="left")
    counts = torch.searchsorted(sorted_e, experts, side="right") - grp_start
    overflow = counts > C
    token_idx = sort_idx // k
    gate_sorted = top_p.reshape(-1)[sort_idx]

    # the table by gathers: slot (e, c) holds sorted entry grp_start[e] + c
    c = torch.arange(C, device=dev)
    live = (c[None, :] < counts[:, None]) & ~((c[None, :] == 0) & overflow[:, None])
    src = (grp_start[:, None] + c[None, :]).clamp(max=N * k - 1)
    table = torch.where(live, token_idx[src], N)
    gates = torch.where(live, gate_sorted[src], 0.0)

    # each routed entry's place in the flattened outputs, back in (token, k) order
    pos = torch.arange(N * k, device=dev) - grp_start[sorted_e]
    keep = (pos < C) & ~((pos == 0) & overflow[sorted_e])
    place_sorted = torch.where(keep, sorted_e * C + pos, E * C)
    place = torch.empty_like(place_sorted).scatter_(0, sort_idx, place_sorted)  # a permutation: no index repeats
    slots = place.view(N, k).gather(1, torch.argsort(top_i, dim=1))  # a token's experts are distinct
    if trace.recording():
        live_slots = torch.where(overflow, C - 1, counts).sum()  # an overflowing expert loses slot 0 too
        trace.count("moe.slots", E * C)
        trace.count("moe.slots_live", live_slots)
        trace.count("moe.assigned", N * k)
        trace.count("moe.dropped", N * k - live_slots)
        # the forward's gathers (the backward's count in ops.MoEDispatch / MoECombine): the
        # dispatch copies the live slots' tokens and zeroes the dead slots; the combine sums
        # the live slots and zeroes the tokens that lost every expert
        trace.count("moe.rows_gathered", 2 * live_slots)
        trace.count("moe.rows_zeroed", E * C - live_slots + (slots == E * C).all(dim=1).sum())
    return table, gates, slots


def moe_ffn(lp: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """lp: this layer's MoE leaves; x (B, T, d) → (y (B, T, d) in x's dtype,
    the aux loss, an fp32 scalar). Dispatch is over the whole batch, or per
    data shard under §Perf V2 where :func:`moe_ffn_local` applies.

    Which batch x is: the global batch (every rank's global value, as
    serving passes it), except inside :func:`repro_torch.dist.batch_split`
    (the train step under a mesh), where x is this rank's rows of the batch
    split over the data ranks. There the baseline gathers the tokens over
    those ranks first and routes the global batch, so the capacity and the
    aux loss are the reference's, and returns this rank's rows of y (the
    gather's backward brings each rank its rows' gradient)."""
    if perf().moe_local_dispatch:
        y, aux = moe_ffn_local(lp, x, cfg)
        if y is not None:
            return y, aux
    over = rdist.batch_axes()
    if not over:
        return _moe_tokens(lp, x, cfg)
    mesh = rdist.active_mesh()
    y, aux = _moe_tokens(lp, rdist.gather_rows(x, mesh, over), cfg)
    rows = rdist.shard_slice(mesh, over, y.shape[0])
    return y[rows], aux


def moe_ffn_local(lp: dict, x: torch.Tensor, cfg):
    """§Perf V2: each data rank routes its shard of the batch (capacity from
    its own N = B_l·T), the aux loss is averaged over the data dims' ranks
    (:func:`repro_torch.dist.pmean`) and y is this rank's rows. x as
    :func:`moe_ffn` says: the global batch, whose rows this rank cuts and
    whose y it gathers over the data ranks (:func:`repro_torch.dist.
    gather_rows`), or inside the train step's batch split its own rows,
    whose y it returns. Both collectives have a backward. (None, None)
    without a mesh or where the batch is not split, as the reference.
    ``moe_ffn_local.mesh_calls`` counts the calls that route a shard."""
    mesh = rdist.active_mesh()
    if mesh is None:
        return None, None
    split = rdist.batch_axes()
    if split is None:  # the global batch
        bspec = rdist.logical_to_spec(("batch", "seq", "embed"), x.shape, mesh)[0]
    else:  # this rank's rows
        bspec = split or None
    if bspec is None:  # batch unsharded: local is global
        return None, None
    moe_ffn_local.mesh_calls += 1
    rows = x if split is not None else x[rdist.shard_slice(mesh, bspec, x.shape[0])]
    y, aux = _moe_tokens(lp, rows, cfg)
    aux = rdist.pmean(aux, mesh, bspec)  # the mean over each data dim in turn, as the reference's pmean
    return (y if split is not None else rdist.gather_rows(y, mesh, bspec)), aux


moe_ffn_local.mesh_calls = 0


def _moe_tokens(lp: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch over all of x's tokens: ``repro/models/moe.py::_moe_tokens``."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * T
    xt = x.reshape(N, d)

    with trace.span("moe.route"):  # fp32
        logits = xt.float() @ lp["router"].float()
        probs = torch.softmax(logits, dim=-1)
        top_p, top_i = torch.topk(probs, k, dim=-1)
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)

        # aux load-balance loss (Switch): E · Σ_e f_e · P_e
        P_e = probs.mean(dim=0)
        f_e = F.one_hot(top_i, E).float().sum(dim=(0, 1)) / (N * k)
        aux = E * (f_e * P_e).sum()

    with trace.span("moe.dispatch"):
        C = capacity(N, k, E, cfg.capacity_factor)
        table, gates, slots = dispatch(top_i, top_p, E, C)
        xe = ops.MoEDispatch.apply(xt, table, slots)  # (E, C, d); a dead slot's row is zeros
    dt = x.dtype
    with trace.span("moe.experts"):
        h = glu_activation(torch.bmm(xe, lp["we_gate"].to(dt)), torch.bmm(xe, lp["we_up"].to(dt)), cfg.activation)
        ye = torch.bmm(h, lp["we_down"].to(dt)) * gates[..., None].to(dt)

    with trace.span("moe.combine"):  # each token's outputs added in ascending expert id
        y = ops.MoECombine.apply(ye, slots, table)

    if cfg.n_shared_experts:
        with trace.span("moe.shared"):
            hs = glu_activation(xt @ lp["ws_gate"].to(dt), xt @ lp["ws_up"].to(dt), cfg.activation)
            ys = hs @ lp["ws_down"].to(dt)
            g = sigmoid(xt.float() @ lp["ws_gate_scalar"].float())
            y = y + ys * g[:, None].to(dt)
    return y.reshape(B, T, d), aux.float()
