"""Logical-axis sharding: named axes on parameters, caches and activations,
resolved to DTensor placements on a ``DeviceMesh`` by a rule table.

Model code annotates every tensor dimension with a *logical* name
(:class:`Axes` for parameter trees, plain tuples at :func:`constrain` call
sites); :func:`logical_to_spec` maps those names onto the mesh's named dims
via :func:`default_rules`, with two safety valves:

* **divisibility fallback**: a dim that does not divide the candidate mesh
  dims is replicated instead;
* **first-dim-wins conflict resolution**: a mesh dim claimed by an earlier
  dimension of the same tensor is unavailable to later dims, which fall
  through to their next candidate (or replicate).

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh dim's name, or a tuple of names the dim is split over jointly, major
first. :func:`to_placements` turns it into one DTensor placement per mesh
dim, and :func:`distribute_tree` places a tree of tensors by those rules.

The active mesh is ambient (:func:`mesh_context` / :func:`active_mesh`), so
model code stays mesh-agnostic. :func:`constrain` is the identity (the same
object) when no mesh is installed and on a plain tensor, which is what the
explicit-collective paths work on: each rank holds the global value of such
a tensor, or inside a path its own shard, and the path's collectives run on
the process group of a mesh dim (``mesh.get_group("model")``). On a DTensor
:func:`constrain` redistributes to the resolved placements.

Training under a mesh (the last section): the train step runs the model on
each rank's rows of the batch (:func:`batch_split`), and the placed
parameters are gathered at use (:func:`gather_param`), their gradients
averaged over the data ranks and cut to each rank's shard.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.tree import tree_map


class Axes:
    """Logical axis names for one tensor, e.g. ``Axes("layers", "param_embed",
    "heads")``. ``None`` marks a dimension that is always replicated.

    An ``Axes`` is a *leaf* of a tree, so a tree of them is walked in
    parallel with the matching tree of tensors. The raw name tuple is
    ``.t`` (e.g. dropping the stacked ``"layers"`` dim: ``Axes(*ax.t[1:])``).
    """

    __slots__ = ("t",)

    def __init__(self, *names: str | None):
        self.t = names

    def __repr__(self) -> str:
        return f"Axes{self.t!r}"

    def __eq__(self, other) -> bool:
        return isinstance(other, Axes) and self.t == other.t

    def __hash__(self) -> int:
        return hash((Axes, self.t))

    def __len__(self) -> int:
        return len(self.t)


class Rules(dict):
    """A rule table (:func:`default_rules`); :meth:`override` gives a copy
    with some logical names' candidates replaced (``[]``: replicate)."""

    def override(self, **names) -> "Rules":
        return Rules(self, **names)


def default_rules() -> Rules:
    """Logical name -> ordered candidate mesh-dim groups.

    Each candidate is a tuple of mesh dims the tensor dim shards across
    jointly (``("pod", "data")`` spans the pods and the data dim). The first
    candidate whose dims all exist in the mesh, are unclaimed by an earlier
    tensor dim, and divide the tensor dim's size wins. Names absent from the
    table (and ``None``) replicate.

    Conventions: ``batch``/``cache_batch`` are data-parallel; ``param_*``
    shards over ``data`` (FSDP); heads/ffn/experts/vocab and the other
    model-parallel dims shard over ``model`` (megatron TP); ``seq`` /
    ``layers`` / small state dims replicate.
    """
    dp = (("pod", "data"), ("data",), ("pod",))
    tp = (("model",),)
    fsdp = (("data",),)
    return Rules({
        "batch": dp,
        "cache_batch": dp,
        "param_embed": fsdp,
        "param_seq": (),
        "vocab": tp,
        "act_vocab": tp,
        "heads": tp,
        "act_heads": tp,
        "kv": tp,
        "act_kv": tp,
        "kv_seq": tp,
        "mlp": tp,
        "act_mlp": tp,
        "experts": tp,
        "act_experts": tp,
        "rnn_width": tp,
        "conv_dim": tp,
        "ssm_heads": tp,
    })


def mesh_shape(mesh) -> dict[str, int]:
    """Mesh dim name -> size: a ``DeviceMesh``'s ``mesh_dim_names`` with its
    ``shape``, or the ``shape`` mapping of any object that has one (test
    fakes, :class:`repro_torch.launch.mesh.MeshLayout`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def logical_to_spec(axes, shape, mesh, rules=None) -> tuple:
    """Resolve logical names to a spec against ``mesh``: one entry per named
    dim (``None``, a mesh dim's name, or a tuple of names). Only the
    mesh's name -> size mapping is read (:func:`mesh_shape`). ``axes`` may
    be shorter than ``shape``; trailing dims replicate."""
    if rules is None:
        rules = _active_rules.get() or default_rules()
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    out = []
    for name, dim in zip(axes, shape):
        pick = None
        for cand in rules.get(name, ()) if name is not None else ():
            cand_t = cand if isinstance(cand, tuple) else (cand,)
            if any(a not in sizes or a in used for a in cand_t):
                continue
            n = 1
            for a in cand_t:
                n *= sizes[a]
            if dim % n != 0:
                continue
            pick = cand_t[0] if len(cand_t) == 1 else cand_t
            used.update(cand_t)
            break
        out.append(pick)
    return tuple(out)


def entry_axes(entry) -> tuple[str, ...]:
    """A spec entry's mesh dims, major first: ``()`` for ``None``."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec, mesh) -> tuple:
    """One DTensor placement per dim of ``mesh``: ``Shard(d)`` on every mesh
    dim that tensor dim ``d``'s entry names, ``Replicate()`` elsewhere. A dim
    split over several mesh dims must name them in the mesh's order (major
    first), as the default rules do."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's dim order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def placement_spec(t) -> tuple:
    """The inverse of :func:`to_placements` for a DTensor ``t``: per tensor
    dim, the tuple of mesh dims that shard it, in the mesh's order."""
    from torch.distributed.tensor import Shard

    names = t.device_mesh.mesh_dim_names
    return tuple(tuple(a for a, p in zip(names, t.placements) if isinstance(p, Shard) and p.dim == d)
                 for d in range(t.ndim))


def tree_shardings(mesh, tree, axes_tree, rules=None):
    """The tree of placements matching ``tree`` (tensors, meta tensors or
    anything with a ``shape``; other leaves map to None). No tensor is
    touched, so it works on meta-device trees."""

    def one(x, ax):
        if not hasattr(x, "shape"):
            return None
        t = ax.t if isinstance(ax, Axes) else tuple(ax)
        return to_placements(logical_to_spec(t, x.shape, mesh, rules), mesh)

    return tree_map(one, tree, axes_tree)


def shard_tensor(t: torch.Tensor, mesh, placements):
    """``t`` (the same global value on every rank) as a DTensor: each rank
    keeps its own shard, cut locally (no collective; even splits, as the
    rules only shard a dim its mesh dims divide). A shard is a view where
    it is contiguous, else a copy."""
    from torch.distributed.tensor import DTensor, Shard

    local = t
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False, shape=t.shape,
                              stride=t.stride())


def distribute_tree(tree, mesh, axes_tree, rules=None):
    """Place every tensor of ``tree`` on ``mesh`` by the logical axes of the
    parallel ``axes_tree``; other leaves (a cache's int length) pass
    through."""

    def one(x, ax):
        if not isinstance(x, torch.Tensor):
            return x
        t = ax.t if isinstance(ax, Axes) else tuple(ax)
        return shard_tensor(x, mesh, to_placements(logical_to_spec(t, x.shape, mesh, rules), mesh))

    return tree_map(one, tree, axes_tree)


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def select(t: torch.Tensor, index: int) -> torch.Tensor:
    """``t[index]`` along dim 0 (a layer of a stacked tensor). A DTensor,
    whose dim 0 must be replicated, stays a DTensor on the same mesh whose
    local tensor is a view of ``t``'s, so writes reach ``t``."""
    if not is_dtensor(t):
        return t[index]
    from torch.distributed.tensor import DTensor, Shard

    if any(isinstance(p, Shard) and p.dim == 0 for p in t.placements):
        raise ValueError("select: dim 0 of the DTensor is sharded")
    placements = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in t.placements)
    return DTensor.from_local(t.to_local()[index], t.device_mesh, placements, run_check=False,
                              shape=t.shape[1:], stride=t.stride()[1:])


# ---------------------------------------------------------------------------
# the explicit-collective paths' pieces: a rank's shard of a dim and the
# collectives over a spec entry's mesh dims
# ---------------------------------------------------------------------------

def shard_slice(mesh, entry, n: int) -> slice:
    """This rank's slice of a dim of length ``n`` split over ``entry``'s mesh
    dims (row-major over them, major first)."""
    sizes = mesh_shape(mesh)
    idx, size = 0, 1
    for a in entry_axes(entry):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        size *= sizes[a]
    per = n // size
    return slice(idx * per, (idx + 1) * per)


def all_gather_axes(x: torch.Tensor, mesh, entry, dim: int) -> torch.Tensor:
    """The inverse of :func:`shard_slice`: every rank's ``x`` concatenated
    along ``dim`` over ``entry``'s mesh dims, the minor dim first."""
    import torch.distributed as dist

    for a in reversed(entry_axes(entry)):
        group = mesh.get_group(a)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim=dim)
    return x


def all_reduce_axes(x: torch.Tensor, mesh, entry, op) -> torch.Tensor:
    """``x`` reduced in place by ``op`` over ``entry``'s mesh dims, one dim at
    a time; returns ``x``."""
    import torch.distributed as dist

    for a in entry_axes(entry):
        dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


# ---------------------------------------------------------------------------
# ambient mesh
# ---------------------------------------------------------------------------

_active_mesh: contextvars.ContextVar = contextvars.ContextVar("repro_torch_dist_mesh", default=None)
_active_rules: contextvars.ContextVar = contextvars.ContextVar("repro_torch_dist_rules", default=None)


def active_mesh():
    """The mesh installed by the innermost :func:`mesh_context`, or None."""
    return _active_mesh.get()


@contextlib.contextmanager
def mesh_context(mesh, rules=None):
    """Install ``mesh`` (and optionally a rule table) as the ambient sharding
    context consulted by :func:`constrain` / :func:`active_mesh`. ``None``
    explicitly disables constraints (every ``constrain`` is the identity)."""
    t_mesh = _active_mesh.set(mesh)
    t_rules = _active_rules.set(rules)
    try:
        yield mesh
    finally:
        _active_mesh.reset(t_mesh)
        _active_rules.reset(t_rules)


def constrain(x, axes, rules=None):
    """``x`` redistributed to the placements its logical ``axes`` resolve to
    under the ambient mesh. The identity (the same object) when no mesh is
    installed, and on a plain tensor: the rank-local value of an
    explicit-collective path."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    t = axes.t if isinstance(axes, Axes) else tuple(axes)
    want = to_placements(logical_to_spec(t, x.shape, mesh, rules), mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def constrain_tree(tree, axes_tree, drop_leading: int = 0, rules=None):
    """Constrain every leaf of ``tree`` per the parallel ``axes_tree``.
    ``drop_leading=1`` strips the logical name of a stacked leading dim (a
    layer's slice of the stacked parameters has lost its ``"layers"``
    axis)."""
    if active_mesh() is None:
        return tree

    def one(x, ax):
        t = ax.t if isinstance(ax, Axes) else tuple(ax)
        return constrain(x, t[drop_leading:], rules)

    return tree_map(one, tree, axes_tree)


def under_current_mesh(fn):
    """``fn`` run under the mesh, rules and batch split in effect now,
    wherever it is called: a remat recompute runs in the backward, on
    autograd's thread for CUDA tensors, where the caller's contexts are not
    set."""
    mesh, rules, split = _active_mesh.get(), _active_rules.get(), _batch_split.get()

    def run(*args, **kwargs):
        with mesh_context(mesh, rules), _split_context(split):
            return fn(*args, **kwargs)

    return run


# ---------------------------------------------------------------------------
# training under a mesh: the batch split over the data dims, and parameters
# gathered at use
#
# The train step gives each rank its rows of the global batch (the
# ``batch`` rule's mesh dims split them) and runs the model on them under
# :func:`batch_split`. Compute is replicated across the other mesh dims
# (``model``): each of their ranks computes the same values. A placed
# parameter (a DTensor) is gathered to the plain full tensor the model
# computes on just before its layer runs (:func:`gather_param`); its
# gradient is averaged over the ranks that split the batch and cut to the
# rank's shard. So each rank's loss is an estimate of the global loss whose
# mean over the data ranks is the global loss (``softmax_cross_entropy``
# divides a rank's sum by its share of the global token count), and a value
# every data rank computes alike (the MoE aux loss over the gathered tokens)
# enters each rank's loss whole.
# ---------------------------------------------------------------------------

_batch_split: contextvars.ContextVar = contextvars.ContextVar("repro_torch_dist_batch_split", default=None)


@contextlib.contextmanager
def _split_context(axes):
    token = _batch_split.set(axes)
    try:
        yield
    finally:
        _batch_split.reset(token)


def batch_split(entry):
    """The context the train step runs the model in under a mesh: the batch
    the model sees is this rank's rows of the global batch, split over
    ``entry``'s mesh dims of the active mesh (``None``: not split, every
    rank holds the whole batch)."""
    return _split_context(entry_axes(entry))


def batch_axes() -> tuple[str, ...] | None:
    """The mesh dims that split the batch the model sees inside
    :func:`batch_split` (``()`` where the train step does not split it);
    None outside it, where the model sees the global batch."""
    return _batch_split.get()


def axes_size(mesh, axes) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage: in-place updates reach the
    DTensor), or ``t`` itself."""
    if not is_dtensor(t):
        return t
    with torch.no_grad():
        return t.to_local()


def sharded_axes(t) -> tuple[str, ...]:
    """The mesh dims a DTensor is sharded over, in the mesh's order: ``()``
    for a plain tensor."""
    if not is_dtensor(t):
        return ()
    return tuple(a for d in placement_spec(t) for a in d)


def sum_over_shards(values: list, tensors: list) -> list:
    """``values[i]`` (0-d, computed on ``tensors[i]``'s local shard) summed
    over the ranks that hold the other shards of that tensor, so that each
    shard counts once and a replica not again: one all-reduce per mesh dim
    over the values of the tensors it shards."""
    import torch.distributed as dist

    sharded = [sharded_axes(t) for t in tensors]
    mesh = next((t.device_mesh for t, ax in zip(tensors, sharded) if ax), None)
    if mesh is None:
        return values
    out = list(values)
    for a in mesh.mesh_dim_names:
        idx = [i for i, ax in enumerate(sharded) if a in ax]
        if idx:
            v = torch.stack([out[i] for i in idx])
            dist.all_reduce(v, group=mesh.get_group(a))
            for j, i in enumerate(idx):
                out[i] = v[j]
    return out


def reduce_scatter_axis(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``x`` summed over the ranks of mesh dim ``axis``, each rank keeping
    its slice of ``dim`` (the inverse of :func:`all_gather_axes`' order)."""
    import torch.distributed as dist

    inp = x.movedim(dim, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // mesh_shape(mesh)[axis],) + inp.shape[1:])
    dist.reduce_scatter_tensor(out, inp, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def _grad_to_shard(g: torch.Tensor, spec, mesh, over) -> torch.Tensor:
    """The gradient ``g`` of a parameter's full value (per tensor dim
    ``spec`` names the mesh dims that shard it) → the mean over the ranks of
    the mesh dims ``over`` (those that split the batch), cut to this rank's
    shard. A dim sharded by one batch dim alone is reduce-scattered over it;
    the other batch dims are all-reduced."""
    import torch.distributed as dist

    def cut(x, d, axes):
        return x.narrow(d, shard_slice(mesh, axes, x.shape[d]).start, x.shape[d] // axes_size(mesh, axes))

    for d, axes in enumerate(spec):  # dims no batch dim shards: this rank's slice
        if axes and not set(axes) & set(over):
            g = cut(g, d, axes)
    g = g.clone(memory_format=torch.contiguous_format) if over else g  # the all-reduces work in place
    for a in over:
        d = next((d for d, axes in enumerate(spec) if tuple(axes) == (a,)), None)
        if d is None:
            g = g.contiguous()
            dist.all_reduce(g, group=mesh.get_group(a))
        else:
            g = reduce_scatter_axis(g, mesh, a, d)
    for d, axes in enumerate(spec):  # dims sharded jointly with a batch dim
        if axes and set(axes) & set(over) and tuple(axes) not in {(a,) for a in over}:
            g = cut(g, d, axes)
    n = axes_size(mesh, over)
    return g / n if n > 1 else g


class _GatherParam(torch.autograd.Function):
    """A placed parameter (or layer ``index`` of a stacked one) as the plain
    full tensor: all-gathered over the mesh dims that shard it. The backward
    adds the gradient, averaged over the ranks that split the batch and cut
    to this rank's shard, into the parameter's ``.grad`` (a DTensor placed
    as the parameter) in place, as :func:`repro_torch.models.common.layer_view`
    does; autograd itself carries no gradient to the parameter."""

    @staticmethod
    def forward(ctx, p, index, over):
        ctx.p, ctx.index, ctx.over = p, index, over
        return _gather(p, index)

    @staticmethod
    def backward(ctx, g):
        p, index = ctx.p, ctx.index
        spec = placement_spec(p)[0 if index is None else 1:]
        shard = _grad_to_shard(g, spec, p.device_mesh, ctx.over)
        with torch.no_grad():
            if p.grad is None:
                from torch.distributed.tensor import DTensor

                p.grad = DTensor.from_local(torch.zeros_like(p.to_local()), p.device_mesh, p.placements,
                                            run_check=False, shape=p.shape, stride=p.stride())
            acc = p.grad.to_local()
            (acc if index is None else acc[index]).add_(shard.to(acc.dtype))
        return None, None, None


def _gather(p, index) -> torch.Tensor:
    x = local(p)
    spec = placement_spec(p)
    if index is None:
        x = x.view(x.shape)  # a tensor of its own, not the DTensor's local one
    else:
        if spec[0]:
            raise ValueError(f"gather_param: dim 0 of a stacked parameter is sharded over {spec[0]}")
        x, spec = x[index], spec[1:]
    for d, axes in enumerate(spec):
        if axes:
            x = all_gather_axes(x, p.device_mesh, axes, d)
    return x


def gather_param(p: torch.Tensor, index: int | None = None) -> torch.Tensor:
    """The plain full value of a placed parameter, or of its layer ``index``
    (dim 0 of a stacked parameter, which is never sharded), for the model to
    compute on: gathered over the mesh dims that shard it. When autograd
    records it, the gradient reaches ``p.grad`` as :class:`_GatherParam`
    says. A plain ``p`` is returned as it is (``p[index]`` for an index)."""
    if not is_dtensor(p):
        return p if index is None else p[index]
    if torch.is_grad_enabled() and p.requires_grad:
        return _GatherParam.apply(p, index, batch_axes() or ())
    return _gather(p, index)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows (dim 0) concatenated over ``entry``'s mesh dims;
    the backward reduce-scatters the gradient back to each rank's rows,
    summed over the ranks that used them."""

    @staticmethod
    def forward(ctx, x, mesh, entry):
        ctx.mesh, ctx.entry = mesh, entry
        return all_gather_axes(x, mesh, entry, 0)

    @staticmethod
    def backward(ctx, g):
        for a in entry_axes(ctx.entry):  # the major dim first: the gather's inverse
            g = reduce_scatter_axis(g, ctx.mesh, a, 0)
        return g, None, None


def gather_rows(x: torch.Tensor, mesh, entry) -> torch.Tensor:
    """:func:`all_gather_axes` along dim 0, with a backward."""
    return _GatherRows.apply(x, mesh, entry)


class _PMean(torch.autograd.Function):
    """The mean over the ranks of each of ``entry``'s mesh dims in turn (the
    reference's ``pmean``); its backward is the same mean of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, entry):
        ctx.mesh, ctx.entry = mesh, entry
        return _pmean(x, mesh, entry)

    @staticmethod
    def backward(ctx, g):
        return _pmean(g, ctx.mesh, ctx.entry), None, None


def _pmean(x, mesh, entry):
    import torch.distributed as dist

    x = x.clone()
    for a in entry_axes(entry):
        x = all_reduce_axes(x, mesh, a, dist.ReduceOp.SUM) / mesh_shape(mesh)[a]
    return x


def pmean(x: torch.Tensor, mesh, entry) -> torch.Tensor:
    return _PMean.apply(x, mesh, entry)
