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


def no_autograd(name: str, *tensors) -> None:
    """The explicit paths run forward only: their gradient needs the
    trainer under a mesh, which the port does not have yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the explicit-collective path has no backward; run it under torch.no_grad()")


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
