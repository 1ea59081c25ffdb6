"""The reference's training steps, plain PyTorch: gradients accumulated over
the microbatches and divided by their number, clipping by the global norm,
AdamW (decoupled weight decay on every leaf of two or more dims, as the
stacked leaves are stored, norms included), a linear warm-up and a cosine
schedule, as the traffic mix's ``optimizer`` block states them.

:func:`follow` runs the first steps from the benchmark's weights and
batches and returns what the program's first steps are held to.
"""
from __future__ import annotations

import math

import torch


WHOLE = ("embed", "out_embed", "ln_f")  # leaves that are not stacked by layer


def pieces(name: str, t: torch.Tensor):
    """The leaves that stand for the stacked tensor ``t``: for an ``(L, …)``
    leaf, its layers, views of it that are leaves of their own and require
    grad, so that an update of a piece is an update of ``t``; otherwise
    ``t`` itself."""
    if name in WHOLE:
        return t.requires_grad_(True)
    return [t[l].detach().requires_grad_(True) for l in range(t.shape[0])]


def unit_on_host(name: str, t: torch.Tensor) -> list[torch.Tensor]:
    """The leaf ``t`` over its norm, in fp32 on the host, cut into the
    reference's pieces of leaf ``name`` (a zero leaf stays zero): a
    gradient's direction, to be held against the reference's
    (:func:`follow`'s ``against``)."""
    return _on_host([t] if name in WHOLE else list(t.unbind(0)), float(torch.linalg.vector_norm(t)))


def _on_host(parts: list[torch.Tensor], n: float) -> list[torch.Tensor]:
    hs = [x.detach().to("cpu", torch.float32, copy=True) for x in parts]
    return [h.div_(n) for h in hs] if n > 0 else hs


def _direction_gap(grads: list[torch.Tensor], gnorm: float, units: list[torch.Tensor]) -> float:
    """½‖g/‖g‖ − u‖² over a leaf's pieces: 1 − cos of the angle between the
    reference's gradient g and the unit direction u (0 alike, 1 at right
    angles), without the cancellation of 1 − cos itself."""
    total = 0.0
    for g, u in zip(grads, units, strict=True):
        d = u.to(g.device, copy=True)
        if gnorm > 0:
            d.sub_(g, alpha=1 / gnorm)
        total += float(torch.linalg.vector_norm(d)) ** 2
    return 0.5 * total


def flat(x) -> list[torch.Tensor]:
    return [y for z in x for y in flat(z)] if isinstance(x, list) else [x]


def lr_at(opt: dict, count: int) -> float:
    """The rate of step ``count`` (1, 2, …): linear warm-up, then a cosine to
    ``min_lr_ratio`` of the peak."""
    if count < opt["warmup_steps"]:
        return opt["lr"] * count / max(opt["warmup_steps"], 1)
    prog = min(max((count - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


def norm(ts: list[torch.Tensor]) -> float:
    """√(Σ‖t‖²) over the tensors, read from the device once."""
    return float(torch.stack([torch.linalg.vector_norm(t) for t in ts]).square().sum().sqrt())


@torch.no_grad()
def adamw_(leaves: dict, opt: dict, count: int) -> None:
    """One AdamW step over every leaf's pieces in place."""
    lr = lr_at(opt, count)
    bc1, bc2 = 1 - opt["b1"] ** count, 1 - opt["b2"] ** count
    for leaf in leaves.values():
        for p, m, v in zip(leaf["pieces"], leaf["m"], leaf["v"]):
            g = p.grad
            m.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
            v.mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
            step = (m / bc1) / ((v / bc2).sqrt() + opt["eps"])
            if leaf["decays"]:
                step.add_(p, alpha=opt["weight_decay"])
            p.sub_(step, alpha=lr)


def follow(m: dict, traffic: dict, initial, batches: list[dict], device, precision: str = "fp32",
           against: dict | None = None, keep_first: bool = False) -> dict:
    """The reference's first ``len(batches)`` steps.

    ``initial(i)`` draws leaf i of ``portbench.weights.leaf_specs`` (the
    benchmark's weights, as the program was given them); the loss is the
    reference of the model block's family (``portbench/families``:
    :mod:`.model`, :mod:`.mamba2`); ``batches`` are the
    steps' tokens and labels (numpy, as the generator made them). Returns
    ``loss`` and ``grad_norm`` (before clipping) per step, ``first_grad``:
    each leaf's norm of the clipped gradient of step 1, and ``change``: each
    leaf's norm of its parameters' change after the last step. With
    ``against`` (leaf → :func:`unit_on_host` of another side's step-1
    gradient), ``first_dir``: each leaf's :func:`_direction_gap` from it; with
    ``keep_first``, ``first_unit``: this side's own, for another reference's
    ``against``."""
    from portbench import families
    from portbench.weights import leaf_specs

    model = families.of(m).reference
    opt, A = traffic["optimizer"], traffic["microbatches"]
    specs = leaf_specs(m)
    p, leaves = {}, {}
    for i, (name, shape, _) in enumerate(specs):
        t = initial(i)
        p[name] = pieces(name, t)
        ps = flat(p[name])
        leaves[name] = {"full": t, "pieces": ps, "decays": len(shape) >= 2,
                        "m": [torch.zeros_like(x) for x in ps], "v": [torch.zeros_like(x) for x in ps]}
    out = {"loss": [], "grad_norm": [], "first_grad": {}, "change": {}}
    for count, b in enumerate(batches, start=1):
        tokens = torch.from_numpy(b["tokens"]).to(device)
        labels = torch.from_numpy(b["labels"]).to(device)
        n = tokens.shape[0] // A
        for leaf in leaves.values():  # zero in place: a piece no token reaches has a zero gradient
            for x in leaf["pieces"]:
                if x.grad is None:
                    x.grad = torch.zeros_like(x)
                else:
                    x.grad.zero_()
        total = 0.0
        for i in range(A):
            loss = model.loss(p, tokens[i * n:(i + 1) * n], labels[i * n:(i + 1) * n], m, precision)
            loss.backward()
            total += float(loss.detach())
        grads = [x.grad for leaf in leaves.values() for x in leaf["pieces"]]
        with torch.no_grad():
            for g in grads:
                g.div_(A)
            gnorm = norm(grads)
            scale = min(opt["grad_clip"] / (gnorm + 1e-9), 1.0)
            for g in grads:
                g.mul_(scale)
        out["loss"].append(total / A)
        out["grad_norm"].append(gnorm)
        if count == 1:
            out["first_grad"] = {name: norm([x.grad for x in leaf["pieces"]]) for name, leaf in leaves.items()}
            with torch.no_grad():
                if against is not None:
                    out["first_dir"] = {name: _direction_gap([x.grad for x in leaf["pieces"]], out["first_grad"][name],
                                                             against[name]) for name, leaf in leaves.items()}
                if keep_first:
                    out["first_unit"] = {name: _on_host([x.grad for x in leaf["pieces"]], out["first_grad"][name])
                                         for name, leaf in leaves.items()}
        adamw_(leaves, opt, count)
    del grads
    for leaf in leaves.values():
        for x in leaf["pieces"]:
            x.grad = None
        leaf["m"] = leaf["v"] = None
    with torch.no_grad():
        for i, (name, _, _) in enumerate(specs):
            out["change"][name] = float(torch.linalg.vector_norm(initial(i).sub_(leaves[name]["full"])))
    return out
