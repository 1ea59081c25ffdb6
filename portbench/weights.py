"""The model's weights, drawn from the seed by the benchmark and handed alike
to the program and to the plain reference.

Each leaf is a stacked tensor with the port's name and shape (``attn.wq``
is ``(L, d, H·hd)``); its family (``portbench/families``) lists the leaves
with an initialiser each (:class:`Init`). A leaf that draws is drawn on the
device by a generator of its own, seeded from ``(seed, i)``, so any leaf can
be drawn again alone and gives the same bits on the same device. Matrices
get a normal of std fan_in^-½ in one ``normal_`` call; norm scales (which
multiply by ``1 + scale``) and biases start at zero; a leaf with a
published initial value (Mamba-2's ``A_log``, ``dt_bias``, ``D``) gets that
value; the vocabulary's padding rows are zero.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Init(NamedTuple):
    """How a leaf starts: ``fill(t, generator)`` writes it into ``t`` in
    place; ``seeded``: it draws from the leaf's generator (otherwise
    ``generator`` is None and every seed gives the same value); ``std``: a
    normal's std (0 for any other kind)."""

    fill: Callable[[torch.Tensor, torch.Generator | None], torch.Tensor]
    seeded: bool
    std: float = 0.0


ZEROS = Init(lambda t, g: t.zero_(), False)


def normal(std: float) -> Init:
    """A normal of ``std`` about 0."""
    return Init(lambda t, g: t.normal_(0.0, std, generator=g), True, std)


def constant(value: float) -> Init:
    return Init(lambda t, g: t.fill_(value), False)


def padded_vocab(m: dict) -> int:
    p = m.get("vocab_pad_multiple", 1)
    return -(-m["vocab"] // p) * p


def leaf_specs(m: dict) -> list[tuple[str, tuple, Init]]:
    """[(name, shape, init)] of the model's parameters, in draw order."""
    from portbench import families

    return families.of(m).leaf_specs(m)


def leaf_seed(seed: int, index: int) -> int:
    """Leaf ``index``'s generator seed: a non-negative 63-bit mix of both."""
    return (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) % (2**63 - 1)


@torch.no_grad()
def fill_(t: torch.Tensor, m: dict, seed: int, index: int) -> torch.Tensor:
    """Leaf ``index`` of :func:`leaf_specs` drawn into ``t`` (fp32, on its
    device) in place."""
    name, shape, init = leaf_specs(m)[index]
    if tuple(t.shape) != shape:
        raise ValueError(f"leaf {name}: shape {tuple(t.shape)}, the configuration's {shape}")
    gen = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, index)) if init.seeded else None
    init.fill(t, gen)
    if name in ("embed", "out_embed"):
        t[m["vocab"]:] = 0
    return t


def draw(m: dict, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` as a new fp32 tensor on ``device``."""
    return fill_(torch.empty(leaf_specs(m)[index][1], dtype=torch.float32, device=device), m, seed, index)
