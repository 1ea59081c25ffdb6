"""Gradient compression for the slow (between-pod) mesh dim.

int8 block quantization with **error feedback**: each step sends
quantize(g + e) and keeps e' = g + e − dequantize(...) locally, the EF-SGD
construction, which cuts the gradient bytes on the wire 4× (fp32 → int8
values, 2 B each in the sum).

:func:`compressed_psum` composes it with ``torch.distributed`` all-reduces
over a process group (the ``pod`` dim's, ``mesh.get_group("pod")``). It keeps
the reference's order of operations as its compiled form runs them, so its
results are the same bits: ``torch.round`` rounds half to even, as
``jnp.round`` does; XLA's CPU compiler turns the division of the block
maxima by 127 into a product with the float32 1/127, and fuses the error's
``corrected − q·scale`` into one rounding (a fused multiply-subtract), and
the port writes both out (:func:`_scales`, :func:`_residual`). No trainer
path uses it.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map

BLOCK = 256
# the summed int8 payload travels as two 16-bit lanes per int32 word (no
# backend sums int16): each lane holds q + 127 in [0, 254], so a lane's sum
# over n ranks stays under 2^16, and the high lane's under 2^15, up to
MAX_RANKS = 129


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.float().reshape(-1)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % BLOCK)])
    return flat.view(-1, BLOCK)


def _scales(blocks: torch.Tensor) -> torch.Tensor:
    inv127 = torch.ones((), dtype=torch.float32, device=blocks.device) / 127.0  # 1/127 rounded to float32
    scale = blocks.abs().amax(dim=1, keepdim=True) * inv127
    return torch.where(scale == 0, torch.ones_like(scale), scale)


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)


def _unblock(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def _residual(corrected: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """corrected − q·scale rounded once to float32: the product of an int8
    and a float32 is exact in float64, and so is the difference (its bits
    span at most ~40), so one rounding remains, as in a fused
    multiply-subtract."""
    n = corrected.numel()
    deq = (q.double() * scale.double()).reshape(-1)[:n].reshape(corrected.shape)
    return (corrected.double() - deq).float()


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. Returns (q int8 (blocks, 256), scale fp32
    (blocks, 1))."""
    blocks = _blocks(x)
    scale = _scales(blocks)
    return _quantize(blocks, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    return _unblock(q, scale, shape).to(dtype)


def ef_compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """Returns (q, scale, new_err)."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    return q, scale, _residual(corrected, q, scale)


def _sum_int8(q: torch.Tensor, group) -> torch.Tensor:
    """The exact sum of every rank's int8 ``q`` (blocks, 256) over ``group``,
    as int32, from a payload of 2 bytes per element."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n > MAX_RANKS:
        raise ValueError(f"compressed_psum sums exactly over at most {MAX_RANKS} ranks, not {n}")
    v = q.to(torch.int32) + 127
    packed = v[:, 0::2] | (v[:, 1::2] << 16)
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    lanes = torch.stack([packed & 0xFFFF, packed >> 16], dim=-1).view(q.shape)
    return lanes - 127 * n


def compressed_psum(grads, err_state, group):
    """EF-int8 sum of ``grads`` over ``group``; returns (summed, new_err).

    Per leaf: (1) the per-block scales' maximum over the ranks, so that all
    share one scale (4 B per 256 elements on the wire); (2) the EF-corrected
    gradient quantized to int8 against it; (3) the payloads summed exactly,
    2 B per element; (4) the sum dequantized, the local quantization error
    carried. Semantics: Σᵢ round((gᵢ + eᵢ)/s)·s with exact error feedback.
    """
    import torch.distributed as dist

    def leaf(g, e):
        corrected = g.float() + e
        blocks = _blocks(corrected)
        scale = _scales(blocks)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = _quantize(blocks, scale)
        return _unblock(_sum_int8(q, group), scale, g.shape), _residual(corrected, q, scale)

    out = tree_map(leaf, grads, err_state)
    is_pair = lambda t: isinstance(t, tuple) and len(t) == 2 and isinstance(t[0], torch.Tensor)  # noqa: E731
    return _pick(out, 0, is_pair), _pick(out, 1, is_pair)


def _pick(tree, i, is_pair):
    if is_pair(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i, is_pair) for k, v in tree.items()}
    return type(tree)(_pick(v, i, is_pair) for v in tree)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
