"""The model's weights, drawn from the seed by the benchmark and handed alike
to the program and to the plain reference.

Each leaf is a stacked tensor with the port's name and shape (``attn.wq``
is ``(L, d, H·hd)``). Leaf i is drawn on the device by a generator of its
own, seeded from ``(seed, i)``, in one ``normal_`` call, so any leaf can be
drawn again alone and gives the same bits on the same device. Matrices get
a normal of std fan_in^-½; norm scales (which multiply by ``1 + scale``)
and biases start at zero; the vocabulary's padding rows are zero.
"""
from __future__ import annotations

import torch


def padded_vocab(m: dict) -> int:
    p = m.get("vocab_pad_multiple", 1)
    return -(-m["vocab"] // p) * p


def leaf_specs(m: dict) -> list[tuple[str, tuple, float]]:
    """[(name, shape, std)] of the MoE decoder's parameters, in draw order
    (std 0: zeros)."""
    d, L, H, K, hd = m["d_model"], m["n_layers"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    E, ff, V = m["n_experts"], m["d_ff"], padded_vocab(m)
    specs = [("embed", (V, d), d**-0.5), ("ln1", (L, d), 0.0), ("ln_f", (d,), 0.0),
             ("attn.wq", (L, d, H * hd), d**-0.5), ("attn.wk", (L, d, K * hd), d**-0.5),
             ("attn.wv", (L, d, K * hd), d**-0.5), ("attn.wo", (L, H * hd, d), (H * hd) ** -0.5)]
    if m["attention_bias"]:
        specs += [("attn.bq", (L, H * hd), 0.0), ("attn.bk", (L, K * hd), 0.0), ("attn.bv", (L, K * hd), 0.0)]
    specs += [("ln2", (L, d), 0.0), ("moe.router", (L, d, E), d**-0.5),
              ("moe.we_gate", (L, E, d, ff), d**-0.5), ("moe.we_up", (L, E, d, ff), d**-0.5),
              ("moe.we_down", (L, E, ff, d), ff**-0.5)]
    if m["n_shared_experts"]:
        fs = m["n_shared_experts"] * ff
        specs += [("moe.ws_gate", (L, d, fs), d**-0.5), ("moe.ws_up", (L, d, fs), d**-0.5),
                  ("moe.ws_down", (L, fs, d), fs**-0.5), ("moe.ws_gate_scalar", (L, d), d**-0.5)]
    if not m["tie_embeddings"]:
        specs.append(("out_embed", (V, d), d**-0.5))
    return specs


def leaf_seed(seed: int, index: int) -> int:
    """Leaf ``index``'s generator seed: a non-negative 63-bit mix of both."""
    return (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) % (2**63 - 1)


@torch.no_grad()
def fill_(t: torch.Tensor, m: dict, seed: int, index: int) -> torch.Tensor:
    """Leaf ``index`` of :func:`leaf_specs` drawn into ``t`` (fp32, on its
    device) in place."""
    name, shape, std = leaf_specs(m)[index]
    if tuple(t.shape) != shape:
        raise ValueError(f"leaf {name}: shape {tuple(t.shape)}, the configuration's {shape}")
    if std == 0.0:
        return t.zero_()
    t.normal_(0.0, std, generator=torch.Generator(device=t.device).manual_seed(leaf_seed(seed, index)))
    if name in ("embed", "out_embed"):
        t[m["vocab"]:] = 0
    return t


def draw(m: dict, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` as a new fp32 tensor on ``device``."""
    return fill_(torch.empty(leaf_specs(m)[index][1], dtype=torch.float32, device=device), m, seed, index)
