"""The MoE decoder family (``model.family`` "moe": granite-moe, qwen2-moe):
pre-norm decoder blocks of GQA attention with RoPE and a routed top-k GLU
expert layer, optionally with shared experts and qkv biases. The reference
is :mod:`portbench.reference.model`."""
from __future__ import annotations

from portbench import flops
from portbench.reference import model as reference  # noqa: F401 (read as families.of(m).reference)
from portbench.weights import ZEROS, normal, padded_vocab

FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "vocab_pad_multiple",
          "n_experts", "top_k", "n_shared_experts", "capacity_factor", "router_aux_coef",
          "tie_embeddings", "attention_bias", "qk_norm", "rope_theta", "rms_eps", "activation", "dtype", "head_dim")
ATTRS = {"head_dim": "resolved_head_dim"}
FIXED = {"family": "moe", "norm_type": "rmsnorm", "parallel_block": False, "use_rope": True, "pos_emb": "none"}


def leaf_specs(m: dict) -> list:
    """The MoE decoder's parameters: matrices a normal of std fan_in^-½,
    norm scales and biases zero."""
    d, L, H, K, hd = m["d_model"], m["n_layers"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    E, ff, V = m["n_experts"], m["d_ff"], padded_vocab(m)
    specs = [("embed", (V, d), normal(d**-0.5)), ("ln1", (L, d), ZEROS), ("ln_f", (d,), ZEROS),
             ("attn.wq", (L, d, H * hd), normal(d**-0.5)), ("attn.wk", (L, d, K * hd), normal(d**-0.5)),
             ("attn.wv", (L, d, K * hd), normal(d**-0.5)), ("attn.wo", (L, H * hd, d), normal((H * hd) ** -0.5))]
    if m["attention_bias"]:
        specs += [("attn.bq", (L, H * hd), ZEROS), ("attn.bk", (L, K * hd), ZEROS), ("attn.bv", (L, K * hd), ZEROS)]
    specs += [("ln2", (L, d), ZEROS), ("moe.router", (L, d, E), normal(d**-0.5)),
              ("moe.we_gate", (L, E, d, ff), normal(d**-0.5)), ("moe.we_up", (L, E, d, ff), normal(d**-0.5)),
              ("moe.we_down", (L, E, ff, d), normal(ff**-0.5))]
    if m["n_shared_experts"]:
        fs = m["n_shared_experts"] * ff
        specs += [("moe.ws_gate", (L, d, fs), normal(d**-0.5)), ("moe.ws_up", (L, d, fs), normal(d**-0.5)),
                  ("moe.ws_down", (L, fs, d), normal(fs**-0.5)), ("moe.ws_gate_scalar", (L, d), normal(d**-0.5))]
    if not m["tie_embeddings"]:
        specs.append(("out_embed", (V, d), normal(d**-0.5)))
    return specs


def flops_per_token(m: dict, T: int) -> float:
    return flops.train_flops_per_token(m, T)


def flash_shape(q, k, v, *, causal=True, window=None) -> tuple:
    """A flash call's arguments to ``portbench.flops.flash_bound_s``."""
    if window is not None:
        raise ValueError("the flash bound counts full causal or non-causal calls only")
    B, T, H, hd = q.shape
    return (B, T, k.shape[1], H, k.shape[2], hd, bool(causal), q.element_size())


def targets() -> dict:
    """The MoE FFN's forward (and its recompute), the attention's backward in
    torch ops, and the flash kernel's calls with their shapes."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    return {"moe_ffn": (transformer, "moe_ffn"), "attention_backward": (ops, "attention_backward"),
            "flash_attention": (ops, "flash_attention", flash_shape)}
