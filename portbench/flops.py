"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a
training step, and a flash-attention call's least time.

These formulas are the benchmark's own and frozen here. The program counts
its kernels' work too (``repro_torch/kernels/cost.py``), but a later change
to the program may change that count; it cannot change this one.

A configuration's ``model`` block (``portbench/configs/<name>.json``) gives
the sizes in the port's field names: ``n_layers``, ``d_model``, ``n_heads``,
``n_kv_heads``, ``head_dim``, ``d_ff`` (one routed expert's width),
``vocab``, ``n_experts``, ``top_k``, ``n_shared_experts``, ``activation``.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at its 700 W limit.
PEAKS = {
    "bf16_flops_per_s": 989e12,
    "fp32_flops_per_s": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}


def glu_mats(m: dict) -> int:
    """Matrices in one FFN: gate, up and down for a GLU, up and down otherwise."""
    return 3 if m["activation"] in ("swiglu", "geglu") else 2


def matmul_params_per_layer(m: dict) -> int:
    """The weights one token multiplies by in one layer: the attention
    projections, the router, its top-k routed experts and the shared
    experts with their scalar gate. Biases and norms are not products."""
    d, H, K, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = d * H * hd + 2 * d * K * hd + H * hd * d
    ffn = glu_mats(m) * d * m["d_ff"]
    if not m.get("n_experts"):
        return attn + ffn
    moe = d * m["n_experts"] + m["top_k"] * ffn
    if m.get("n_shared_experts"):
        moe += m["n_shared_experts"] * ffn + d
    return attn + moe


def active_matmul_params(m: dict) -> int:
    """Every layer's :func:`matmul_params_per_layer` and the LM head over the
    real vocabulary (tied or not, counted once); the input embedding is a
    lookup, not a product."""
    return m["n_layers"] * matmul_params_per_layer(m) + m["vocab"] * m["d_model"]


def causal_pairs(T: int) -> int:
    """(query, key) pairs a causal mask keeps over T positions."""
    return T * (T + 1) // 2


def attention_flops_per_token(m: dict, T: int) -> float:
    """The forward's QKᵀ and PV over the causal pairs of a length-T
    sequence, per token: 4·hd·H·T(T+1)/2 / T a layer."""
    return m["n_layers"] * 4 * m["head_dim"] * m["n_heads"] * causal_pairs(T) / T


def train_flops_per_token(m: dict, T: int) -> float:
    """A training token's model FLOPs: 6 × the active matmul parameters
    (forward 2, backward 4) plus 3 × the forward's attention products.
    Recompute (remat) is work the implementation chooses and is not
    counted."""
    return 6 * active_matmul_params(m) + 3 * attention_flops_per_token(m, T)


def flash_cost(B: int, T: int, S: int, H: int, K: int, hd: int, causal: bool, elem_bytes: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one flash-attention forward call: QKᵀ and PV over the
    kept pairs; q, k and v read once and the output written once."""
    pairs = causal_pairs(T) if causal and S == T else T * S
    if causal and S != T:
        raise ValueError("a causal call with S != T is not a shape the training cells run")
    flops = 4 * hd * H * B * pairs
    nbytes = (2 * B * T * H * hd + 2 * B * S * K * hd) * elem_bytes
    return flops, nbytes


def flash_bound_s(B: int, T: int, S: int, H: int, K: int, hd: int, causal: bool, elem_bytes: int) -> float:
    """The least time the card could take for the call: the larger of its
    bytes over HBM bandwidth and its FLOPs over the bf16 (or fp32) peak."""
    flops, nbytes = flash_cost(B, T, S, H, K, hd, causal, elem_bytes)
    peak = PEAKS["bf16_flops_per_s"] if elem_bytes == 2 else PEAKS["fp32_flops_per_s"]
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / peak)
