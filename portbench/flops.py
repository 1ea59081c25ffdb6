"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a
training step (the MoE decoder's; Mamba-2's, below), and the least time of a
flash-attention call and of a forward SSD call.

These formulas are the benchmark's own and frozen here. The program counts
its kernels' work too (``repro_torch/kernels/cost.py``), but a later change
to the program may change that count; it cannot change this one.

A configuration's ``model`` block (``portbench/configs/<name>.json``) gives
the sizes in the port's field names; the MoE decoder's are ``n_layers``,
``d_model``, ``n_heads``, ``n_kv_heads``, ``head_dim``, ``d_ff`` (one routed
expert's width), ``vocab``, ``n_experts``, ``top_k``, ``n_shared_experts``,
``activation``.
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
    return bound_s(*flash_cost(B, T, S, H, K, hd, causal, elem_bytes), elem_bytes)


def bound_s(flops: int, nbytes: int, elem_bytes: int) -> float:
    """The larger of the bytes over HBM bandwidth and the FLOPs over the bf16
    (or, for 4-byte inputs, fp32) peak."""
    peak = PEAKS["bf16_flops_per_s"] if elem_bytes == 2 else PEAKS["fp32_flops_per_s"]
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / peak)


# Mamba-2 (``model.family`` "ssm"). The ``model`` block gives ``d_model``,
# ``n_layers``, ``vocab``, ``ssm_expand``, ``ssm_head_dim``, ``ssm_state``,
# ``ssm_groups`` and ``ssm_chunk``.

def mamba2_dims(m: dict) -> tuple[int, int, int]:
    """(d_in, heads, in_proj's outputs) of one Mamba-2 block: d_in =
    expand·d, heads of ``ssm_head_dim``, in_proj to z, x, B, C and dt."""
    d_in = m["ssm_expand"] * m["d_model"]
    nh = d_in // m["ssm_head_dim"]
    return d_in, nh, 2 * d_in + 2 * m["ssm_groups"] * m["ssm_state"] + nh


def mamba2_matmul_params(m: dict) -> int:
    """The weights one token multiplies by: each layer's in_proj and out_proj
    and the LM head over the real vocabulary (the conv, norms and SSD
    parameters are no products)."""
    d = m["d_model"]
    d_in, _, proj = mamba2_dims(m)
    return m["n_layers"] * (d * proj + d_in * d) + m["vocab"] * d


def ssd_chunk_lengths(T: int, chunk: int) -> list[int]:
    """The chunks of a length-T row at the configuration's chunk (the whole
    row where it is shorter), the last one ragged."""
    c = min(chunk, T)
    return [c] * (T // c) + ([T % c] if T % c else [])


def ssd_row_flops(h: int, p: int, g: int, n: int, T: int, chunk: int) -> int:
    """The forward SSD's products over one length-T row of one layer: in each
    chunk of l positions the causal C·Bᵀ once per group (2·n a pair over
    l(l+1)/2 pairs), then per head the scores times x (2·p a pair), the chunk
    state Bᵀ·x and the output C·H_in (2·l·p·n each)."""
    return sum(g * 2 * causal_pairs(l) * n + h * (2 * causal_pairs(l) * p + 4 * l * p * n)
               for l in ssd_chunk_lengths(T, chunk))


def ssd_flops_per_token(m: dict, T: int) -> float:
    """:func:`ssd_row_flops` per token of a length-T row, over every layer."""
    _, h, _ = mamba2_dims(m)
    return m["n_layers"] * ssd_row_flops(h, m["ssm_head_dim"], m["ssm_groups"], m["ssm_state"], T,
                                         m["ssm_chunk"]) / T


def mamba2_train_flops_per_token(m: dict, T: int) -> float:
    """A Mamba-2 training token's model FLOPs: 6 × the matmul parameters plus
    3 × the forward SSD's products. Recompute is not counted."""
    return 6 * mamba2_matmul_params(m) + 3 * ssd_flops_per_token(m, T)


F32 = 4  # dA and the final state are fp32 whatever x's dtype


def ssd_scan_cost(b: int, t: int, h: int, p: int, g: int, n: int, chunk: int, elem_bytes: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward SSD call, ``ops.ssd_scan(x, dA, B, C)``
    → (y, final state), as a function and not as the kernels that compute
    it: the products of :func:`ssd_row_flops` over its ``b`` rows; x
    (b,t,h,p), B and C (b,t,g,n) in x's dtype and dA (b,t,h) fp32 read once,
    y (b,t,h,p) in x's dtype and the final state (b,h,p,n) fp32 written once.
    What the kernels keep between them (the chunk states, the diagonal
    blocks' output) is the implementation's choice and is not counted."""
    flops = b * ssd_row_flops(h, p, g, n, t, chunk)
    nbytes = (2 * b * t * h * p + 2 * b * t * g * n) * elem_bytes + F32 * (b * t * h + b * h * p * n)
    return flops, nbytes


def ssd_scan_bound_s(b: int, t: int, h: int, p: int, g: int, n: int, chunk: int, elem_bytes: int) -> float:
    """The least time of one forward SSD call (:func:`ssd_scan_cost`)."""
    return bound_s(*ssd_scan_cost(b, t, h, p, g, n, chunk, elem_bytes), elem_bytes)
