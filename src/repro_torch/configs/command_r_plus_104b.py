"""command-r-plus-104b — dense GQA decoder.
[hf:CohereForAI/c4ai-command-r-v01 family; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    head_dim=128,
    parallel_block=True,  # Cohere parallel attn+FFN residual block
    attention_bias=False,
    tie_embeddings=True,
    rope_theta=75e6,
    norm_type="layernorm",  # Cohere uses LayerNorm (no bias)
    activation="swiglu",
    source="hf:CohereForAI/c4ai-command-r-plus",
)
