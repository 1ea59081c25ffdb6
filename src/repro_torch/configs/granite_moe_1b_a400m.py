"""granite-moe-1b-a400m — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,  # per-expert FF width
    vocab=49155,  # NOT 16-divisible — padded via vocab_pad_multiple
    head_dim=64,
    n_experts=32,
    top_k=8,
    tie_embeddings=True,
    rope_theta=10000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
