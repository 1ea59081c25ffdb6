"""qwen3-4b — dense GQA with qk-norm. [hf:Qwen/Qwen3-4B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-4B",
)
