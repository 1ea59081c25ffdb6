"""recurrentgemma-9b — RG-LRU + local attention, pattern (R,R,A).
[arXiv:2402.19427; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,  # MQA on the local-attention layers
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    layer_pattern="RRA",
    window=2048,
    rnn_width=4096,
    activation="geglu",
    rope_theta=10000.0,
    source="arXiv:2402.19427",
)
