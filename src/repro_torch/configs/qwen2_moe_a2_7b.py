"""qwen2-moe-a2.7b — 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per routed expert
    vocab=151936,
    head_dim=128,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,  # shared FFN width = 4 * 1408 = 5632
    attention_bias=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
