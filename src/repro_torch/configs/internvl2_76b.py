"""internvl2-76b — InternViT (stubbed frontend) + InternLM2-style backbone.
[arXiv:2404.16821; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    n_vision_patches=256,  # stub: input_specs() provides patch embeddings
    rope_theta=1000000.0,
    rms_eps=1e-5,
    source="arXiv:2404.16821",
)
