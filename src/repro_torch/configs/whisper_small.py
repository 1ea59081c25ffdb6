"""whisper-small — encoder-decoder; conv frontend stubbed (precomputed
frame embeddings). [arXiv:2212.04356; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,  # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    attention_bias=True,
    enc_dec=True,
    enc_layers=12,
    enc_len=1500,
    norm_type="layernorm",
    activation="gelu",
    use_rope=False,
    pos_emb="learned",
    source="arXiv:2212.04356",
)
