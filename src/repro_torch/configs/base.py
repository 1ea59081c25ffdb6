"""Model configuration: the port's own copy of ``ModelConfig``.

Field names, defaults and the derived properties are those of the reference
config, so a config built here describes the same model as the reference
config of the same name.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # attention details
    head_dim: int = 0  # 0 → d_model // n_heads
    qk_norm: bool = False
    parallel_block: bool = False  # attn + FFN in parallel (command-r)
    attention_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # enc-dec (whisper)
    enc_dec: bool = False
    enc_layers: int = 0
    enc_len: int = 1500
    # vlm
    n_vision_patches: int = 0
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    ssm_groups: int = 1
    # hybrid (recurrentgemma)
    layer_pattern: str = ""
    window: int = 2048
    rnn_width: int = 0
    # block details
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | geglu | gelu
    use_rope: bool = True
    pos_emb: str = "none"  # none | learned
    # numerics / padding
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    # source provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's cut)."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.layer_pattern else 3),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab=256,
            head_dim=min(self.resolved_head_dim, 16),
            vocab_pad_multiple=32,
        )
        if self.family == "moe":
            kw.update(n_experts=min(self.n_experts, 4), top_k=min(self.top_k, 2), d_ff=32)
        if self.family == "ssm":
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.family == "hybrid":
            kw.update(rnn_width=64, window=32)
        if self.enc_dec:
            kw.update(enc_layers=2, enc_len=16)
        if self.n_vision_patches:
            kw.update(n_vision_patches=4)
        kw.update(overrides)
        return replace(self, **kw)
