"""Model and shape-cell configuration: the port's own copy of ``ModelConfig``,
``ShapeCell`` and ``SHAPES``.

Field names, defaults and the derived properties are those of the reference
config, so a config built here describes the same model as the reference
config of the same name. The four shape cells are global; which of them an
arch runs follows from its family (:meth:`ModelConfig.shape_supported`).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


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

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / hybrid-local-attn only.)"""
        return self.family in ("ssm", "hybrid")

    def shape_supported(self, cell: ShapeCell) -> tuple[bool, str]:
        if cell.name == "long_500k" and not self.sub_quadratic:
            return False, "skip (full attention — no sub-quadratic path)"
        return True, ""

    def params_count(self) -> int:
        """Total parameter count (used for 6·N·D MODEL_FLOPS)."""
        hd = self.resolved_head_dim
        V = self.padded_vocab
        d = self.d_model
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        # attention
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        attn = q + kv + o
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            conv_dim = d_in + 2 * self.ssm_groups * self.ssm_state
            per_layer = (
                d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + nh)  # in_proj
                + conv_dim * self.conv_kernel
                + 3 * nh  # A_log, dt_bias, D
                + d_in  # norm
                + d_in * d  # out_proj
                + d  # pre-norm
            )
            return emb + self.n_layers * per_layer + d
        if self.family == "hybrid":
            w = self.rnn_width or d
            rec = d * w * 2 + w * self.conv_kernel + 2 * w * w // 1 + w * d + 3 * w
            # rec block: 2 in-proj, conv, rg-lru gates (2 * w*w), out proj
            att = attn
            ff = 3 * d * self.d_ff  # GeGLU
            n_rec = sum(1 for i in range(self.n_layers) if self._layer_kind(i) == "R")
            n_att = self.n_layers - n_rec
            per = n_rec * (rec + ff + 2 * d) + n_att * (att + ff + 2 * d)
            return emb + per + d
        ffm = 3 if self.activation in ("swiglu", "geglu") else 2
        ff = ffm * d * self.d_ff
        moe = 0
        if self.family == "moe":
            moe = self.n_experts * ffm * d * self.d_ff + d * self.n_experts
            if self.n_shared_experts:
                moe += ffm * d * self.d_ff * self.n_shared_experts
            ff = 0
        per_layer = attn + ff + moe + 2 * d
        total = emb + self.n_layers * per_layer + d
        if self.enc_dec:
            # encoder layers + cross-attention in decoder
            enc = self.enc_layers * (attn + ff + 2 * d)
            cross = self.n_layers * (attn + d)
            total += enc + cross
        return total

    def active_params_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.family != "moe":
            return self.params_count()
        d = self.d_model
        ffm = 3 if self.activation in ("swiglu", "geglu") else 2
        dense = self.params_count() - self.n_layers * (
            self.n_experts * ffm * d * self.d_ff
            + (ffm * d * self.d_ff * self.n_shared_experts if self.n_shared_experts else 0)
        )
        active_ff = self.n_layers * ffm * d * self.d_ff * (self.top_k + self.n_shared_experts)
        return dense + active_ff

    def _layer_kind(self, i: int) -> str:
        if not self.layer_pattern:
            return "A"
        return self.layer_pattern[i % len(self.layer_pattern)]

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
