"""Model configuration: the port's own copy of the reference ``ModelConfig``.

The fields, their defaults and the derived properties are those of
``repro/models/config.py``, so a configuration reads the same in both
packages and ``dataclasses.replace`` works on either. Heterogeneous layer
patterns (hybrid SSM/attention, periodic cross-attention, periodic MoE) are
expressed as a repeating *block pattern*; the port's model stacks a list of
blocks where the reference scans over stacked arrays.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1           # a layer is MoE iff (idx % moe_every == moe_offset)
    moe_offset: int = 0
    moe_capacity_factor: float = 1.25

    # hybrid / SSM (Mamba2/SSD)
    attn_every: int = 0          # 0: all layers attend; k>0: 1 attn per k layers
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # VLM cross-attention
    cross_attn_every: int = 0    # k>0: layers with idx % k == k-1 cross-attend
    n_image_tokens: int = 0

    # encoder-decoder
    encoder_layers: int = 0      # >0 → enc-dec; decoder gets cross-attn
    n_audio_frames: int = 0      # stub frontend sequence length

    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparam_ln
    gated: bool = True           # SwiGLU vs plain GELU MLP
    qkv_bias: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- execution knobs of the reference's multi-device path; kept so that
    # a configuration carries over field for field ---------------------------
    remat: str = "full"
    moe_dispatch: str = "gspmd"
    param_dtype: str = "float32"
    decode_attn: str = "gspmd"
    matmul_out: str = "f32"

    # --- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.attn_every < 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def block_size(self) -> int:
        """Layers per repeated heterogeneous block (lcm of the patterns)."""
        b = 1
        if self.attn_every > 0:
            b = math.lcm(b, self.attn_every)
        if self.cross_attn_every > 0:
            b = math.lcm(b, self.cross_attn_every)
        if self.moe_experts and self.moe_every > 1:
            b = math.lcm(b, self.moe_every)
        return b

    @property
    def n_blocks(self) -> int:
        if self.n_layers % self.block_size:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not divisible by "
                f"block pattern {self.block_size}")
        return self.n_layers // self.block_size

    def layer_kind(self, idx: int) -> str:
        """'attn' | 'ssm' for layer ``idx`` within a block."""
        if self.attention_free:
            return "ssm"
        if self.attn_every > 0:
            # one attention layer per attn_every, at the middle slot
            return "attn" if idx % self.attn_every == self.attn_every // 2 else "ssm"
        return "attn"

    def layer_is_moe(self, idx: int) -> bool:
        return bool(self.moe_experts) and idx % self.moe_every == self.moe_offset

    def layer_is_cross(self, idx: int) -> bool:
        return (self.cross_attn_every > 0
                and idx % self.cross_attn_every == self.cross_attn_every - 1)

    # --- parameter counts (for roofline MODEL_FLOPS) -------------------------
    def param_count(self, active_only: bool = False) -> float:
        d, hd = self.d_model, self.hd
        total = 0.0
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                total += self.n_heads * hd * d
                if self.layer_is_cross(i):
                    total += 2 * (d * self.n_heads * hd) + 2 * d * self.n_kv_heads * hd
            else:
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                total += d * (2 * d_in + 2 * self.ssm_state + nheads)
                total += d_in * self.ssm_conv + d_in * d
            if self.d_ff:
                n_mats = 3 if self.gated else 2
                if self.layer_is_moe(i):
                    e = self.moe_top_k if active_only else self.moe_experts
                    total += e * n_mats * d * self.d_ff + d * self.moe_experts
                else:
                    total += n_mats * d * self.d_ff
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.is_enc_dec:
            # encoder layers: self-attn + FFN at the same width
            total += self.encoder_layers * (
                d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d
                + (3 if self.gated else 2) * d * self.d_ff)
        return total

    def model_flops(self, tokens: float, training: bool = True,
                    decode_kv: int = 0) -> float:
        """6·N·D (training) or 2·N·D (inference) with N = active params.

        ``decode_kv`` adds the attention KV-cache FLOPs (4·kv·d_attn per
        token per attn layer), which 6·N·D omits."""
        n = self.param_count(active_only=True)
        base = (6.0 if training else 2.0) * n * tokens
        if decode_kv:
            n_attn = sum(1 for i in range(self.n_layers)
                         if self.layer_kind(i) == "attn")
            base += (4.0 * decode_kv * self.n_heads * self.hd
                     * n_attn * tokens) * (3.0 if training else 1.0)
        return base
