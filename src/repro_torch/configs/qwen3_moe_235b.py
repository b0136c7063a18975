"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf].

MoE decoder: 94 layers, 128 experts top-8, per-expert d_ff=1536,
GQA 64 q / 4 kv heads, head_dim 128.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_moe_235b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151_936, head_dim=128,
    moe_experts=128, moe_top_k=8, rope_theta=1e6,
)

SMOKE = ModelConfig(
    moe_capacity_factor=8.0,
    name="qwen3_moe_smoke", family="moe",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=64, vocab=512, head_dim=16, moe_experts=8, moe_top_k=2,
)
