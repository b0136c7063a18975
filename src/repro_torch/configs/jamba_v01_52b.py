"""AI21 Jamba-v0.1 52B [arXiv:2403.19887; hf].

Hybrid: 1 attention layer per 8 (7 Mamba : 1 attn), MoE 16 experts top-2 on
every other layer, GQA 32 q / 8 kv. The same ``CONFIG``/``SMOKE`` pair as
the reference package's config.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba_v01_52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65_536,
    moe_experts=16, moe_top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, ssm_state=16, ssm_expand=2, ssm_head_dim=64,
)

SMOKE = ModelConfig(
    moe_capacity_factor=8.0,
    name="jamba_smoke", family="hybrid",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512,
    moe_experts=4, moe_top_k=2, moe_every=2, moe_offset=1,
    attn_every=2, ssm_state=16, ssm_expand=2, ssm_head_dim=32,
)
