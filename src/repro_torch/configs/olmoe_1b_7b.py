"""AI2 OLMoE-1B-7B [arXiv:2409.02060; hf].

MoE decoder: 64 experts, top-8, per-expert d_ff=1024, MHA (16/16).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe_1b_7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50_304, moe_experts=64, moe_top_k=8,
)

SMOKE = ModelConfig(
    moe_capacity_factor=8.0,
    name="olmoe_smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=512, moe_experts=8, moe_top_k=2,
)
