"""Mamba2-130M — SSD (state-space duality) [arXiv:2405.21060; unverified].

Pure SSM: attention-free, 24 layers, d_model 768, ssm_state 128; no FFN
(d_ff=0) — the Mamba block is the whole layer.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_130m", family="ssm",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=0, vocab=50_280, attn_every=-1,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2_smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=512, attn_every=-1,
    ssm_state=32, ssm_expand=2, ssm_head_dim=32,
    tie_embeddings=True,
)
