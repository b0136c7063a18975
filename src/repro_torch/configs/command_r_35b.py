"""Cohere Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified].

Dense decoder, GQA (64 q heads / 8 kv), no biases, large 256k vocab.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command_r_35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256_000, norm="layernorm", gated=True,
    rope_theta=8e6,
)

SMOKE = ModelConfig(
    name="command_r_smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=352, vocab=512, norm="layernorm", gated=True,
)
