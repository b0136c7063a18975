"""Llama-3.2-Vision 11B backbone [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]. Backbone only: the vision tower is a stub
that supplies precomputed patch embeddings; every 5th decoder layer
cross-attends to them. The same ``CONFIG``/``SMOKE`` pair as the reference
package's config.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama32_vision_11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128_256, rope_theta=5e5,
    cross_attn_every=5, n_image_tokens=1601,
)

SMOKE = ModelConfig(
    name="llama32_vision_smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=384, vocab=512, cross_attn_every=2, n_image_tokens=16,
)
