"""Meta SeamlessM4T-medium backbone [arXiv:2308.11596; hf].

Encoder–decoder; the speech frontend is a STUB supplying precomputed frame
embeddings. 12 encoder + 12 decoder layers, MHA 16/16,
every decoder layer cross-attends to the encoder memory. The same
``CONFIG``/``SMOKE`` pair as the reference package's config.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256_206, norm="layernorm", gated=False,
    encoder_layers=12, cross_attn_every=1, n_audio_frames=1024,
)

SMOKE = ModelConfig(
    name="seamless_smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, norm="layernorm", gated=False,
    encoder_layers=2, cross_attn_every=1, n_audio_frames=32,
)
