"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407; hf].

Dense decoder, GQA (32 q / 8 kv), 128k context, head_dim 128 (d_model 5120).
The same ``CONFIG``/``SMOKE`` pair as the reference package's config.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral_nemo_12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131_072, head_dim=128, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mistral_nemo_smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=384, vocab=512, head_dim=32,
)
