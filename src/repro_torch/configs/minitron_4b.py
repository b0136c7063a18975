"""NVIDIA Minitron-4B — pruned Nemotron [arXiv:2407.14679; hf].

Dense decoder, GQA (24 q / 8 kv), huge-vocab (256k) distillation target.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron_4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab=256_000, norm="layernorm", gated=False,
)

SMOKE = ModelConfig(
    name="minitron_smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=288, vocab=512, norm="layernorm", gated=False,
)
