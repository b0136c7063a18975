"""AI2 OLMo-1B [arXiv:2402.00838; hf].

Dense decoder with NON-PARAMETRIC LayerNorm (no scale/bias — the arch's
distinguishing feature), MHA (16/16), vocab 50304.

A copy of the reference's config, which gives the MLP as non-gated GELU
(d_ff 8192; 0.908 B parameters). The published OLMo-1B uses a gated
SwiGLU MLP (8192 per gate; about 1.18 B parameters), so this config
matches the source's widths and depth but not its MLP.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo_1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50_304, norm="nonparam_ln", gated=False,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo_smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab=512, norm="nonparam_ln", gated=False,
    tie_embeddings=True,
)
