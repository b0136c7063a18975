"""GPT-3 175B [Brown et al., arXiv:2005.14165] — the paper's §VII workload,
runnable through the same stack for the mapping case study.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt3_175b", family="dense",
    n_layers=96, d_model=12288, n_heads=96, n_kv_heads=96,
    d_ff=49152, vocab=50_257, norm="layernorm", gated=False,
)

SMOKE = ModelConfig(
    name="gpt3_smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=8,
    d_ff=512, vocab=512, norm="layernorm", gated=False,
)
