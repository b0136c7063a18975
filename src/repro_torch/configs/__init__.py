"""Architecture registry of the port (``--arch <id>``).

Each ported module defines ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), as in the reference
package. The port runs every architecture the reference names: dense
decoders with RMSNorm and SwiGLU (``mistral_nemo_12b``) or LayerNorm and
GELU (``olmo_1b``, ``minitron_4b``, ``command_r_35b``, ``gpt3_175b``), MoE
decoders (``olmoe_1b_7b``, ``qwen3_moe_235b``), an attention-free Mamba2
stack (``mamba2_130m``), Jamba's hybrid attention/SSM blocks with MoE
(``jamba_v01_52b``), a decoder that cross-attends to image embeddings
(``llama32_vision_11b``) and an encoder-decoder (``seamless_m4t_medium``).
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

#: Architectures the port runs: all of the reference package's.
ARCH_IDS = ["mistral_nemo_12b", "mamba2_130m", "olmo_1b", "minitron_4b",
            "command_r_35b", "gpt3_175b", "olmoe_1b_7b", "qwen3_moe_235b",
            "llama32_vision_11b", "seamless_m4t_medium", "jamba_v01_52b"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (sequence length, global batch, phase) cell of the reference's
    shape grid."""

    name: str
    seq_len: int
    global_batch: int
    phase: str               # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}")
    mod = importlib.import_module(f"{__name__}.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG


def cells(arch: str) -> list[str]:
    """Applicable shape names for an arch (long_500k only for sub-quadratic
    families: full-attention archs skip it)."""
    cfg = get_config(arch)
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names
