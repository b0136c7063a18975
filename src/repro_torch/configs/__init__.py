"""Architecture registry of the port (``--arch <id>``).

Each ported module defines ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), as in the reference
package. The port runs dense decoders with RMSNorm and SwiGLU
(``mistral_nemo_12b``) or LayerNorm and GELU (``olmo_1b``, ``minitron_4b``,
``command_r_35b``, ``gpt3_175b``), MoE decoders (``olmoe_1b_7b``,
``qwen3_moe_235b``) and an attention-free Mamba2 stack (``mamba2_130m``).
The reference names more architectures than the port runs yet; asking for
one of those raises ``NotImplementedError`` naming the ROADMAP queue that
holds it.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

#: Architectures the port runs today.
ARCH_IDS = ["mistral_nemo_12b", "mamba2_130m", "olmo_1b", "minitron_4b",
            "command_r_35b", "gpt3_175b", "olmoe_1b_7b", "qwen3_moe_235b"]

#: Architectures of the reference package that wait for a later slice,
#: each with the ROADMAP queue 1 item that ports what it needs.
PENDING = {
    "llama32_vision_11b": "queue 1: cross-attention memory",
    "seamless_m4t_medium": "queue 1: cross-attention memory and the encoder",
    "jamba_v01_52b": "queue 1 item 6: hybrid attention/SSM blocks (its MoE "
                     "and SSM layers are ported)",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "")
    if arch in PENDING:
        raise NotImplementedError(
            f"{arch} is not ported yet; ROADMAP.md {PENDING[arch]}")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}")
    mod = importlib.import_module(f"{__name__}.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG
