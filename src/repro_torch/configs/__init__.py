"""Architecture registry of the port (``--arch <id>``).

Each ported module defines ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), as in the reference
package. The reference names more architectures than the port runs yet;
asking for one of those raises ``NotImplementedError`` naming the ROADMAP
queue that holds it. Two of them, ``mamba2_130m`` and ``qwen3_moe_235b``,
are already here as data: the DSE scenarios
(``repro_torch.workloads.scenarios``) read their shapes.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

#: Architectures the port serves today.
ARCH_IDS = ["mistral_nemo_12b"]

#: Architectures of the reference package that wait for a later slice,
#: each with the ROADMAP queue 1 item that ports what it needs.
PENDING = {
    "command_r_35b": "queue 1: LayerNorm dense configs",
    "minitron_4b": "queue 1: LayerNorm dense configs",
    "olmo_1b": "queue 1: LayerNorm dense configs (non-parametric, tied embeddings)",
    "gpt3_175b": "queue 1: LayerNorm dense configs",
    "llama32_vision_11b": "queue 1: cross-attention memory",
    "seamless_m4t_medium": "queue 1: cross-attention memory and the encoder",
    "olmoe_1b_7b": "queue 1: MoE layers",
    "qwen3_moe_235b": "queue 1: MoE layers",
    "jamba_v01_52b": "queue 1: the SSM path (kernel ssd_chunk_fwd) and MoE layers",
    "mamba2_130m": "queue 1: the SSM path (kernel ssd_chunk_fwd)",
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
