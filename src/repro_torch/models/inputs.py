"""Synthetic model inputs (the reference's ``models/inputs.synth_batch``).

The reference draws from a ``jax.random`` key; the port draws from an
explicit ``torch.Generator``, so the two give other tokens from one seed
(tests that compare the packages make their tokens with numpy).
"""
from __future__ import annotations

import torch

from .config import ModelConfig


def synth_batch(cfg: ModelConfig, batch: int, seq: int,
                generator: torch.Generator) -> dict:
    """{"tokens", "labels"}: (batch, seq) int64 uniform over the vocab, on
    the generator's device. The port has no VLM or encoder-decoder config,
    so there are no image or audio inputs."""
    dev = generator.device
    return {"tokens": torch.randint(0, cfg.vocab, (batch, seq),
                                    generator=generator, device=dev),
            "labels": torch.randint(0, cfg.vocab, (batch, seq),
                                    generator=generator, device=dev)}
