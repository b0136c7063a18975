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
    the generator's device; for the VLM also ``image_embeds`` (batch,
    n_image_tokens, d_model), for an encoder-decoder ``audio_frames``
    (batch, n_audio_frames, d_model), standard normal in bfloat16 (the
    stub frontends' precomputed embeddings)."""
    dev = generator.device
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq),
                                   generator=generator, device=dev),
           "labels": torch.randint(0, cfg.vocab, (batch, seq),
                                   generator=generator, device=dev)}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.randn(
            (batch, cfg.n_image_tokens, cfg.d_model), generator=generator,
            device=dev).to(torch.bfloat16)
    if cfg.is_enc_dec:
        out["audio_frames"] = torch.randn(
            (batch, cfg.n_audio_frames, cfg.d_model), generator=generator,
            device=dev).to(torch.bfloat16)
    return out
