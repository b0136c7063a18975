"""Model inputs (the reference's ``models/inputs.py``): meta-tensor
stand-ins for every (arch x shape) cell, and synthetic batches.

:func:`input_specs` returns the trees the step functions consume as
tensors on the ``meta`` device: shapes and dtypes, no memory. Token ids
are int64 and the decode position a (1,) int64 tensor, as the port's
steps take them (the reference's are int32 and a scalar). Modality
frontends are stubs: VLM cells get precomputed patch embeddings, audio
cells precomputed frame embeddings.

:func:`synth_batch` draws from an explicit ``torch.Generator``, where the
reference draws from a ``jax.random`` key, so the two give other tokens
from one seed (tests that compare the packages make their tokens with
numpy).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from .config import ModelConfig

if TYPE_CHECKING:  # configs imports models
    from ..configs import ShapeSpec


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _memory_spec(cfg: ModelConfig, batch: int) -> dict:
    """The VLM's ``image_embeds`` or the encoder-decoder's
    ``audio_frames``, bf16 (batch, tokens, d_model); empty otherwise."""
    if cfg.family == "vlm":
        return {"image_embeds": _meta((batch, cfg.n_image_tokens, cfg.d_model),
                                      torch.bfloat16)}
    if cfg.is_enc_dec:
        return {"audio_frames": _meta((batch, cfg.n_audio_frames, cfg.d_model),
                                      torch.bfloat16)}
    return {}


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    return {"tokens": _meta((batch, seq), torch.int64),
            "labels": _meta((batch, seq), torch.int64),
            **_memory_spec(cfg, batch)}


def decode_specs(cfg: ModelConfig, batch: int, kv_len: int) -> dict:
    """Inputs of a decode step: one new token, the position and the cache
    tree (``init_cache`` on the meta device)."""
    from .transformer import init_cache
    specs = {"token": _meta((batch,), torch.int64),
             "pos": _meta((1,), torch.int64),
             "cache": init_cache(cfg, batch, kv_len, device="meta")}
    memory = _memory_spec(cfg, batch)
    if memory:
        specs["memory"] = next(iter(memory.values()))
    return specs


def input_specs(cfg: ModelConfig, shape: "ShapeSpec") -> dict:
    if shape.phase == "train":
        return train_batch_specs(cfg, shape.global_batch, shape.seq_len)
    if shape.phase == "prefill":
        specs = train_batch_specs(cfg, shape.global_batch, shape.seq_len)
        specs.pop("labels")
        return specs
    return decode_specs(cfg, shape.global_batch, shape.seq_len)


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
