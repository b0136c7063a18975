"""Gradient compression for the data-parallel all-reduce (the reference's
``parallel/compression.py``): block-wise int8 quantization with error
feedback.

The data-parallel gradient all-reduce is the collective DFModel charges at
``all_reduce(grad_bytes)`` (core/interchip.py); int8 cuts its payload to a
quarter of f32 when error feedback carries the quantization residual to
the next step (1-bit Adam / EF-SGD lineage). The arithmetic is the
reference's in f32: ``torch.round`` rounds half to even as ``jnp.round``
does, so the two agree bit for bit.
"""
from __future__ import annotations

import math

import torch


def quantize_int8(g: torch.Tensor, block: int = 256):
    """Per-block symmetric int8 of ``g`` flattened and zero-padded to a
    multiple of ``block``. Returns (q int8 (n, block), scales f32 (n, 1),
    the original shape)."""
    flat = g.reshape(-1)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32), tuple(g.shape)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_tree(grads, errors=None, block: int = 256):
    """Quantize a gradient tree with error feedback. Returns (a tree of
    (q, scale, shape) tuples, the new errors)."""
    from ..train.optimizer import tree_map   # train imports this module
    if errors is None:
        errors = tree_map(torch.zeros_like, grads)
    corrected = tree_map(lambda g, e: g + e, grads, errors)
    comp = tree_map(lambda g: quantize_int8(g, block), corrected)
    new_err = tree_map(lambda g, c: g - dequantize_int8(*c), corrected, comp)
    return comp, new_err


def decompress_tree(comp):
    if isinstance(comp, tuple):
        return dequantize_int8(*comp)
    if isinstance(comp, dict):
        return {k: decompress_tree(v) for k, v in comp.items()}
    return [decompress_tree(v) for v in comp]
