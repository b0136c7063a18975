"""Plain PyTorch version of the flash-attention forward (GQA, causal/full)."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd). fp32 math, q's dtype out."""
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    n_rep = h // hkv
    k = torch.repeat_interleave(k, n_rep, dim=1)
    v = torch.repeat_interleave(v, n_rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(k.shape[2], device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
