"""Plain PyTorch version of decode attention (with LSE export)."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: int | torch.Tensor, return_lse: bool = False):
    """q: (B, H, hd); k, v: (B, Hkv, S, hd); kv_len: valid prefix length, an
    int or a one-element tensor on q's device (read on the device, no host
    synchronisation).

    Returns o (B, H, hd) [, lse (B, H)]: f32 math, o in q's dtype.
    """
    b, h, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    n_rep = h // hkv
    k = torch.repeat_interleave(k, n_rep, dim=1)
    v = torch.repeat_interleave(v, n_rep, dim=1)
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) / math.sqrt(hd)
    mask = torch.arange(s, device=q.device)[None, None, :] < kv_len
    logits = logits.masked_fill(~mask, -math.inf)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhk,bhkd->bhd", p, v.float()) / l[..., None]
    if return_lse:
        return o.to(q.dtype), (m + torch.log(l)).float()
    return o.to(q.dtype)
