"""Plain PyTorch versions of the flash-attention kernels (GQA, causal/full):
the forward, the forward with LSE and the FA-2 backward.

The backward is written out as the FA-2 formulas, the same function as the
Pallas kernels of ``repro/kernels/flash_attention/backward.py`` — not
autograd through the forward: P = exp(s * scale - LSE), dV = Pᵀ dO,
dS = P ∘ (dO Vᵀ - D), dK = dSᵀ Q * scale, dQ = dS K * scale, with dK and dV
summed over the query heads of each kv head. Causal masking is top-left
aligned (key <= query).
"""
from __future__ import annotations

import math

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """f32 scaled scores (B, H, Sq, Sk) with K repeated over the GQA group,
    and the mask of visible entries (None when every entry is visible)."""
    n_rep = q.shape[1] // k.shape[1]
    k = torch.repeat_interleave(k.float(), n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / math.sqrt(q.shape[-1])
    if not causal:
        return s, None
    qi = torch.arange(q.shape[2], device=q.device)[:, None]
    ki = torch.arange(k.shape[2], device=q.device)[None, :]
    return s, ki <= qi


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd). fp32 math, q's dtype out."""
    return flash_attention_fwd_lse_ref(q, k, v, causal)[0]


def flash_attention_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True):
    """(o in q's dtype, lse (B, H, Sq) f32). A row with no visible key gives
    o = 0 and lse = -inf (its l is 0, divided as 1)."""
    s, vis = _scores(q, k, causal)
    if vis is not None:
        s = s.masked_fill(~vis, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None].clamp_min(torch.finfo(torch.float32).min))
    n_rep = q.shape[1] // k.shape[1]
    vr = torch.repeat_interleave(v.float(), n_rep, dim=1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return o.to(q.dtype), lse


def _probs(q, k, lse, causal):
    s, vis = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None].float())
    return p if vis is None else torch.where(vis, p, torch.zeros_like(p))


def _group_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.view(b, hkv, h // hkv, s, d).sum(2)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd, causal: bool = True):
    """The dK/dV kernel's function: (dk, dv) in k's dtype, from dO, the
    forward's LSE and D = rowsum(dO ∘ O), both (B, H, Sq) f32."""
    hkv = k.shape[1]
    n_rep = q.shape[1] // hkv
    p = _probs(q, k, lse, causal)
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    vr = torch.repeat_interleave(v.float(), n_rep, dim=1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vr) - dd[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) / math.sqrt(q.shape[-1])
    return _group_sum(dk, hkv).to(k.dtype), _group_sum(dv, hkv).to(v.dtype)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, causal: bool = True):
    """The dQ kernel's function: dq in q's dtype."""
    n_rep = q.shape[1] // k.shape[1]
    p = _probs(q, k, lse, causal)
    vr = torch.repeat_interleave(v.float(), n_rep, dim=1)
    kr = torch.repeat_interleave(k.float(), n_rep, dim=1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do.float(), vr) - dd[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) / math.sqrt(q.shape[-1])
    return dq.to(q.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO ∘ O), (B, H, Sq) f32 and contiguous: the one
    elementwise pass the backward kernels take from outside."""
    return (do.float() * o.float()).sum(-1).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv) of the forward with LSE, given its output ``o``, its
    ``lse`` and the output gradient ``do``."""
    dd = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd, causal)
    return flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, causal), dk, dv
