"""Model layers of the port: the dense subset, as plain functions on tensors.

Each function mirrors the reference layer of the same name in
``repro/models/layers.py`` and computes the same function, with the
port's kernels at the points where the reference computes what a kernel
computes:

* prefill attention goes through ``flash_attention``;
* decode attention goes through ``decode_attention``, which reads the KV
  cache in place;
* the block's residual adds and norms go through ``fused_rmsnorm``
  (``models/transformer.py``).

A CUDA tensor always reaches the kernel and a CPU tensor its plain version;
there is no switch. Parameters are dictionaries of tensors with the
reference's names and shapes; projection matrices may be held in the
compute dtype (``_mm`` casts a weight to the activation's dtype first, as
the reference does per call).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Projection matmul: the weight in the activation's dtype."""
    return torch.matmul(x, w.to(x.dtype))


# ================================ norms ======================================
def rmsnorm(x: torch.Tensor, w: torch.Tensor | None,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if w is not None:
        y = y * w
    return y.to(x.dtype)


def make_norm(cfg: ModelConfig):
    """Returns (init_fn, apply_fn) for the config's norm flavor. The port
    runs RMSNorm configs; LayerNorm ones wait in ROADMAP queue 1."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.name}: norm {cfg.norm!r} is not ported yet "
            "(ROADMAP.md queue 1: LayerNorm dense configs)")
    return (lambda d, device: {"w": torch.ones(d, dtype=torch.float32,
                                               device=device)},
            lambda p, x: rmsnorm(x, p["w"]))


# ================================ RoPE =======================================
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def rope_tables(pos: torch.Tensor, hd: int, theta: float):
    """(cos, sin) of the f32 angles pos * freqs, each (S, 1, hd/2): computed
    once per forward or decode step and shared by every layer."""
    ang = pos[..., None].to(torch.float32) * rope_freqs(hd, theta, pos.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-halves rotation of x (..., S, H, hd) in f32, result in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); pos: (S,) positions."""
    return rotate(x, *rope_tables(pos, x.shape[-1], theta))


# ============================ GQA attention layer ============================
def self_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, rope,
                   causal: bool = True):
    """x: (B, S, d); rope: ``rope_tables`` of the positions. Returns
    (out (B, S, d), k, v), with k (after RoPE) and v of shape
    (B, S, Hkv, hd), so prefill can fill the cache in the same pass."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = _mm(x, p["wq"]).view(b, s, cfg.n_heads, hd)
    k = _mm(x, p["wk"]).view(b, s, cfg.n_kv_heads, hd)
    v = _mm(x, p["wv"]).view(b, s, cfg.n_kv_heads, hd)
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal)   # (B, H, S, hd)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    return _mm(o, p["wo"]), k, v


def decode_self_attention(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: int, cfg: ModelConfig,
                          rope):
    """One-token decode. x: (B, 1, d); cache_{k,v}: (B, Smax, Hkv, hd),
    written in place at ``pos``; pos: a Python int; rope: ``rope_tables``
    of ``[pos]``.

    Returns (out (B, 1, d), cache_k, cache_v)."""
    b, _, _ = x.shape
    hd = cfg.hd
    q = _mm(x, p["wq"]).view(b, 1, cfg.n_heads, hd)
    k = _mm(x, p["wk"]).view(b, 1, cfg.n_kv_heads, hd)
    v = _mm(x, p["wv"]).view(b, 1, cfg.n_kv_heads, hd)
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    o = decode_attention(q[:, 0], cache_k.transpose(1, 2),
                         cache_v.transpose(1, 2), pos + 1,
                         return_lse=False)                 # (B, H, hd)
    o = o.reshape(b, 1, cfg.n_heads * hd)
    return _mm(o, p["wo"]), cache_k, cache_v


# ================================= MLP =======================================
def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU: silu(x wg) * (x wi), then wo."""
    h = F.silu(_mm(x, p["wg"])) * _mm(x, p["wi"])
    return _mm(h, p["wo"])


# =============================== initializers ================================
def dense_init(gen: torch.Generator, fan_in: int, shape, dtype,
               device) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) drawn in f32 from ``gen``, then cast."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def init_attention(gen, cfg: ModelConfig, dtype, device) -> dict:
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(gen, d, (d, cfg.n_heads * hd), dtype, device),
        "wk": dense_init(gen, d, (d, cfg.n_kv_heads * hd), dtype, device),
        "wv": dense_init(gen, d, (d, cfg.n_kv_heads * hd), dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, (cfg.n_heads * hd, d),
                         dtype, device),
    }


def init_mlp(gen, cfg: ModelConfig, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"wi": dense_init(gen, d, (d, f), dtype, device),
            "wg": dense_init(gen, d, (d, f), dtype, device),
            "wo": dense_init(gen, f, (f, d), dtype, device)}
