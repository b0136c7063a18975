"""Model assembly of the port: embedding → blocks → final norm → head.

Public entry points, mirroring ``repro/models/transformer.py``:
  init_params(cfg, seed, device)                     -> params
  forward(cfg, params, tokens)                       -> logits
  init_cache(cfg, batch, max_len, device)            -> cache
  prefill(cfg, params, tokens, max_len)              -> logits, cache
  decode_step(cfg, params, cache, token, pos)        -> logits, cache

Parameters are nested dictionaries with the reference's names and shapes;
the reference's stacked ``params["stack"]`` (leading axis n_blocks) is a
list of n_blocks block dictionaries here. Projection matrices and the
embedding are held in the compute dtype, norm weights in float32.

The block applies its residual adds through the fused RMSNorm kernel:
each branch output is added to the residual and normed by the next norm in
one launch, ``(h, x) = fused_rmsnorm(branch_out, w_next, residual=x)``, so a
pass over L layers launches it 1 + 2L times. The kernel normalises the f32
sum before rounding it, where the reference normalises the residual after
rounding; the two agree exactly in float32 and to the last bf16 bit in
bfloat16.

The cache layout is the reference's, (n_blocks, n_attn, B, max_len, Hkv, hd),
in bfloat16 whatever the compute dtype. Unlike the reference, prefill fills
it in the same pass that computes the logits, and ``decode_step`` writes it
in place.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels.rmsnorm.ops import fused_rmsnorm
from . import layers as L
from .config import ModelConfig


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense RMSNorm SwiGLU decoders; everything else
    raises."""
    missing = []
    if cfg.moe_experts:
        missing.append("MoE layers")
    if cfg.attn_every or cfg.attention_free:
        missing.append("the SSM path")
    if cfg.cross_attn_every or cfg.is_enc_dec:
        missing.append("cross-attention memory")
    if cfg.norm != "rmsnorm":
        missing.append("LayerNorm dense configs")
    if not cfg.gated:
        missing.append("the GELU MLP")
    if missing:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(missing)}, not ported yet "
            "(ROADMAP.md queue 1)")


# ================================ init =======================================
def _init_layer(gen, cfg: ModelConfig, dtype, device) -> dict:
    norm_init, _ = L.make_norm(cfg)
    return {"ln1": norm_init(cfg.d_model, device),
            "attn": L.init_attention(gen, cfg, dtype, device),
            "ln2": norm_init(cfg.d_model, device),
            "mlp": L.init_mlp(gen, cfg, dtype, device)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``:
    the reference's shapes, Normal(0, 1/sqrt(fan_in)) matrices, norms at 1."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = compute_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    norm_init, _ = L.make_norm(cfg)
    params: dict = {
        "embed": L.dense_init(gen, cfg.d_model, (cfg.vocab, cfg.d_model),
                              dtype, device),
        "final_norm": norm_init(cfg.d_model, device),
        "stack": [{f"l{i}": _init_layer(gen, cfg, dtype, device)
                   for i in range(cfg.block_size)}
                  for _ in range(cfg.n_blocks)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model,
                                         (cfg.d_model, cfg.vocab), dtype,
                                         device)
    return params


def to_device(params, device):
    """A copy of a parameter tree (or cache) with every tensor on ``device``."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return [to_device(v, device) for v in params]


# ================================ stack ======================================
def _layers(cfg: ModelConfig, params: dict):
    """(block, slot, layer params) in order; slot indexes the cache."""
    for b, bp in enumerate(params["stack"]):
        for i in range(cfg.block_size):
            yield b, i, bp[f"l{i}"]


def _run_stack(cfg: ModelConfig, params: dict, x: torch.Tensor,
               attend) -> torch.Tensor:
    """x: (B, S, d) embeddings. ``attend(block, slot, layer, h)`` returns
    the attention branch's output. Returns the final-normed (B, S, d)."""
    shape = x.shape
    layers = list(_layers(cfg, params))
    h, x = fused_rmsnorm(x.reshape(-1, shape[-1]), layers[0][2]["ln1"]["w"])
    for n, (b, i, lp) in enumerate(layers):
        a = attend(b, i, lp, h.view(shape))
        h, x = fused_rmsnorm(a.reshape(-1, shape[-1]), lp["ln2"]["w"],
                             residual=x)
        m = L.mlp(lp["mlp"], h.view(shape), cfg)
        w_next = (layers[n + 1][2]["ln1"]["w"] if n + 1 < len(layers)
                  else params["final_norm"]["w"])
        h, x = fused_rmsnorm(m.reshape(-1, shape[-1]), w_next, residual=x)
    return h.view(shape)


def _head(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _positions(start: int, n: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, device=device)


# ================================ forward ====================================
def forward(cfg: ModelConfig, params: dict,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int. Returns logits (B, S, V) in the compute dtype."""
    dtype = compute_dtype(cfg)
    x = params["embed"][tokens].to(dtype)
    rope = L.rope_tables(_positions(0, tokens.shape[1], x.device), cfg.hd,
                         cfg.rope_theta)

    def attend(b, i, lp, h):
        return L.self_attention(lp["attn"], h, cfg, rope)[0]

    h = _run_stack(cfg, params, x, attend)
    return L._mm(h, _head(cfg, params))


# ============================= KV cache ======================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    check_supported(cfg)
    device = resolve_device(device)
    shape = (cfg.n_blocks, cfg.block_size, batch, max_len, cfg.n_kv_heads,
             cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int | None = None):
    """Logits for the prompt and a cache of ``max_len`` positions (default
    the prompt length) whose first S positions hold the prompt's K/V."""
    b, s = tokens.shape
    max_len = s if max_len is None else max_len
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    cache = init_cache(cfg, b, max_len, tokens.device)
    dtype = compute_dtype(cfg)
    x = params["embed"][tokens].to(dtype)
    rope = L.rope_tables(_positions(0, s, x.device), cfg.hd, cfg.rope_theta)

    def attend(blk, slot, lp, h):
        out, k, v = L.self_attention(lp["attn"], h, cfg, rope)
        cache["k"][blk, slot, :, :s] = k
        cache["v"][blk, slot, :, :s] = v
        return out

    h = _run_stack(cfg, params, x, attend)
    return L._mm(h, _head(cfg, params)), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: int):
    """One autoregressive step. token: (B,) int; pos: the Python int
    position being written. Updates ``cache`` in place and returns
    (logits (B, V), cache)."""
    dtype = compute_dtype(cfg)
    x = params["embed"][token][:, None, :].to(dtype)       # (B, 1, d)
    rope = L.rope_tables(_positions(pos, 1, x.device), cfg.hd,
                         cfg.rope_theta)

    def attend(blk, slot, lp, h):
        return L.decode_self_attention(lp["attn"], h, cache["k"][blk, slot],
                                       cache["v"][blk, slot], pos, cfg,
                                       rope)[0]

    h = _run_stack(cfg, params, x, attend)
    return L._mm(h[:, 0], _head(cfg, params)), cache
