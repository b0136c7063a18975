"""Model layers of the port: attention (self and cross), MLP, MoE and SSM
layers, as plain functions on tensors.

Each function mirrors the reference layer of the same name in
``repro/models/layers.py`` and computes the same function, with the
port's kernels at the points where the reference computes what a kernel
computes:

* prefill attention goes through ``flash_attention``, and attention that
  autograd differentiates through ``flash_attention_train`` (the forward
  with LSE, then the dK/dV and dQ kernels in backward);
* decode attention goes through ``decode_attention``, which reads the KV
  cache in place;
* cross-attention to a memory (image embeddings, or the encoder's output)
  goes through ``flash_attention`` without the causal mask for a whole
  sequence of queries, and through ``decode_attention`` over all M memory
  keys for the one query of a decode step;
* the block's residual adds and RMSNorms go through ``fused_rmsnorm``
  (``models/transformer.py``), and so does the SSM layer's gated norm;
  LayerNorm and the GELU MLP stay plain tensor ops, as the reference has
  no kernel for them;
* the MoE layers' router and expert products are plain batched matrix
  products (cuBLAS on the card), and their dispatch and combine plain
  tensor ops, as the reference computes them outside any kernel;
* the SSM layer's chunked scan goes through ``ssd_chunk``. The decode
  recurrence, the causal convolution, softplus, SiLU and the D skip stay
  plain tensor ops, as the reference computes them outside any kernel.

A CUDA tensor always reaches the kernel and a CPU tensor its plain version;
there is no switch. Training differentiates through the same calls: the
attention through ``flash_attention_train``, the fused RMSNorm (the gated
norm included) through its backward kernel, the scan through its plain
backward. The SSM layer's final state and conv tail, which prefill
caches, take no part in the loss: ``forward`` keeps the branch output
alone. Parameters are dictionaries of tensors with the
reference's names and shapes; projection matrices may be held in the
compute dtype (``_mm`` casts a weight to the activation's dtype first, as
the reference does per call).

Under installed rules and a mesh (``parallel/logical.use_rules``), each
parameter is this rank's block of what ``param_spec`` shards on 'model'
(Megatron tensor parallelism): q/k/v and the MLP's wi/wg column-parallel,
wo row-parallel with its output all-reduced (:func:`_row_out`), the
experts split (``parallel/moe.py``), and a decode step's cache the rank's
block of the sequence, merged by the log-sum-exp (``parallel/context.py``).
Without rules, nothing here reads the mesh and every path is the one
above.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention, flash_attention_train
from ..kernels.rmsnorm.ops import fused_rmsnorm, split_gated_rmsnorm
from ..kernels.ssd.ops import ssd_chunk
from ..parallel import dist as pd
from ..parallel.logical import current_mesh, current_rules
from .config import ModelConfig


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Projection matmul: the weight in the activation's dtype."""
    return torch.matmul(x, w.to(x.dtype))


# ============================ the model axis =================================
def model_mesh():
    """The installed mesh when rules are installed with it and its 'model'
    axis has more than one rank, else None: the layers then hold the local
    blocks that ``param_spec`` names (heads, ff, vocab, experts) and put the
    axis' collectives in themselves."""
    mesh = current_mesh()
    if mesh is None or current_rules() is None or mesh.size("model") == 1:
        return None
    return mesh


def reduce_dtype(cfg: ModelConfig, y: torch.Tensor) -> torch.dtype:
    """The dtype a row-parallel product's partial sums are all-reduced in:
    f32, as the reference's dot emits f32 before its cast, or the
    activation's with ``cfg.matmul_out == "bf16"``."""
    return y.dtype if cfg.matmul_out == "bf16" else torch.float32


def _split(n: int, width: int, cfg_n: int, what: str) -> bool:
    """Whether a projection of ``width`` columns of ``n``-wide heads holds a
    block of the config's ``cfg_n`` heads (True) or all of them."""
    if width % n:
        raise NotImplementedError(
            f"{what}: a block of {width} columns splits a head of {n}; the "
            "port shards whole heads (a model axis that divides the heads)")
    return width // n != cfg_n


def _heads_split(p: dict, cfg: ModelConfig, mesh):
    """(q split, K/V split) of an attention layer's projections under a
    model axis: both, or the queries alone (``kv_replicate``: the K/V
    projections whole on every rank, where the kv heads do not divide the
    axis), or neither."""
    hd = cfg.hd
    split = mesh is not None and _split(hd, p["wq"].shape[1], cfg.n_heads, "wq")
    kv_split = mesh is not None and _split(hd, p["wk"].shape[1], cfg.n_kv_heads, "wk")
    if kv_split and not split:
        raise NotImplementedError("K/V heads split over 'model' with the query "
                                  "heads whole")
    return split, kv_split


def _kv_projections(p: dict, mesh, split: bool, kv_split: bool):
    """wk and wv as this rank computes with them: whole on every rank under
    ``kv_replicate`` (and then, where the queries are split, their
    gradients summed over 'model': each rank's queries read some heads)."""
    if split and not kv_split and torch.is_grad_enabled():
        g = mesh.group("model")
        return pd.copy_to(p["wk"], g), pd.copy_to(p["wv"], g)
    return p["wk"], p["wv"]


def _query_kv_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, hq: int,
                    mesh, dim: int):
    """K/V of every kv head cut (along ``dim``) to those this rank's ``hq``
    query heads read (GQA: query head i reads kv head i // group)."""
    g = cfg.n_heads // cfg.n_kv_heads
    if hq % g and g % hq:
        raise NotImplementedError(f"{hq} query heads a rank and a GQA group of {g}")
    r = mesh.index("model")
    lo, hi = r * hq // g, ((r + 1) * hq - 1) // g + 1
    return k.narrow(dim, lo, hi - lo), v.narrow(dim, lo, hi - lo)


def _row_out(y: torch.Tensor, cfg: ModelConfig, mesh, split: bool) -> torch.Tensor:
    """A row-parallel product's output summed over 'model' where its input
    was split."""
    if not split:
        return y
    return pd.reduce_from(y, mesh.group("model"), reduce_dtype(cfg, y))


# ================================ norms ======================================
def rmsnorm(x: torch.Tensor, w: torch.Tensor | None,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if w is not None:
        y = y * w
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor | None,
              b: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """f32 math with the population variance, result in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w
    if b is not None:
        y = y + b
    return y.to(x.dtype)


def make_norm(cfg: ModelConfig):
    """Returns (init_fn, apply_fn) for the config's norm flavor. OLMo's
    non-parametric LayerNorm has no parameters: its tree is ``{}``."""
    f32 = dict(dtype=torch.float32)
    if cfg.norm == "nonparam_ln":
        return (lambda d, device: {},
                lambda p, x: layernorm(x, None, None))
    if cfg.norm == "layernorm":
        return (lambda d, device: {"w": torch.ones(d, **f32, device=device),
                                   "b": torch.zeros(d, **f32, device=device)},
                lambda p, x: layernorm(x, p["w"], p["b"]))
    return (lambda d, device: {"w": torch.ones(d, **f32, device=device)},
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
def _attend(q, k, v, causal: bool) -> torch.Tensor:
    """``flash_attention``, or ``flash_attention_train`` where autograd
    records a gradient of q, k or v."""
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    attend = flash_attention_train if wants_grad else flash_attention
    return attend(q, k, v, causal=causal)


def self_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, rope,
                   causal: bool = True):
    """x: (B, S, d); rope: ``rope_tables`` of the positions. Returns
    (out (B, S, d), k, v), with k (after RoPE) and v of shape
    (B, S, Hkv, hd), so prefill can fill the cache in the same pass."""
    b, s, _ = x.shape
    hd = cfg.hd
    mesh = model_mesh()
    if mesh is not None:
        return _self_attention_model_axis(p, x, cfg, rope, causal, mesh)
    q = _mm(x, p["wq"]).view(b, s, cfg.n_heads, hd)
    k = _mm(x, p["wk"]).view(b, s, cfg.n_kv_heads, hd)
    v = _mm(x, p["wv"]).view(b, s, cfg.n_kv_heads, hd)
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    o = _attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal)                                     # (B, H, S, hd)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    return _mm(o, p["wo"]), k, v


def _self_attention_model_axis(p, x, cfg, rope, causal, mesh):
    """:func:`self_attention` on this rank's heads (Megatron): q/k/v
    column-parallel, the attention on the local heads, wo row-parallel and
    its output all-reduced. k and v come back with this rank's kv heads
    (all of them where the K/V projections are whole)."""
    b, s, _ = x.shape
    hd = cfg.hd
    split, kv_split = _heads_split(p, cfg, mesh)
    hq, hk = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    if split:
        x = pd.copy_to(x, mesh.group("model"))
    wk, wv = _kv_projections(p, mesh, split, kv_split)
    q = rotate(_mm(x, p["wq"]).view(b, s, hq, hd), *rope)
    k = rotate(_mm(x, wk).view(b, s, hk, hd), *rope)
    v = _mm(x, wv).view(b, s, hk, hd)
    ka, va = (k, v) if split == kv_split else _query_kv_heads(k, v, cfg, hq, mesh, 2)
    o = _attend(q.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2),
                causal)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return _row_out(_mm(o, p["wo"]), cfg, mesh, split), k, v


def decode_self_attention(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                          rope, kv_len: torch.Tensor):
    """One-token decode. x: (B, 1, d); cache_{k,v}: (B, Smax, Hkv, hd),
    written in place at ``pos``; pos: the position, a (1,) int64 tensor on
    x's device; rope: ``rope_tables`` of ``pos``; kv_len: ``pos + 1`` as a
    (1,) int32 tensor. Nothing here reads a value on the host, so the step
    can be captured in a CUDA graph and replayed at later positions.

    Returns (out (B, 1, d), cache_k, cache_v)."""
    b, _, _ = x.shape
    hd = cfg.hd
    mesh = current_mesh()
    if mesh is not None and current_rules() is not None and (
            mesh.size("model") > 1 or cfg.decode_attn == "context_parallel"):
        return _decode_context_parallel(p, x, cache_k, cache_v, pos, cfg,
                                        rope, kv_len, mesh)
    q = _mm(x, p["wq"]).view(b, 1, cfg.n_heads, hd)
    k = _mm(x, p["wk"]).view(b, 1, cfg.n_kv_heads, hd)
    v = _mm(x, p["wv"]).view(b, 1, cfg.n_kv_heads, hd)
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    cache_k.index_copy_(1, pos, k.to(cache_k.dtype))
    cache_v.index_copy_(1, pos, v.to(cache_v.dtype))
    o = decode_attention(q[:, 0], cache_k.transpose(1, 2),
                         cache_v.transpose(1, 2), kv_len,
                         return_lse=False)                 # (B, H, hd)
    o = o.reshape(b, 1, cfg.n_heads * hd)
    return _mm(o, p["wo"]), cache_k, cache_v


def _decode_context_parallel(p, x, cache_k, cache_v, pos, cfg, rope, kv_len,
                             mesh):
    """:func:`decode_self_attention` with the cache's sequence sharded on
    'model' (``cache_shardings``; ``init_cache`` under the rules holds this
    rank's block of ``max_len / m`` positions, all kv heads): q/k/v on this
    rank's heads, gathered to all heads (tiny); the new K/V written by the
    rank whose block holds ``pos``, on the device; the attention over the
    local block through the decode kernel with its LSE, merged over
    'model' (``parallel/context.py``); this rank's heads of o through the
    row-parallel wo, all-reduced. The reference chooses, with
    ``decode_attn``, between this schedule and the partitioner's over the
    same sequence-sharded cache; the port runs this one under any model
    axis of more than one rank, and with ``decode_attn ==
    "context_parallel"`` under a model axis of one too."""
    from ..parallel.context import decode_attention_cache_layout
    b = x.shape[0]
    hd = cfg.hd
    group = mesh.group("model") if mesh.size("model") > 1 else None
    split, kv_split = _heads_split(p, cfg, mesh if group is not None else None)
    hq, hk = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    q = rotate(_mm(x, p["wq"]).view(b, 1, hq, hd), *rope)
    k = rotate(_mm(x, p["wk"]).view(b, 1, hk, hd), *rope)
    v = _mm(x, p["wv"]).view(b, 1, hk, hd)
    if kv_split:   # every rank's heads of q, k and v in one gather
        qkv = pd.all_gather(torch.cat([q, k, v], dim=2)[None], 0, group)
        q, k, v = (t.transpose(0, 2).reshape(b, 1, -1, hd) for t in
                   qkv.split([hq, hk, hk], dim=3))
    elif split:    # kv_replicate: the queries alone
        q = pd.all_gather(q[None], 0, group).transpose(0, 2).reshape(b, 1, -1, hd)
    s_local = cache_k.shape[1]
    local = pos - mesh.index("model") * s_local
    mine = (local >= 0) & (local < s_local)
    at = local.clamp(0, s_local - 1)
    for cache, new in ((cache_k, k), (cache_v, v)):
        cache.index_copy_(1, at, torch.where(
            mine[:, None, None, None], new.to(cache.dtype),
            cache.index_select(1, at)))
    o = decode_attention_cache_layout(mesh, q[:, 0], cache_k, cache_v,
                                      kv_len)                # (B, H, hd)
    if split:
        o = o[:, mesh.index("model") * hq:(mesh.index("model") + 1) * hq]
    o = o.reshape(b, 1, hq * hd)
    return _row_out(_mm(o, p["wo"]), cfg, mesh, split), cache_k, cache_v


def _cross_heads(p: dict, x: torch.Tensor, memory: torch.Tensor,
                 cfg: ModelConfig):
    """Cross-attention's heads here: (x, memory, q heads, kv heads, mesh,
    split). Under a model axis whose ranks hold a block of the heads (wq
    column-parallel, wk/wv alike: the memory's K/V on local heads, the
    memory whole on every rank), x and the memory enter through
    ``copy_to`` (their gradients summed over 'model')."""
    hd = cfg.hd
    mesh = model_mesh()
    split, kv_split = _heads_split(p, cfg, mesh)
    hq, hk = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    if split:
        x = pd.copy_to(x, mesh.group("model"))
        memory = pd.copy_to(memory, mesh.group("model"))
    return x, memory, hq, hk, mesh, split, kv_split


def _memory_heads(p, memory, cfg, hq, hk, mesh, split, kv_split):
    """The memory's K/V on the heads this rank's queries read."""
    wk, wv = _kv_projections(p, mesh, split, kv_split)
    k, v = _memory_kv({"wk": wk, "wv": wv}, memory, cfg, hk)
    return (k, v) if split == kv_split else _query_kv_heads(k, v, cfg, hq, mesh, 1)


def _memory_kv(p: dict, memory: torch.Tensor, cfg: ModelConfig, hk: int):
    """The memory's keys and values on ``hk`` heads, each (B, hk, M, hd):
    views of the (B, M, hk, hd) projections, as the cache is read."""
    b, m, _ = memory.shape
    k = _mm(memory, p["wk"]).view(b, m, hk, cfg.hd)
    v = _mm(memory, p["wv"]).view(b, m, hk, cfg.hd)
    return k.transpose(1, 2), v.transpose(1, 2)


def cross_attention(p: dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) queries; memory: (B, M, d) (image embeddings or the
    encoder's output), in x's dtype. Queries from x, keys and values from
    the memory, no RoPE, no mask. Returns (B, S, d). Under a model axis on
    this rank's heads, wo row-parallel and all-reduced."""
    b, s, _ = x.shape
    x, memory, hq, hk, mesh, split, kv_split = _cross_heads(p, x, memory, cfg)
    q = _mm(x, p["wq"]).view(b, s, hq, cfg.hd)
    k, v = _memory_heads(p, memory, cfg, hq, hk, mesh, split, kv_split)
    o = _attend(q.transpose(1, 2), k, v, False)             # (B, H, S, hd)
    o = o.transpose(1, 2).reshape(b, s, hq * cfg.hd)
    return _row_out(_mm(o, p["wo"]), cfg, mesh, split)


def decode_cross_attention(p: dict, x: torch.Tensor, memory: torch.Tensor,
                           cfg: ModelConfig,
                           mem_len: torch.Tensor) -> torch.Tensor:
    """:func:`cross_attention` of one query. x: (B, 1, d); mem_len: M, the
    memory's length, as a (1,) int32 tensor on x's device (the decode
    kernel's ``kv_len``: every key). The memory's K/V are projected in
    every step, as the reference does. Returns (B, 1, d)."""
    b = x.shape[0]
    x, memory, hq, hk, mesh, split, kv_split = _cross_heads(p, x, memory, cfg)
    q = _mm(x, p["wq"]).view(b, hq, cfg.hd)
    k, v = _memory_heads(p, memory, cfg, hq, hk, mesh, split, kv_split)
    o = decode_attention(q, k, v, mem_len, return_lse=False)  # (B, H, hd)
    return _row_out(_mm(o.reshape(b, 1, hq * cfg.hd), p["wo"]), cfg, mesh, split)


# ================================= MLP =======================================
def _activation(h: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    """The MLP's (and each expert's) activation: SwiGLU silu(g) * h, or
    (without a gate) GELU(h), the tanh form."""
    return F.silu(g) * h if g is not None else F.gelu(h, approximate="tanh")


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU, silu(x wg) * (x wi), or (without ``wg``) GELU(x wi); then
    wo. GELU is the tanh form, ``jax.nn.gelu``'s default (PyTorch's
    default, the erf form, differs by ~1e-3)."""
    mesh = model_mesh()
    split = mesh is not None and p["wi"].shape[1] != cfg.d_ff
    if split:
        x = pd.copy_to(x, mesh.group("model"))
    g = _mm(x, p["wg"]) if "wg" in p else None
    y = _mm(_activation(_mm(x, p["wi"]), g), p["wo"])
    return _row_out(y, cfg, mesh, split)


# ================================= MoE =======================================
def _route(p: dict, xt: torch.Tensor, k: int):
    """Top-k token choice: f32 router probabilities of xt (T, d), their k
    largest (gates, renormalised to sum 1) and the chosen experts, (T, k)
    each. Returns (probs, gates, idx). Equal probabilities (bf16 router
    logits tie often) go to the lower expert index, as ``jax.lax.top_k``
    breaks ties: a stable descending sort, where ``torch.topk`` promises
    no order."""
    probs = torch.softmax(_mm(xt, p["router"]).float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx


def moe_dispatch(p: dict, xt: torch.Tensor, cfg: ModelConfig,
                 capacity_factor: float | None = None):
    """The capacity-bounded dispatch of :func:`moe` for tokens xt (T, d):
    each (token, slot)'s expert ``idx`` and gate, its rank within that
    expert's buffer, ``keep`` (rank < capacity) and the capacity. Returns
    (gates, idx, rank, keep, cap), the first four (T, k)."""
    t = xt.shape[0]
    e, k = cfg.moe_experts, cfg.moe_top_k
    _, gates, idx = _route(p, xt, k)
    cf = cfg.moe_capacity_factor if capacity_factor is None else capacity_factor
    cap = int(max(1, math.ceil(t * k / e * cf)))
    # A pair's rank is the number of pairs before it, in (token, slot)
    # order, routed to the same expert: the reference's cumsum over the
    # one-hot (T k, E). A stable sort by expert keeps that order within an
    # expert, so the rank is the pair's place in the sort less its expert's
    # first place: the same integers, without a scan down a (T k, E) column
    # (that scan alone took 23 ms a layer at OLMoE's prefill on an H100).
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(e, dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    first = torch.cumsum(counts, 0) - counts
    place = torch.arange(flat.numel(), device=flat.device)
    rank = torch.empty_like(flat).scatter_(0, order, place - first[flat[order]])
    rank = rank.reshape(t, k)
    return gates, idx, rank, rank < cap, cap


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
        capacity_factor: float | None = None) -> torch.Tensor:
    """Top-k token-choice MoE with capacity-bounded scatter dispatch
    (Switch/GShard style), the reference's ``moe``. x: (B, S, d). Each
    (token, slot) goes to its expert's buffer (E, cap, d) at its rank there;
    a slot past the capacity is dropped: its row is zero and its combine
    reads slot (0, 0) with weight 0, as the reference. The experts are three
    batched products over (E, cap, d); the combine gathers each slot's
    output back and weights it by its gate (:func:`moe_experts`).

    Under installed rules and a mesh (``parallel/moe.py``): with
    ``moe_dispatch="shard_map"`` and a 'model' axis that divides the
    experts, the reference's expert-parallel schedule (routing over this
    rank's tokens); otherwise the same dispatch as one device over the
    global batch, each rank running its experts. Without a mesh
    ``"shard_map"`` computes this scatter dispatch, as the reference does."""
    mesh = current_mesh()
    if mesh is not None and current_rules() is not None:
        from ..parallel.moe import moe_mesh, moe_shard_map
        if (cfg.moe_dispatch == "shard_map" and "model" in mesh.axis_names
                and cfg.moe_experts % mesh.size("model") == 0):
            return moe_shard_map(p, x, cfg, mesh, capacity_factor)
        return moe_mesh(p, x, cfg, mesh, capacity_factor)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, idx, rank, keep, cap = moe_dispatch(p, xt, cfg, capacity_factor)
    y = moe_experts(p, xt, gates, idx, rank, keep, cap, 0, cfg.moe_experts)
    return y.reshape(b, s, d)


def moe_experts(p: dict, xt: torch.Tensor, gates, idx, rank, keep, cap: int,
                lo: int, e_local: int) -> torch.Tensor:
    """The experts ``lo .. lo + e_local - 1`` (``p``'s expert weights) over
    their capacity buffers, combined back to token order: (T, d), the sum
    of each token's slots routed to these experts (all of them, on one
    device), weighted by their gates."""
    t, d = xt.shape
    k = idx.shape[1]
    if lo or e_local != p["router"].shape[1]:
        keep = keep & (idx >= lo) & (idx < lo + e_local)
    slot = torch.where(keep, (idx - lo) * cap + rank, 0)   # (expert, rank)
    w_keep = gates * keep
    # The reference adds each pair's token, times (gate > 0), into its
    # slot. Pairs with a gate > 0 have distinct slots, so plain row copies
    # place them, one slot of every token at a time; every other pair would
    # add zeros (the dropped ones to slot (0, 0)), which changes nothing:
    # they go to a spare row past the buffer instead (an accumulating
    # scatter took 20 ms a layer at OLMoE's prefill on an H100).
    dest = torch.where(w_keep > 0, slot, e_local * cap)
    rows = xt.new_zeros((e_local * cap + 1, d))
    for j in range(k):
        rows.index_copy_(0, dest[:, j], xt)
    buf = rows[:-1].view(e_local, cap, d)
    h = torch.bmm(buf, p["wi"].to(xt.dtype))
    g = torch.bmm(buf, p["wg"].to(xt.dtype)) if "wg" in p else None
    out = torch.bmm(_activation(h, g), p["wo"].to(xt.dtype))
    y = out.view(e_local * cap, d).index_select(0, slot.reshape(-1)).view(t, k, d)
    return (y * w_keep[..., None].to(xt.dtype)).sum(dim=1)


def moe_dense(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dropless MoE for few tokens (decode): every expert processes every
    token, and the outputs combine by the top-k gates. Exact (nothing
    dropped) and free of host reads, so a decode step that runs it can be
    captured in a CUDA graph. x: (B, S, d)."""
    mesh = model_mesh()
    if mesh is not None and p["wi"].shape[0] != cfg.moe_experts:
        from ..parallel.moe import moe_dense_mesh
        return moe_dense_mesh(p, x, cfg, mesh)
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    xt = x.reshape(b * s, d)
    _, gates, idx = _route(p, xt, k)
    combine = torch.zeros((b * s, e), dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, idx, gates)
    h = torch.matmul(xt, p["wi"].to(x.dtype))                   # (E, T, f)
    g = torch.matmul(xt, p["wg"].to(x.dtype)) if "wg" in p else None
    y = torch.bmm(_activation(h, g), p["wo"].to(x.dtype))       # (E, T, d)
    y = torch.einsum("etd,te->td", y, combine.to(x.dtype))
    return y.reshape(b, s, d)


def moe_aux_loss(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch §2.2): E times the sum over
    experts of (share of top-k slots routed there) x (mean probability)."""
    d = x.shape[-1]
    probs, _, idx = _route(p, x.reshape(-1, d), cfg.moe_top_k)
    frac = F.one_hot(idx, cfg.moe_experts).float().mean(dim=(0, 1))
    return cfg.moe_experts * torch.sum(frac * probs.mean(0))


# =========================== Mamba2 / SSD layer ==============================
def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, state size N, heads H, head width P)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.ssm_state, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim


def ssm_split(cfg: ModelConfig, m: int) -> bool:
    """Whether a model axis of ``m`` ranks splits the Mamba2 layer by heads
    (the segmented split of ``launch/shardings.py``): where ``in_proj``'s
    columns are sharded (the reference's rule, ``m`` divides their count)
    and ``m`` divides the heads. Else the layer is whole on every rank."""
    d_in, n, h, _ = ssm_dims(cfg)
    return m > 1 and h % m == 0 and (2 * d_in + 2 * n + h) % m == 0


def _ssm_local(p: dict, cfg: ModelConfig):
    """How this rank holds the Mamba2 layer: (mesh, heads here, first head,
    out_proj's first row), mesh None where the layer runs as on one device
    (no model axis, or out_proj whole). The heads are all of them where
    ``in_proj`` is whole (the heads do not divide the axis): then every rank
    computes the whole layer and its block of out_proj's rows takes its
    block of the output's columns."""
    d_in, n, h, hp = ssm_dims(cfg)
    mesh = model_mesh()
    rows = p["out_proj"].shape[0]
    if mesh is None or rows == d_in:
        return None, h, 0, 0
    width = p["in_proj"].shape[1]
    r = mesh.index("model")
    if width == 2 * d_in + 2 * n + h:
        return mesh, h, 0, r * rows
    h_l = (width - 2 * n) // (2 * hp + 1)
    return mesh, h_l, r * h_l, 0


def _ssm_weights(p: dict, cfg: ModelConfig, mesh, h_l: int, lo: int) -> dict:
    """The layer's weights as this rank computes with them: in_proj
    (its columns [z | x | B | C | dt] of the rank's heads), conv_w (the
    channels [x | B | C] of its heads), A_log, D, dt_bias and norm_w of
    its heads, out_proj its rows. Under a model axis each leaf that every
    rank holds whole but uses in part (and B and C's columns of in_proj)
    enters through ``copy_to``: its gradient summed over 'model'."""
    if mesh is None:
        return p
    d_in, n, h, hp = ssm_dims(cfg)
    g = mesh.group("model")
    w_in = p["in_proj"]
    if h_l == h:
        w_in = pd.copy_to(w_in, g)
    elif torch.is_grad_enabled() and w_in.requires_grad:
        c = 2 * h_l * hp
        w_in = torch.cat([w_in[:, :c], pd.copy_to(w_in[:, c:c + 2 * n], g),
                          w_in[:, c + 2 * n:]], 1)
    conv = pd.copy_to(p["conv_w"], g)
    if h_l != h:
        conv = torch.cat([conv[:, lo * hp:(lo + h_l) * hp], conv[:, d_in:]], 1)
    heads = slice(lo, lo + h_l)
    return {"in_proj": w_in, "conv_w": conv,
            "A_log": pd.copy_to(p["A_log"], g)[heads],
            "D": pd.copy_to(p["D"], g)[heads],
            "dt_bias": pd.copy_to(p["dt_bias"], g)[heads],
            "norm_w": pd.copy_to(p["norm_w"], g)[lo * hp:(lo + h_l) * hp],
            "out_proj": p["out_proj"]}


def _ssm_norm_out(p: dict, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
                  mesh, h_l: int, row0: int) -> torch.Tensor:
    """The gated norm of y (..., h_l P) f32 by z, then out_proj: on one
    device the fused gated norm; under a model axis with the heads split
    the split-row norm (its row sums all-reduced over 'model'), with the
    layer whole on every rank the fused norm and this rank's block of the
    output's columns; then out_proj's rows here, all-reduced over 'model'."""
    d_in, _, h, hp = ssm_dims(cfg)
    if mesh is None:
        return _mm(_gated_norm(y, z, p["norm_w"]), p["out_proj"])
    if h_l == h:
        y = _gated_norm(y, z, p["norm_w"])
        y = y[..., row0:row0 + p["out_proj"].shape[0]]
    else:
        d = z.shape[-1]
        y = split_gated_rmsnorm(y.reshape(-1, d), p["norm_w"], z.reshape(-1, d),
                                mesh.group("model"), d_in).view(z.shape)
    return _row_out(_mm(y, p["out_proj"]), cfg, mesh, True)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D conv. x: (B, S, C); w: (K, C).

    Sums in float32 and rounds once to x's dtype, as the decode step's
    einsum over its window does, so that in bf16 prefill and decode round
    alike (the reference rounds each of the 2K bf16 operations here)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    wf = w.float()
    out = xp[:, :s] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * wf[i]
    return out.to(x.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor):
    """rmsnorm(y * silu(z), w): one launch of the fused RMSNorm on the card
    (no residual). y (..., d) float32, z (..., d) in the compute dtype, read
    in place through its row stride (a slice of ``in_proj``'s output); y
    and silu(z) are each rounded to z's dtype, multiplied and rounded, then
    normed. Returns z's dtype."""
    d = z.shape[-1]
    return fused_rmsnorm(y.reshape(-1, d), w, gate=z.reshape(-1, d))[0].view(z.shape)


def ssm_layer(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Mamba2 block forward (prefill). x: (B, S, d).

    Returns (out (B, S, d), final state (B, H, P, N) float32, conv tail
    (B, K-1, d_in + 2N) in x's dtype): the reference's ``ssm_layer`` and
    ``transformer._ssm_with_state`` in one pass, so that prefill fills the
    cache as it goes. The scan takes any S: the reference's ``chunk =
    min(128, S)`` holds S <= 128 or S % 128 == 0 only.
    """
    b, s, _ = x.shape
    _, n, _, hp = ssm_dims(cfg)
    mesh, h, lo, row0 = _ssm_local(p, cfg)
    if mesh is not None:
        x = pd.copy_to(x, mesh.group("model"))
    p = _ssm_weights(p, cfg, mesh, h, lo)
    d_in = h * hp
    k = cfg.ssm_conv
    zxbcdt = _mm(x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * n, h], dim=-1)
    conv_tail = F.pad(xbc, (0, 0, max(k - 1 - s, 0), 0))[:, -(k - 1):]
    xbc = F.silu(_causal_conv(xbc, p["conv_w"].to(x.dtype)))
    xs, Bm, Cm = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B, S, H)
    dA = dt * -torch.exp(p["A_log"])
    xs = xs.view(b, s, h, hp)
    y, state = ssd_chunk(xs, dt, Bm[:, :, None].expand(b, s, h, n),
                         Cm[:, :, None].expand(b, s, h, n), dA)
    y = y + p["D"][:, None] * xs.float()
    out = _ssm_norm_out(p, y.view(b, s, d_in), z, cfg, mesh, h, row0)
    return out, state, conv_tail


def ssm_decode_step(p: dict, x: torch.Tensor, state: torch.Tensor,
                    conv_cache: torch.Tensor, cfg: ModelConfig):
    """One-token SSD recurrence. x: (B, 1, d); state: (B, H, P, N) float32;
    conv_cache: (B, K-1, d_in + 2N). Both caches are updated in place.
    Returns (out (B, 1, d), state, conv_cache)."""
    b = x.shape[0]
    _, n, _, hp = ssm_dims(cfg)
    mesh, h, lo, row0 = _ssm_local(p, cfg)
    p = _ssm_weights(p, cfg, mesh, h, lo)
    d_in = h * hp
    zxbcdt = _mm(x, p["in_proj"])[:, 0]
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * n, h], dim=-1)
    window = torch.cat([conv_cache.to(xbc.dtype), xbc[:, None]], dim=1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window,
                              p["conv_w"].to(window.dtype)))
    conv_cache.copy_(window[:, 1:])
    xs, Bm, Cm = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B, H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    xs = xs.reshape(b, h, hp).float()
    state.mul_(dA[..., None, None]).add_(
        torch.einsum("bhp,bn,bh->bhpn", xs, Bm.float(), dt))
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    y = y + p["D"][:, None] * xs
    out = _ssm_norm_out(p, y.reshape(b, d_in), z, cfg, mesh, h, row0)
    return out[:, None], state, conv_cache


# =============================== initializers ================================
def dense_init(gen: torch.Generator, fan_in: int, shape, dtype,
               device) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) drawn in f32 from ``gen``, then cast."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def init_attention(gen, cfg: ModelConfig, dtype, device) -> dict:
    """Self- or cross-attention: the same four projections."""
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(gen, d, (d, cfg.n_heads * hd), dtype, device),
        "wk": dense_init(gen, d, (d, cfg.n_kv_heads * hd), dtype, device),
        "wv": dense_init(gen, d, (d, cfg.n_kv_heads * hd), dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, (cfg.n_heads * hd, d),
                         dtype, device),
    }


def init_ssm(gen, cfg: ModelConfig, dtype, device) -> dict:
    """The reference's leaves and shapes; A_log 0, D 1, dt_bias 0 and
    norm_w 1 in float32, as the reference initialises them."""
    d = cfg.d_model
    d_in, n, h, _ = ssm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d, (d, 2 * d_in + 2 * n + h), dtype, device),
        "conv_w": dense_init(gen, cfg.ssm_conv, (cfg.ssm_conv, d_in + 2 * n),
                             dtype, device),
        "A_log": torch.zeros(h, **f32),
        "D": torch.ones(h, **f32),
        "dt_bias": torch.zeros(h, **f32),
        "norm_w": torch.ones(d_in, **f32),
        "out_proj": dense_init(gen, d_in, (d_in, d), dtype, device),
    }


def init_mlp(gen, cfg: ModelConfig, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(gen, d, (d, f), dtype, device)}
    if cfg.gated:
        p["wg"] = dense_init(gen, d, (d, f), dtype, device)
    p["wo"] = dense_init(gen, f, (f, d), dtype, device)
    return p


def init_moe(gen, cfg: ModelConfig, dtype, device) -> dict:
    """The reference's leaves, expert axis leading: router (d, E), wi and
    wg (E, d, f), wo (E, f, d)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    p = {"router": dense_init(gen, d, (d, e), dtype, device),
         "wi": dense_init(gen, d, (e, d, f), dtype, device)}
    if cfg.gated:
        p["wg"] = dense_init(gen, d, (e, d, f), dtype, device)
    p["wo"] = dense_init(gen, f, (e, f, d), dtype, device)
    return p
