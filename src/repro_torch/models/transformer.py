"""Model assembly of the port: embedding → blocks → final norm → head.

Public entry points, mirroring ``repro/models/transformer.py``:
  init_params(cfg, seed, device, dtype)                   -> params
  encode(cfg, params, frames)                             -> memory
  forward(cfg, params, tokens, memory)                    -> logits
  loss_fn(cfg, params, batch)                             -> scalar loss
  init_cache(cfg, batch, max_len, device)                 -> cache
  prefill(cfg, params, tokens, max_len, cache, memory)    -> logits, cache
  decode_step(cfg, params, cache, token, pos, memory)     -> logits, cache

Two layer kinds run: attention layers with an MLP (dense decoders, SwiGLU
or GELU) or a mixture of experts (MoE configs: ``moe`` with capacity
dispatch in ``forward``, ``loss_fn`` and ``prefill``, the dropless
``moe_dense`` in ``decode_step``, as the reference), and Mamba2 SSM layers,
without an MLP in attention-free configs (``d_ff == 0``) and with one in
Jamba's hybrid blocks, where a block of ``block_size`` layers mixes both
kinds (:func:`cache_spec` maps each layer to its cache slot). Attention
layers that ``cfg.layer_is_cross`` marks also cross-attend to a memory
(B, M, d) after their self-attention: the VLM's image embeddings, or the
encoder-decoder's encoder output (:func:`encode`, a stack of non-causal
attention layers). As in the reference, cross-attention runs only where a
memory is given; ``loss_fn`` takes it from the batch
(:func:`_memory_from_batch`). Parameters are nested dictionaries with the reference's
names and shapes; the reference's stacked ``params["stack"]`` (leading axis
n_blocks) is a list of n_blocks block dictionaries here, and its stacked
``params["enc_stack"]`` (leading axis encoder_layers) a list of encoder
layer dictionaries. Projection
matrices, the SSM convolution and the embedding are held in the compute
dtype for serving, or in ``cfg.param_dtype`` (float32) for training, and
``_mm`` casts them per call, as the reference does; norm weights and the
SSM's 1-D leaves are float32, but for LayerNorm training under
``param_dtype="bfloat16"``, where the reference casts them to bf16 too. A
non-parametric LayerNorm's leaf is ``{}``.

LayerNorm configs add the residual in the compute dtype and norm with the
plain ``layernorm``, as the reference does (it has no LayerNorm kernel).
When autograd records, each layer of either stack is checkpointed as
``cfg.remat`` says (:func:`_remat`): ``"full"`` recomputes the layer in
backward, ``"dots"`` saves the outputs of its 2-D projections (``aten.mm``)
and recomputes everything else, batched products included, as the
reference's ``dots_with_no_batch_dims_saveable``, and ``"none"`` saves its
activations. A recomputed layer launches its kernels' forwards again.

An RMSNorm block applies its residual adds through the fused RMSNorm kernel:
each branch output is added to the residual and normed by the next norm in
one launch, ``(h, x) = fused_rmsnorm(branch_out, w_next, residual=x)``, so a
pass over L dense layers launches it 1 + 2L times, and over L SSM layers
1 + 2L times: 1 + L residual norms and L gated norms inside the layers,
each one launch with the SiLU gate and its product fused in. A cross layer
with a memory adds one launch, the norm before its cross-attention
(``lnx``): 1 + 2L + n_cross a pass. Training differentiates through the
norm (``fused_rmsnorm_bwd``, one launch a norm) and the scan (its plain
backward); a layer is one function (h, x) -> (h', x') ending in the fused
norm into the next layer's ``ln1`` weight (or the final norm's), which is
passed in, so its gradient accumulates once. The kernel
normalises the f32 sum before rounding it, where the reference normalises
the residual after rounding; the two agree exactly in float32 and to the
last bf16 bit in bfloat16.

The cache has the reference's layout and dtypes: for attention layers
``k``/``v`` (n_blocks, n_attn, B, max_len, Hkv, hd) in bfloat16; for SSM
layers ``ssm`` (n_blocks, n_ssm, B, H, P, N) in float32 and ``conv``
(n_blocks, n_ssm, B, K-1, d_inner + 2N) in bfloat16, whatever the compute
dtype. The SSM entries do not depend on ``max_len``. Unlike the reference,
prefill fills the cache in the same pass that computes the logits (into a
given cache, if one is passed), and ``decode_step`` writes it in place. The
memory is not cached: ``decode_step`` projects its keys and values in every
step, as the reference does.

``decode_step`` takes the position as the reference's traced ``pos``: a
one-element integer tensor on the model's device (a Python int is turned
into one). The cache write, the RoPE angles and the attention's ``kv_len``
are computed from it on the device, so one step captured in a CUDA graph
(``serve/engine.py``) is replayed at every later position; the memory is
read by address, so a replay sees what was copied into it.

Over a mesh (inside ``use_rules(rules, mesh)``), the functions take this
rank's blocks: the parameters ``launch/shardings.param_shardings`` names,
its rows of the batch and, from :func:`init_cache` (given the global batch
and ``max_len``), its block of the cache. Where a model axis shards the
vocabulary, the embedding is looked up per block and summed, and the
logits are this rank's block of the vocabulary (:func:`gather_vocab`),
which ``loss_fn`` reduces by the vocab-parallel cross-entropy. Every
layer kind runs under a model axis: attention, MLP and MoE as Megatron
splits them, the Mamba2 layer by its heads (the segmented split of
``launch/shardings.py``, its gated norm over split rows), cross-attention
on this rank's heads over a memory that every rank holds whole, and the
encoder as the decoder; the cache's SSM state and conv tail are this
rank's heads (where they divide the axis), its K/V this rank's block of
the sequence.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..kernels.rmsnorm.ops import fused_rmsnorm
from ..parallel import dist as pd
from ..parallel.logical import current_mesh, current_rules, use_rules
from . import layers as L
from .config import ModelConfig


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    """The port runs every layer pattern of the reference (dense, MoE,
    SSM, hybrid attention/SSM blocks, cross-attention, encoder-decoder) on
    one device and under any mesh; the pattern must tile the stack (a
    ValueError where ``n_layers`` is not a multiple of the block)."""
    cfg.n_blocks


# ================================ init =======================================
def _init_layer(gen, cfg: ModelConfig, idx: int, dtype, device) -> dict:
    norm_init, _ = L.make_norm(cfg)
    p: dict = {"ln1": norm_init(cfg.d_model, device)}
    if cfg.layer_kind(idx) == "attn":
        p["attn"] = L.init_attention(gen, cfg, dtype, device)
        if cfg.layer_is_cross(idx):
            p["lnx"] = norm_init(cfg.d_model, device)
            p["xattn"] = L.init_attention(gen, cfg, dtype, device)
    else:
        p["ssm"] = L.init_ssm(gen, cfg, dtype, device)
    if cfg.d_ff:
        p["ln2"] = norm_init(cfg.d_model, device)
        if cfg.layer_is_moe(idx):
            p["moe"] = L.init_moe(gen, cfg, dtype, device)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, dtype, device)
    return p


def _init_encoder_layer(gen, cfg: ModelConfig, dtype, device) -> dict:
    norm_init, _ = L.make_norm(cfg)
    return {"ln1": norm_init(cfg.d_model, device),
            "attn": L.init_attention(gen, cfg, dtype, device),
            "ln2": norm_init(cfg.d_model, device),
            "mlp": L.init_mlp(gen, cfg, dtype, device)}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    """The dtype training holds matrices in (``cfg.param_dtype``)."""
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _mapped(tree, leaf, path: tuple):
    """``leaf(path, tensor)`` over a dict tree (a layer's parameters)."""
    if isinstance(tree, torch.Tensor):
        return leaf(path, tree)
    return {k: _mapped(v, leaf, path + (k,)) for k, v in tree.items()}


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: torch.dtype | None = None, blocks: range | None = None,
                leaf=None) -> dict:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``:
    the reference's leaves and shapes (``lnx``/``xattn`` on cross layers,
    ``enc_stack`` and ``enc_final_norm`` for an encoder-decoder),
    Normal(0, 1/sqrt(fan_in)) matrices, norms at 1 (LayerNorm biases at
    0). Matrices and the embedding are drawn in f32
    and held in ``dtype``, by default the compute dtype (serving);
    training passes ``param_dtype(cfg)``. Under ``param_dtype="bfloat16"``
    with bf16 ``dtype`` the LayerNorm ``w``/``b`` leaves are bf16 too, as
    the reference casts every f32 leaf (RMSNorm weights stay f32: the fused
    norm kernel and its backward take f32 weights).

    ``blocks``: make only these blocks of the stack (``params["stack"]``
    holds them in order), each equal to the same block of the whole init:
    the others' weights are drawn and dropped, so the generator stands
    where the whole init's does (a model too large for one card in parts,
    :func:`forward_part`). ``leaf(path, tensor)``: applied to each leaf as
    it is made, a layer at a time, and kept instead (this rank's block of
    it, ``launch/shardings.init_local_params``), so the whole tree never
    exists at once."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    gen = (None if device.type == "meta"     # shapes only (launch/shardings)
           else torch.Generator(device=device).manual_seed(seed))
    norm_init, _ = L.make_norm(cfg)
    put = (lambda path, t: t) if leaf is None else leaf
    keep = range(cfg.n_blocks) if blocks is None else blocks
    params: dict = {
        "embed": put(("embed",), L.dense_init(gen, cfg.d_model, (cfg.vocab, cfg.d_model),
                                               dtype, device)),
        "final_norm": _mapped(norm_init(cfg.d_model, device), put, ("final_norm",)),
        "stack": [],
    }
    for b in range(cfg.n_blocks):
        blk = {}
        for i in range(cfg.block_size):
            lp = _init_layer(gen, cfg, i, dtype, device)
            if b in keep:
                blk[f"l{i}"] = _mapped(lp, put, ("stack", b, f"l{i}"))
        if b in keep:
            params["stack"].append(blk)
    if not cfg.tie_embeddings:
        params["lm_head"] = put(("lm_head",), L.dense_init(
            gen, cfg.d_model, (cfg.d_model, cfg.vocab), dtype, device))
    if cfg.is_enc_dec:
        params["enc_stack"] = [_mapped(_init_encoder_layer(gen, cfg, dtype, device), put,
                                       ("enc_stack", i))
                               for i in range(cfg.encoder_layers)]
        params["enc_final_norm"] = _mapped(norm_init(cfg.d_model, device), put,
                                           ("enc_final_norm",))
    if (cfg.norm == "layernorm" and cfg.param_dtype == "bfloat16"
            and dtype == torch.bfloat16):
        norms = [params, *params.get("enc_stack", []),
                 *[lp for blk in params["stack"] for lp in blk.values()]]
        for node in norms:
            for k in ("ln1", "ln2", "lnx", "final_norm", "enc_final_norm"):
                if k in node:
                    node[k] = {n: t.to(dtype) for n, t in node[k].items()}
    return params


def param_count(params) -> int:
    """Number of parameters in a tree."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    vals = params.values() if isinstance(params, dict) else params
    return sum(param_count(v) for v in vals)


def to_device(params, device):
    """A copy of a parameter tree (or cache) with every tensor on ``device``."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return [to_device(v, device) for v in params]


# ================================ stack ======================================
def _layers(cfg: ModelConfig, params: dict):
    """(block, slot, layer params) in order; slot is the layer's place in
    the cache entries of its kind (:func:`cache_spec`)."""
    spec = cache_spec(cfg)
    for b, bp in enumerate(params["stack"]):
        for i in range(cfg.block_size):
            yield b, spec.slot(i), bp[f"l{i}"]


def _ffn(cfg: ModelConfig, lp: dict, h: torch.Tensor,
         dense_moe: bool) -> torch.Tensor:
    """The layer's MLP, or its MoE: the capacity dispatch, or with
    ``dense_moe`` (decode) every expert densely."""
    if "mlp" in lp:
        return L.mlp(lp["mlp"], h, cfg)
    return (L.moe_dense if dense_moe else L.moe)(lp["moe"], h, cfg)


def _run_stack(cfg: ModelConfig, params: dict, x: torch.Tensor,
               mix, dense_moe: bool = False, cross=None) -> torch.Tensor:
    """The decoder stack over x: (B, S, d) embeddings (:func:`_stack`)."""
    return _stack(cfg, list(_layers(cfg, params)), params["final_norm"], x,
                  mix, dense_moe, cross)


def _stack(cfg: ModelConfig, layers: list, final_norm: dict, x: torch.Tensor,
           mix, dense_moe: bool = False, cross=None) -> torch.Tensor:
    """x: (B, S, d) through ``layers`` ((block, slot, layer params) each),
    then ``final_norm``. ``mix(block, slot, layer, h)`` returns the layer's
    attention or SSM branch output; ``cross(layer, h)``, where given,
    returns the cross-attention of a layer that has one (``xattn``), after
    its self-attention; ``dense_moe`` runs MoE layers dropless
    (:func:`_ffn`). Returns the final-normed (B, S, d), or without
    ``final_norm`` (RMSNorm configs) the residual stream after the last
    layer, which a later call takes as its ``x``."""
    shape = x.shape
    if cfg.norm != "rmsnorm":
        return _run_stack_layernorm(cfg, final_norm, x, mix, layers,
                                    dense_moe, cross)
    d = shape[-1]
    w_last = (torch.ones(d, dtype=torch.float32, device=x.device)
              if final_norm is None else final_norm["w"])

    def layer(h, x, b, i, lp, w_next):
        a = mix(b, i, lp, h.view(shape))
        if cross is not None and "xattn" in lp:
            h, x = fused_rmsnorm(a.reshape(-1, d), lp["lnx"]["w"], residual=x)
            a = cross(lp, h.view(shape))
        if "ln2" in lp:
            h, x = fused_rmsnorm(a.reshape(-1, d), lp["ln2"]["w"], residual=x)
            a = _ffn(cfg, lp, h.view(shape), dense_moe)
        return fused_rmsnorm(a.reshape(-1, d), w_next, residual=x)

    h, x = fused_rmsnorm(x.reshape(-1, d), layers[0][2]["ln1"]["w"])
    for n, (b, i, lp) in enumerate(layers):
        w_next = (layers[n + 1][2]["ln1"]["w"] if n + 1 < len(layers)
                  else w_last)
        h, x = _remat(cfg, layer, h, x, b, i, lp, w_next)
    return (h if final_norm is not None else x).view(shape)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: save the 2-D projections' outputs, recompute the
    rest (the reference's ``dots_with_no_batch_dims_saveable``)."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, checkpointed as ``cfg.remat`` says while autograd
    records: "full" (recompute all of it in backward), "dots" (recompute
    all but the ``aten.mm`` outputs) or "none" (save everything)."""
    if not torch.is_grad_enabled() or cfg.remat == "none":
        return fn(*args)
    rules, mesh = current_rules(), current_mesh()
    if rules is not None:
        # backward recomputes the layer in autograd's own thread (a CUDA
        # tensor's), where the rules installed here are not: install them
        layer = fn

        def fn(*a):
            with use_rules(rules, mesh):
                return layer(*a)
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=partial(
            create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat {cfg.remat!r}: 'full', 'dots' or 'none'")


def _run_stack_layernorm(cfg, final_norm, x, mix, layers, dense_moe: bool,
                         cross) -> torch.Tensor:
    """The LayerNorm block: plain residual adds in the compute dtype and
    the plain ``layernorm``, each layer checkpointed per ``cfg.remat``
    (:func:`_remat`)."""
    _, norm = L.make_norm(cfg)

    def layer(x, b, i, lp):
        x = x + mix(b, i, lp, norm(lp["ln1"], x))
        if cross is not None and "xattn" in lp:
            x = x + cross(lp, norm(lp["lnx"], x))
        if "ln2" in lp:
            x = x + _ffn(cfg, lp, norm(lp["ln2"], x), dense_moe)
        return x

    for b, i, lp in layers:
        x = _remat(cfg, layer, x, b, i, lp)
    return norm(final_norm, x)


def _head(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """The tokens' embeddings in ``dtype``. Where a model axis shards the
    vocabulary, each rank looks up the tokens in its rows (zero for the
    others) and the sum over 'model' (exact: one term is not zero) puts
    every row together."""
    emb = params["embed"]
    mesh = L.model_mesh()
    if mesh is None or emb.shape[0] == cfg.vocab:
        return emb[tokens].to(dtype)
    v_l = emb.shape[0]
    local = tokens - mesh.index("model") * v_l
    mine = (local >= 0) & (local < v_l)
    x = emb[local.clamp(0, v_l - 1)] * mine[..., None]
    return pd.reduce_from(x, mesh.group("model")).to(dtype)


def _logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """h times the head: (..., V), or where a model axis shards the
    vocabulary this rank's block of it (..., V / m), as the reference's
    logits are sharded on 'vocab' (:func:`gather_vocab` puts them
    together)."""
    head = _head(cfg, params)
    mesh = L.model_mesh()
    if mesh is not None and head.shape[1] != cfg.vocab:
        h = pd.copy_to(h, mesh.group("model"))
    return L._mm(h, head)


def gather_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Logits over the whole vocabulary: a rank's block of them gathered
    over 'model' (a no-op where they are whole)."""
    mesh = L.model_mesh()
    if mesh is None or logits.shape[-1] == cfg.vocab:
        return logits
    return pd.all_gather(logits, -1, mesh.group("model"))


def _vocab_parallel_terms(logits: torch.Tensor, labels: torch.Tensor, mesh):
    """(logsumexp, gold logit) of f32 logits that are this rank's block of
    the vocabulary (Megatron's vocab-parallel cross-entropy): a MAX and two
    SUMs over 'model'."""
    import torch.distributed as dist
    g = mesh.group("model")
    v_l = logits.shape[-1]
    m = pd.all_reduce(logits.detach().amax(-1), g, op=dist.ReduceOp.MAX)
    se = pd.reduce_from(torch.exp(logits - m[..., None]).sum(-1), g)
    local = labels - mesh.index("model") * v_l
    mine = (local >= 0) & (local < v_l)
    gold = torch.gather(logits, -1, local.clamp(0, v_l - 1)[..., None])[..., 0]
    return m + torch.log(se), pd.reduce_from(gold * mine, g)


def _rope(cfg: ModelConfig, n: int, device):
    """RoPE tables of positions 0..n-1; None without attention."""
    if cfg.attention_free:
        return None
    pos = torch.arange(n, device=device)
    return L.rope_tables(pos, cfg.hd, cfg.rope_theta)


# ================================ forward ====================================
def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over (precomputed) frontend embeddings (B, T, d): its
    layers are self-attention without the causal mask (RoPE on positions
    0..T-1) and an MLP, then ``enc_final_norm``. Runs in the frames' dtype,
    as the reference does; the decoder casts the result to its compute
    dtype."""
    check_supported(cfg)
    rope = _rope(cfg, frames.shape[1], frames.device)

    def mix(b, i, lp, h):
        return L.self_attention(lp["attn"], h, cfg, rope, causal=False)[0]

    layers = [(0, i, lp) for i, lp in enumerate(params["enc_stack"])]
    return _stack(cfg, layers, params["enc_final_norm"], frames, mix)


def _cross(cfg: ModelConfig, memory: torch.Tensor | None):
    """The ``cross`` of :func:`_stack` for a whole sequence of queries over
    ``memory``, cast once to the compute dtype; None without a memory."""
    if memory is None:
        return None
    memory = memory.to(compute_dtype(cfg))
    return lambda lp, h: L.cross_attention(lp["xattn"], h, memory, cfg)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            memory: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: (B, S) int; memory: (B, M, d), the VLM's image embeddings or
    the encoder's output, for the cross-attention layers (skipped without
    it). Returns logits (B, S, V) in the compute dtype (this rank's block
    of V where a model axis shards the vocabulary)."""
    check_supported(cfg)
    dtype = compute_dtype(cfg)
    x = _embed(cfg, params, tokens, dtype)
    rope = _rope(cfg, tokens.shape[1], x.device)

    def mix(b, i, lp, h):
        if "ssm" in lp:
            return L.ssm_layer(lp["ssm"], h, cfg)[0]
        return L.self_attention(lp["attn"], h, cfg, rope)[0]

    h = _run_stack(cfg, params, x, mix, cross=_cross(cfg, memory))
    return _logits(cfg, params, h)


def forward_part(cfg: ModelConfig, params: dict, inp: torch.Tensor,
                 first: bool, last: bool) -> torch.Tensor:
    """The decoder over a contiguous part of its layers (an RMSNorm config
    without memory), for a model run in parts on one card: ``params`` from
    ``init_params(cfg, blocks=...)``, whose ``stack`` is the part's blocks.
    ``inp``: the tokens (B, S) where ``first``, else the residual stream
    (B, S, d) a previous part returned. Returns the logits where ``last``,
    else the residual stream after the part's last layer. The parts in
    order compute :func:`forward` but for one rounding: a part starts from
    the residual in the compute dtype, where the whole stack normalises the
    unrounded f32 sum (``fused_rmsnorm``)."""
    if cfg.norm != "rmsnorm":
        raise ValueError(f"forward_part: {cfg.name} is not an RMSNorm config")
    x = _embed(cfg, params, inp, compute_dtype(cfg)) if first else inp
    rope = _rope(cfg, x.shape[1], x.device)

    def mix(b, i, lp, h):
        if "ssm" in lp:
            return L.ssm_layer(lp["ssm"], h, cfg)[0]
        return L.self_attention(lp["attn"], h, cfg, rope)[0]

    h = _run_stack(cfg, params, x, mix) if last else _stack(
        cfg, list(_layers(cfg, params)), None, x, mix)
    return _logits(cfg, params, h) if last else h


def _memory_from_batch(cfg: ModelConfig, params: dict, batch: dict):
    """The memory ``loss_fn`` attends to: the batch's ``image_embeds`` for
    the VLM, the encoder's output over its ``audio_frames`` for the
    encoder-decoder, else None."""
    if cfg.family == "vlm":
        return batch["image_embeds"]
    if cfg.is_enc_dec:
        return encode(cfg, params, batch["audio_frames"])
    return None


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy over f32 logits (``logsumexp``),
    weighted by ``batch["mask"]`` where given; the memory from
    :func:`_memory_from_batch`. Vocabulary-sharded logits (a model axis)
    take the vocab-parallel cross-entropy."""
    memory = _memory_from_batch(cfg, params, batch)
    logits = forward(cfg, params, batch["tokens"], memory=memory).float()
    labels = batch["labels"].long()
    mesh = L.model_mesh()
    if mesh is not None and logits.shape[-1] != cfg.vocab:
        logz, gold = _vocab_parallel_terms(logits, labels, mesh)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(logz)
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)


# ============================= KV / state cache ==============================
@dataclasses.dataclass
class CacheSpec:
    """Where a block's layers keep their cache: ``attn_slots[i]`` is layer
    i's slot in ``k``/``v`` and ``ssm_slots[i]`` its slot in ``ssm``/
    ``conv`` (-1 where the layer is of the other kind)."""

    n_attn: int          # attention layers per block
    n_ssm: int           # SSM layers per block
    attn_slots: list
    ssm_slots: list

    def slot(self, i: int) -> int:
        """Layer i's slot in the cache entries of its kind."""
        return max(self.attn_slots[i], self.ssm_slots[i])


def cache_spec(cfg: ModelConfig) -> CacheSpec:
    """The reference's ``cache_spec``: each kind's layers take its slots in
    block order (Jamba's block of 8 keeps its attention layer, index 4, in
    slot 0 of ``k``/``v`` and its seven SSM layers in slots 0-6 of
    ``ssm``/``conv``)."""
    a, s, aslot, sslot = 0, 0, [], []
    for i in range(cfg.block_size):
        if cfg.layer_kind(i) == "attn":
            aslot.append(a)
            sslot.append(-1)
            a += 1
        else:
            aslot.append(-1)
            sslot.append(s)
            s += 1
    return CacheSpec(a, s, aslot, sslot)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """A zero cache for ``batch`` sequences of ``max_len`` positions. Under
    installed rules and a mesh, this rank's block of it as
    ``cache_shardings`` lays it out: the batch over the data axes (where
    they divide it) and, on a model axis of more than one rank, the
    sequence over 'model' (``max_len`` must be a multiple of it)."""
    check_supported(cfg)
    device = resolve_device(device)
    nb = cfg.n_blocks
    spec = cache_spec(cfg)
    mesh = current_mesh()
    if mesh is not None and current_rules() is not None:
        from ..launch.mesh import batch_axes
        n_data = mesh.size(batch_axes(mesh))
        if batch % n_data == 0:
            batch //= n_data
        m = mesh.size("model")
        if m > 1 and spec.n_attn:
            if max_len % m:
                raise ValueError(f"max_len {max_len}: the cache's sequence is "
                                 f"split over a model axis of {m}")
            max_len //= m
    cache: dict = {}
    if spec.n_attn:
        shape = (nb, spec.n_attn, batch, max_len, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if spec.n_ssm:
        d_in, n, h, hp = L.ssm_dims(cfg)
        if mesh is not None and current_rules() is not None and L.ssm_split(
                cfg, mesh.size("model")):      # this rank's heads
            h //= mesh.size("model")
            d_in = h * hp
        cache["ssm"] = torch.zeros((nb, spec.n_ssm, batch, h, hp, n),
                                   dtype=torch.float32, device=device)
        cache["conv"] = torch.zeros(
            (nb, spec.n_ssm, batch, cfg.ssm_conv - 1, d_in + 2 * n), dtype=dtype,
            device=device)
    return cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int | None = None, cache: dict | None = None,
            memory: torch.Tensor | None = None):
    """Logits for the prompt and a cache of ``max_len`` positions (default
    the prompt length) whose first S positions hold the prompt's K/V, and
    the SSM layers' state and convolution tail after the prompt. With
    ``cache`` (of ``init_cache``'s layout, for this batch and at least S
    positions), prefill writes into it in place and returns it; positions
    from S on keep what they held, which decode overwrites before it reads
    them. ``memory`` as for :func:`forward` (it is not cached: decode
    takes it again)."""
    b, s = tokens.shape
    check_supported(cfg)
    mesh = L.model_mesh()
    m = 1 if mesh is None else mesh.size("model")
    if cache is None:
        max_len = s if max_len is None else max_len
        if max_len < s:
            raise ValueError(f"max_len {max_len} < prompt length {s}")
        if mesh is not None:
            max_len = -(-max_len // m) * m
        cache = _local_rows_cache(cfg, b, max_len, tokens.device)
    else:
        _check_cache(cache, b, s, m)
    dtype = compute_dtype(cfg)
    x = _embed(cfg, params, tokens, dtype)
    rope = _rope(cfg, s, x.device)

    def mix(blk, slot, lp, h):
        if "ssm" in lp:
            out, state, tail = L.ssm_layer(lp["ssm"], h, cfg)
            cache["ssm"][blk, slot] = state
            cache["conv"][blk, slot] = tail
            return out
        out, k, v = L.self_attention(lp["attn"], h, cfg, rope)
        if mesh is None:
            cache["k"][blk, slot, :, :s] = k
            cache["v"][blk, slot, :, :s] = v
        else:
            _fill_sequence_block(cfg, cache, blk, slot, k, v, mesh)
        return out

    h = _run_stack(cfg, params, x, mix, cross=_cross(cfg, memory))
    return _logits(cfg, params, h), cache


def _local_rows_cache(cfg: ModelConfig, b: int, max_len: int, device) -> dict:
    """:func:`init_cache` for ``b`` local rows (the caller's block of the
    data axes): the batch it is given is already this rank's."""
    mesh = current_mesh()
    if mesh is not None and current_rules() is not None:
        from ..launch.mesh import batch_axes
        b *= mesh.size(batch_axes(mesh))
    return init_cache(cfg, b, max_len, device)


def _fill_sequence_block(cfg: ModelConfig, cache: dict, blk: int, slot: int,
                         k: torch.Tensor, v: torch.Tensor, mesh) -> None:
    """Write the prompt's K/V (B, S, this rank's kv heads, hd) into this
    rank's block of the sequence-sharded cache: the heads gathered over
    'model', the block's positions kept."""
    if k.shape[2] != cfg.n_kv_heads:        # every rank's heads, one gather
        k, v = pd.all_gather(torch.stack([k, v]), 3, mesh.group("model")).unbind(0)
    s_local = cache["k"].shape[3]
    lo = mesh.index("model") * s_local
    n = max(0, min(k.shape[1] - lo, s_local))
    if n:
        cache["k"][blk, slot, :, :n] = k[:, lo:lo + n]
        cache["v"][blk, slot, :, :n] = v[:, lo:lo + n]


def _check_cache(cache: dict, b: int, s: int, m: int = 1) -> None:
    """A cache given to prefill serves ``b`` sequences of ``s`` tokens (its
    sequence split over ``m`` ranks)."""
    for name, t in cache.items():
        if t.shape[2] != b:
            raise ValueError(f"cache {name!r} holds {t.shape[2]} sequences, the "
                             f"prompt batch {b}")
    if "k" in cache and cache["k"].shape[3] * m < s:
        raise ValueError(f"cache of {cache['k'].shape[3] * m} positions < prompt "
                         f"length {s}")


def position(pos, device) -> torch.Tensor:
    """The decode position as a (1,) int64 tensor on ``device``: a Python
    int is turned into one, a one-element integer tensor there is taken as
    it is (no host read)."""
    if not isinstance(pos, torch.Tensor):
        return torch.tensor([pos], dtype=torch.int64, device=device)
    if pos.numel() != 1 or pos.dtype.is_floating_point or pos.dtype.is_complex:
        raise ValueError(f"decode position: one integer, not {pos.dtype} of "
                         f"shape {tuple(pos.shape)}")
    if pos.device != device:
        raise ValueError(f"decode position on {pos.device}, the model on {device}")
    return pos.reshape(1).to(torch.int64)


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos, memory: torch.Tensor | None = None):
    """One autoregressive step. token: (B,) int; pos: the position being
    written, a one-element integer tensor on the model's device, or a Python
    int; memory: (B, M, d) as for :func:`forward`, read by address.
    Updates ``cache`` in place and returns (logits (B, V), cache).
    Reads nothing on the host: CUDA-graph capturable."""
    check_supported(cfg)
    dtype = compute_dtype(cfg)
    x = _embed(cfg, params, token, dtype)[:, None, :]      # (B, 1, d)
    pos = position(pos, x.device)
    if not cfg.attention_free:
        rope = L.rope_tables(pos, cfg.hd, cfg.rope_theta)
        kv_len = (pos + 1).to(torch.int32)

    def mix(blk, slot, lp, h):
        if "ssm" in lp:
            return L.ssm_decode_step(lp["ssm"], h, cache["ssm"][blk, slot],
                                     cache["conv"][blk, slot], cfg)[0]
        return L.decode_self_attention(lp["attn"], h, cache["k"][blk, slot],
                                       cache["v"][blk, slot], pos, cfg,
                                       rope, kv_len)[0]

    cross = None
    if memory is not None:          # every memory key, cast once
        memory = memory.to(dtype)
        mem_len = torch.full((1,), memory.shape[1], dtype=torch.int32,
                             device=x.device)

        def cross(lp, h):
            return L.decode_cross_attention(lp["xattn"], h, memory, cfg,
                                            mem_len)

    h = _run_stack(cfg, params, x, mix, dense_moe=True, cross=cross)
    return _logits(cfg, params, h[:, 0]), cache
