"""LLM dataflow-graph builders (paper Fig 2A generalized).

Builds the per-layer kernel graph {QKV, MHA1, Softmax, MHA2, Proj, FFN0,
FFN1, Add} for one microbatch, extended for GQA, MoE (router + expert GEMMs),
Mamba2/SSD layers, cross-attention (VLM / enc-dec), and decode-phase graphs
(one token against a KV cache). All FLOPs are forward-pass; byte sizes are
bf16 activations unless noted.
"""
from __future__ import annotations

import dataclasses

from ..core.graph import DataflowGraph, Kernel, KernelKind, Tensor

BYTES = 2  # bf16


@dataclasses.dataclass(frozen=True)
class LLMShape:
    """Model + batch geometry for graph building."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    seq: int = 2048
    batch: int = 1                   # sequences per microbatch
    moe_experts: int = 0
    moe_top_k: int = 0
    d_head: int | None = None
    gated: bool = True           # SwiGLU (3 FFN mats) vs classic GELU MLP (2)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def params(self) -> float:
        """Approximate parameter count (weights only)."""
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        if self.moe_experts:
            ffn = self.moe_experts * 3 * d * self.d_ff + d * self.moe_experts
        else:
            ffn = 3 * d * self.d_ff  # gated MLP (SwiGLU-style)
        return self.n_layers * (attn + ffn) + 2 * self.vocab * d

    @property
    def active_params(self) -> float:
        d = self.d_model
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        if self.moe_experts:
            ffn = self.moe_top_k * 3 * d * self.d_ff + d * self.moe_experts
        else:
            ffn = 3 * d * self.d_ff
        return self.n_layers * (attn + ffn) + 2 * self.vocab * d


def gpt_layer_graph(s: LLMShape, causal: bool = True,
                    cross_attention: bool = False) -> DataflowGraph:
    """One transformer layer for one microbatch of s.batch sequences."""
    T = s.batch * s.seq                      # tokens in the microbatch
    d, hd = s.d_model, s.head_dim
    q_dim, kv_dim = s.n_heads * hd, s.n_kv_heads * hd
    att_factor = 0.5 if causal else 1.0      # causal masking halves the work

    ks: list[Kernel] = []
    ts: list[Tensor] = []

    def K(name, flops, kind, weight_bytes=0.0, gemm_dims=None):
        ks.append(Kernel(name, flops, kind, weight_bytes, gemm_dims))

    def E(name, src, dst, b):
        ts.append(Tensor(name, src, dst, b))

    K("LN1", 5.0 * T * d, KernelKind.NORM)
    K("QKV", 2.0 * T * d * (q_dim + 2 * kv_dim), KernelKind.GEMM,
      weight_bytes=d * (q_dim + 2 * kv_dim) * BYTES, gemm_dims=(T, d, q_dim + 2 * kv_dim))
    # fused attention region kept as explicit kernels (the intra-chip pass
    # decides to fuse them — FlashAttention correspondence). MHA1/MHA2 are
    # ATTENTION kind: head-sharded under TP (Megatron), no weights.
    K("MHA1", 2.0 * T * s.seq * q_dim * att_factor, KernelKind.ATTENTION,
      gemm_dims=(T, hd, s.seq))
    K("Softmax", 5.0 * T * s.seq * s.n_heads * att_factor, KernelKind.SOFTMAX)
    K("MHA2", 2.0 * T * s.seq * q_dim * att_factor, KernelKind.ATTENTION,
      gemm_dims=(T, s.seq, hd))
    K("Proj", 2.0 * T * q_dim * d, KernelKind.GEMM, weight_bytes=q_dim * d * BYTES,
      gemm_dims=(T, q_dim, d))
    K("Add1", T * d, KernelKind.ELEMENTWISE)
    K("LN2", 5.0 * T * d, KernelKind.NORM)

    E("x_ln1", "LN1", "QKV", T * d * BYTES)
    E("qkv_scores", "QKV", "MHA1", T * (q_dim + 2 * kv_dim) * BYTES)
    E("scores", "MHA1", "Softmax", T * s.seq * s.n_heads * BYTES * att_factor)
    E("probs", "Softmax", "MHA2", T * s.seq * s.n_heads * BYTES * att_factor)
    E("attn_out", "MHA2", "Proj", T * q_dim * BYTES)
    E("proj_out", "Proj", "Add1", T * d * BYTES)
    E("resid1", "Add1", "LN2", T * d * BYTES)

    prev = "LN2"
    if cross_attention:
        K("XQ", 2.0 * T * d * q_dim, KernelKind.GEMM, weight_bytes=d * q_dim * BYTES,
          gemm_dims=(T, d, q_dim))
        K("XAttn", 4.0 * T * s.seq * q_dim, KernelKind.ATTENTION,
          gemm_dims=(T, hd, s.seq))
        K("XProj", 2.0 * T * q_dim * d, KernelKind.GEMM,
          weight_bytes=(q_dim * d + 2 * d * kv_dim) * BYTES, gemm_dims=(T, q_dim, d))
        K("AddX", T * d, KernelKind.ELEMENTWISE)
        K("LNX", 5.0 * T * d, KernelKind.NORM)
        E("x_xq", "LN2", "XQ", T * d * BYTES)
        E("xq_attn", "XQ", "XAttn", T * q_dim * BYTES)
        E("xattn_out", "XAttn", "XProj", T * q_dim * BYTES)
        E("xproj_out", "XProj", "AddX", T * d * BYTES)
        E("residx", "AddX", "LNX", T * d * BYTES)
        prev = "LNX"

    if s.moe_experts:
        K("Router", 2.0 * T * d * s.moe_experts, KernelKind.ROUTER,
          weight_bytes=d * s.moe_experts * BYTES)
        # top-k experts each run a gated MLP on its share of tokens
        tok_flops = 2.0 * (T * s.moe_top_k) * d * s.d_ff * 3
        K("FFN0", tok_flops * 2 / 3, KernelKind.GEMM,
          weight_bytes=s.moe_experts * 2 * d * s.d_ff * BYTES,
          gemm_dims=(T * s.moe_top_k, d, s.d_ff))
        K("FFN1", tok_flops * 1 / 3, KernelKind.GEMM,
          weight_bytes=s.moe_experts * s.d_ff * d * BYTES,
          gemm_dims=(T * s.moe_top_k, s.d_ff, d))
        K("Add2", T * d, KernelKind.ELEMENTWISE)
        E("x_rt", prev, "Router", T * d * BYTES)
        E("dispatched", "Router", "FFN0", T * s.moe_top_k * d * BYTES)
        E("ffn_mid", "FFN0", "FFN1", T * s.moe_top_k * s.d_ff * BYTES)
        E("ffn_out", "FFN1", "Add2", T * d * BYTES)
    else:
        up = 2 if s.gated else 1   # SwiGLU has gate+up projections
        K("FFN0", 2.0 * T * d * s.d_ff * up, KernelKind.GEMM,
          weight_bytes=up * d * s.d_ff * BYTES, gemm_dims=(T, d, s.d_ff))
        K("FFN1", 2.0 * T * s.d_ff * d, KernelKind.GEMM,
          weight_bytes=s.d_ff * d * BYTES, gemm_dims=(T, s.d_ff, d))
        K("Add2", T * d, KernelKind.ELEMENTWISE)
        E("x_ffn", prev, "FFN0", T * d * BYTES)
        E("ffn_mid", "FFN0", "FFN1", T * s.d_ff * BYTES)
        E("ffn_out", "FFN1", "Add2", T * d * BYTES)

    return DataflowGraph(ks, ts, f"{s.name}_layer_s{s.seq}_b{s.batch}")


def mamba_layer_graph(s: LLMShape, d_state: int = 128,
                      expand: int = 2) -> DataflowGraph:
    """Mamba2 (SSD) layer: in-proj, conv, SSD chunk scan, gate, out-proj."""
    T = s.batch * s.seq
    d = s.d_model
    d_in = expand * d
    ks = [
        Kernel("InProj", 2.0 * T * d * (2 * d_in + 2 * d_state), KernelKind.GEMM,
               weight_bytes=d * (2 * d_in + 2 * d_state) * BYTES,
               gemm_dims=(T, d, 2 * d_in)),
        Kernel("Conv1d", 2.0 * T * d_in * 4, KernelKind.ELEMENTWISE,
               weight_bytes=d_in * 4 * BYTES),
        Kernel("SSD", 6.0 * T * d_in * d_state, KernelKind.SCAN,
               gemm_dims=(T, d_state, d_in)),
        Kernel("Gate", T * d_in * 3.0, KernelKind.ELEMENTWISE),
        Kernel("OutProj", 2.0 * T * d_in * d, KernelKind.GEMM,
               weight_bytes=d_in * d * BYTES, gemm_dims=(T, d_in, d)),
    ]
    ts = [
        Tensor("xz", "InProj", "Conv1d", T * d_in * BYTES),
        Tensor("xc", "Conv1d", "SSD", T * d_in * BYTES),
        Tensor("y_ssd", "SSD", "Gate", T * d_in * BYTES),
        Tensor("y_gate", "Gate", "OutProj", T * d_in * BYTES),
    ]
    return DataflowGraph(ks, ts, f"{s.name}_mamba_s{s.seq}_b{s.batch}")


def decode_layer_graph(s: LLMShape, kv_len: int,
                       cross_attention: bool = False) -> DataflowGraph:
    """One layer of single-token decode for a batch of s.batch requests.

    KV cache reads dominate: MHA kernels stream kv_len keys/values per head.
    """
    B = s.batch
    d, hd = s.d_model, s.head_dim
    q_dim, kv_dim = s.n_heads * hd, s.n_kv_heads * hd
    ks = [
        Kernel("QKV", 2.0 * B * d * (q_dim + 2 * kv_dim), KernelKind.GEMM,
               weight_bytes=d * (q_dim + 2 * kv_dim) * BYTES, gemm_dims=(B, d, q_dim)),
        Kernel("AttnDec", 4.0 * B * kv_len * q_dim, KernelKind.ATTENTION,
               gemm_dims=(B * s.n_heads, hd, kv_len)),
        Kernel("Proj", 2.0 * B * q_dim * d, KernelKind.GEMM,
               weight_bytes=q_dim * d * BYTES, gemm_dims=(B, q_dim, d)),
    ]
    ts = [
        Tensor("q", "QKV", "AttnDec", B * q_dim * BYTES),
        Tensor("attn_out", "AttnDec", "Proj", B * q_dim * BYTES),
    ]
    # KV cache traffic is modeled as kernel 'weight' bytes of AttnDec (it
    # streams from DRAM each step, exactly like weights):
    ks[1] = dataclasses.replace(
        ks[1], weight_bytes=2.0 * B * kv_len * kv_dim * BYTES)
    if s.moe_experts:
        ks.append(Kernel("Router", 2.0 * B * d * s.moe_experts,
                         KernelKind.ROUTER, weight_bytes=d * s.moe_experts * BYTES))
        ks.append(Kernel("FFN", 2.0 * B * s.moe_top_k * 3 * d * s.d_ff,
                         KernelKind.GEMM,
                         weight_bytes=s.moe_experts * 3 * d * s.d_ff * BYTES,
                         gemm_dims=(B * s.moe_top_k, d, s.d_ff)))
        ts.append(Tensor("x_rt", "Proj", "Router", B * d * BYTES))
        ts.append(Tensor("disp", "Router", "FFN",
                         B * s.moe_top_k * d * BYTES))
    else:
        ks.append(Kernel("FFN", 2.0 * B * 3 * d * s.d_ff, KernelKind.GEMM,
                         weight_bytes=3 * d * s.d_ff * BYTES, gemm_dims=(B, d, s.d_ff)))
        ts.append(Tensor("x_ffn", "Proj", "FFN", B * d * BYTES))
    return DataflowGraph(ks, ts, f"{s.name}_decode_kv{kv_len}_b{B}")


def embedding_graph(s: LLMShape) -> DataflowGraph:
    T = s.batch * s.seq
    return DataflowGraph(
        [Kernel("Embed", 2.0 * T * s.d_model, KernelKind.EMBEDDING,
                weight_bytes=s.vocab * s.d_model * BYTES)],
        [], f"{s.name}_embed")


def lm_head_graph(s: LLMShape) -> DataflowGraph:
    T = s.batch * s.seq
    return DataflowGraph(
        [Kernel("LMHead", 2.0 * T * s.d_model * s.vocab, KernelKind.GEMM,
                weight_bytes=s.vocab * s.d_model * BYTES, gemm_dims=(T, s.d_model, s.vocab))],
        [], f"{s.name}_head")


def gpt_workload(s: LLMShape, global_batch: int,
                 microbatch: int = 1):
    """Full training workload (paper's GPT3 setups)."""
    from ..core.interchip import TrainWorkload
    ms = dataclasses.replace(s, batch=microbatch)
    return TrainWorkload(
        name=s.name,
        layer_graph=gpt_layer_graph(ms),
        n_layers=s.n_layers,
        global_batch=global_batch,
        microbatch=microbatch,
        pre_graph=embedding_graph(ms),
        post_graph=lm_head_graph(ms),
    )


def mamba_workload(s: LLMShape, global_batch: int, microbatch: int = 1,
                   d_state: int = 128, expand: int = 2):
    """Mamba2/SSD training workload: attention-free layers, same embedding
    and LM-head blocks as the transformer setups."""
    from ..core.interchip import TrainWorkload
    ms = dataclasses.replace(s, batch=microbatch)
    return TrainWorkload(
        name=s.name,
        layer_graph=mamba_layer_graph(ms, d_state=d_state, expand=expand),
        n_layers=s.n_layers,
        global_batch=global_batch,
        microbatch=microbatch,
        pre_graph=embedding_graph(ms),
        post_graph=lm_head_graph(ms),
    )


def decode_workload(s: LLMShape, kv_len: int, global_batch: int,
                    microbatch: int = 1, lm_head: bool = False):
    """Serving/decode-phase workload: one token per request against a
    ``kv_len`` KV cache, ``microbatch`` requests per pipeline microbatch.

    Inference-only semantics: no backward pass (``bwd_flop_mult=0``), no
    optimizer state, and no DP gradient all-reduce — DP replicas serve
    disjoint request streams. ``global_batch`` is the number of requests
    per 'iteration' (one decode step across the serving batch).

    ``lm_head=True`` adds the embedding/LM-head blocks at one token per
    request — the executable decode step runs them every step, and for
    small-vocab-dominated shapes the head is comparable to all layers
    combined, so validation against measured execution must include it.
    """
    from ..core.interchip import TrainWorkload
    ms = dataclasses.replace(s, batch=microbatch)
    tok = dataclasses.replace(s, batch=microbatch, seq=1)
    return TrainWorkload(
        name=f"{s.name}_decode",
        layer_graph=decode_layer_graph(ms, kv_len),
        n_layers=s.n_layers,
        global_batch=global_batch,
        microbatch=microbatch,
        pre_graph=embedding_graph(tok) if lm_head else None,
        post_graph=lm_head_graph(tok) if lm_head else None,
        bwd_flop_mult=0.0,
        bwd_comm_mult=0.0,
        optimizer_bytes_per_param_byte=0.0,
        dp_allreduce=False,
    )


def mamba_decode_workload(s: LLMShape, global_batch: int,
                          microbatch: int = 1, d_state: int = 128,
                          expand: int = 2, lm_head: bool = False):
    """Mamba2/SSD decode workload: one token per request, recurrent state
    instead of a KV cache (the per-step SSD cost is ``seq``-independent, so
    the seq=1 layer graph *is* the decode graph). Same inference-only
    semantics as :func:`decode_workload`."""
    from ..core.interchip import TrainWorkload
    tok = dataclasses.replace(s, batch=microbatch, seq=1)
    return TrainWorkload(
        name=f"{s.name}_decode",
        layer_graph=mamba_layer_graph(tok, d_state=d_state, expand=expand),
        n_layers=s.n_layers,
        global_batch=global_batch,
        microbatch=microbatch,
        pre_graph=embedding_graph(tok) if lm_head else None,
        post_graph=lm_head_graph(tok) if lm_head else None,
        bwd_flop_mult=0.0,
        bwd_comm_mult=0.0,
        optimizer_bytes_per_param_byte=0.0,
        dp_allreduce=False,
    )


# --- named shapes from the paper ---------------------------------------------
GPT3_175B = LLMShape("gpt3_175b", 96, 12288, 96, 96, 4 * 12288, 50257,
                     seq=2048, gated=False)
GPT3_1T = LLMShape("gpt3_1t", 128, 25600, 160, 160, 4 * 25600, 51200,
                   seq=2048, gated=False)
GPT_100T = LLMShape("gpt_100t", 512, 80000, 500, 500, 4 * 80000, 51200,
                    seq=2048, gated=False)
LLAMA3_8B = LLMShape("llama3_8b", 32, 4096, 32, 8, 14336, 128256, seq=8192)
LLAMA3_70B = LLMShape("llama3_70b", 80, 8192, 64, 8, 28672, 128256, seq=8192)
LLAMA3_405B = LLMShape("llama3_405b", 126, 16384, 128, 8, 53248, 128256,
                       seq=8192)
LLAMA_68M = LLMShape("llama_68m", 2, 768, 12, 12, 3072, 32000, seq=2048)
