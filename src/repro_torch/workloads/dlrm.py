"""DLRM dataflow graph (paper §VI.C.2 — 793B-parameter recommendation model).

Structure (Mudigere et al. [61]): huge sparse embedding tables (model-parallel
→ all-to-all to redistribute pooled embeddings), bottom MLP on dense features,
pairwise feature interaction, top MLP. Embedding bytes dominate memory; the
all-to-all dominates the network (the paper's DLRM heatmaps show NVLink /
dragonfly winning for exactly this reason).
"""
from __future__ import annotations

from ..core.graph import DataflowGraph, Kernel, KernelKind, Tensor
from ..core.interchip import TrainWorkload

BYTES = 2


def dlrm_layer_graph(batch: int = 4096, n_tables: int = 856,
                     table_rows: float = 5e6, embed_dim: int = 128,
                     n_dense: int = 13, bottom_mlp=(512, 256, 128),
                     top_mlp=(1024, 1024, 512, 256, 1)) -> DataflowGraph:
    ks: list[Kernel] = []
    ts: list[Tensor] = []
    emb_out = batch * n_tables * embed_dim * BYTES

    ks.append(Kernel("EmbLookup", 2.0 * batch * n_tables * embed_dim,
                     KernelKind.EMBEDDING,
                     weight_bytes=n_tables * table_rows * embed_dim * BYTES))
    ks.append(Kernel("EmbA2A", 0.0, KernelKind.COMM))
    ts.append(Tensor("emb_pooled", "EmbLookup", "EmbA2A", emb_out))

    prev, prev_d = "EmbA2A", n_tables * embed_dim
    d_in = n_dense
    for i, d_out in enumerate(bottom_mlp):
        ks.append(Kernel(f"BotMLP{i}", 2.0 * batch * d_in * d_out,
                         KernelKind.GEMM, weight_bytes=d_in * d_out * BYTES,
                         gemm_dims=(batch, d_in, d_out)))
        if i:
            ts.append(Tensor(f"bot{i}", f"BotMLP{i-1}", f"BotMLP{i}",
                             batch * d_in * BYTES))
        d_in = d_out

    # pairwise interaction of (tables + 1) feature vectors
    f = n_tables + 1
    ks.append(Kernel("Interact", 2.0 * batch * f * f * embed_dim,
                     KernelKind.GEMM, gemm_dims=(f, embed_dim, f)))
    ts.append(Tensor("emb_feat", prev, "Interact", emb_out))
    ts.append(Tensor("bot_feat", f"BotMLP{len(bottom_mlp)-1}", "Interact",
                     batch * bottom_mlp[-1] * BYTES))

    d_in = f * (f - 1) // 2 + bottom_mlp[-1]
    prev = "Interact"
    prev_b = batch * d_in * BYTES
    for i, d_out in enumerate(top_mlp):
        ks.append(Kernel(f"TopMLP{i}", 2.0 * batch * d_in * d_out,
                         KernelKind.GEMM, weight_bytes=d_in * d_out * BYTES,
                         gemm_dims=(batch, d_in, d_out)))
        ts.append(Tensor(f"top{i}", prev, f"TopMLP{i}", prev_b))
        prev, prev_b, d_in = f"TopMLP{i}", batch * d_out * BYTES, d_out

    return DataflowGraph(ks, ts, f"dlrm_b{batch}")


def dlrm_workload(global_batch: int = 65536, microbatch: int = 4096,
                  params: float = 793e9) -> TrainWorkload:
    """793B DLRM: parameters dominated by embedding tables."""
    embed_dim = 128
    n_tables = 856
    rows = params / (n_tables * embed_dim)
    g = dlrm_layer_graph(batch=microbatch, n_tables=n_tables,
                         table_rows=rows, embed_dim=embed_dim)
    return TrainWorkload(name="dlrm_793b", layer_graph=g, n_layers=1,
                         global_batch=global_batch, microbatch=microbatch,
                         # embedding grads are sparse → tiny DP traffic;
                         # approximate with dense MLP grads only via mult
                         optimizer_bytes_per_param_byte=1.5)
