"""DFModel planning for the production cells: the paper's optimizer
driving the real system (the reference's ``launch/plan.py``).

``plan_cell`` builds the architecture's dataflow graph, runs the two-level
optimization against a production system, and returns the prediction
(iteration time / utilization / bottleneck / fusion partitions). The dry
run (``launch/dryrun.py``) stores it next to its own roofline so that
model and system can be compared cell by cell. The system is the
reference's TPU v5e pods by default (``v5e_system``, tensor parallelism 16)
or H100 nodes (``h100_system``, NVLink within a node of 8, planned at
tensor parallelism 8). Numpy only.
"""
from __future__ import annotations

import dataclasses

from ..configs import SHAPES, get_config
from ..core.graph import DataflowGraph, Tensor
from ..core.interchip import TrainWorkload, _subdivide_dims, evaluate_plan
from ..core.intrachip import optimize_intra_chip
from ..core.sharding import solve_sharding
from ..models.config import ModelConfig
from ..systems.chips import H100, HBM, HBM_V5E, ICI, NVLINK, TPU_V5E
from ..systems.system import SystemSpec
from ..systems.topology import Topology, TopologyDim, dgx1
from ..workloads.llm import (LLMShape, decode_layer_graph, embedding_graph,
                             gpt_layer_graph, lm_head_graph,
                             mamba_layer_graph)


def v5e_system(multi_pod: bool = False) -> SystemSpec:
    dims = [TopologyDim(16, "ring", ICI), TopologyDim(16, "ring", ICI)]
    if multi_pod:
        dims.append(TopologyDim(2, "ring", ICI))
    topo = Topology("v5e_pod" + ("2" if multi_pod else "1"), tuple(dims))
    return SystemSpec(topo.name, TPU_V5E, HBM_V5E, topo)


def h100_system(multi_pod: bool = False) -> SystemSpec:
    """As many H100s as ``v5e_system``'s TPUs (256, or 512 with
    ``multi_pod``), in NVLink nodes of 8 (``dgx1``), each with HBM."""
    topo = dgx1(512 if multi_pod else 256, NVLINK)
    return SystemSpec(f"h100_{topo.name}", H100, HBM, topo)


def _llm_shape(cfg: ModelConfig, seq: int, batch: int) -> LLMShape:
    return LLMShape(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_ff=cfg.d_ff or 1, vocab=cfg.vocab, seq=seq, batch=batch,
        moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
        d_head=cfg.head_dim, gated=cfg.gated)


def _concat(graphs: list[DataflowGraph], name: str) -> DataflowGraph:
    """Sequentially chain per-layer graphs into one block graph."""
    ks, ts = [], []
    prev_last = None
    for li, g in enumerate(graphs):
        ren = {k.name: f"L{li}_{k.name}" for k in g.kernels}
        ks += [dataclasses.replace(k, name=ren[k.name]) for k in g.kernels]
        ts += [Tensor(f"L{li}_{t.name}", ren[t.src], ren[t.dst], t.bytes_)
               for t in g.tensors]
        first = ren[g.kernels[g.topo_order[0]].name]
        if prev_last is not None:
            ts.append(Tensor(f"chain{li}", prev_last, first,
                             g.tensors[0].bytes_ if g.tensors else 0.0))
        prev_last = ren[g.kernels[g.topo_order[-1]].name]
    return DataflowGraph(ks, ts, name)


def block_graph(cfg: ModelConfig, seq: int, batch: int) -> DataflowGraph:
    """One repeated block (cfg.block_size layers) as a dataflow graph."""
    s = _llm_shape(cfg, seq, batch)
    per_layer = []
    for i in range(cfg.block_size):
        moe = cfg.layer_is_moe(i)
        ls = dataclasses.replace(
            s, moe_experts=cfg.moe_experts if moe else 0,
            moe_top_k=cfg.moe_top_k if moe else 0,
            d_ff=cfg.d_ff if cfg.d_ff else 1)
        if cfg.layer_kind(i) == "ssm":
            g = mamba_layer_graph(ls, d_state=cfg.ssm_state,
                                  expand=cfg.ssm_expand)
            if cfg.d_ff:
                g = _concat([g, gpt_layer_graph(
                    dataclasses.replace(ls, n_layers=1))], f"ssm_ffn{i}")
        else:
            g = gpt_layer_graph(ls, cross_attention=cfg.layer_is_cross(i))
        per_layer.append(g)
    if len(per_layer) == 1:
        return per_layer[0]
    return _concat(per_layer, f"{cfg.name}_block")


def plan_cell(arch: str, shape_name: str, multi_pod: bool,
              system: SystemSpec | None = None, tp: int = 16) -> dict:
    """The plan of one (arch, shape) cell on ``system`` (default
    ``v5e_system(multi_pod)``) at tensor parallelism ``tp``, the rest of
    the chips data parallel."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if system is None:
        system = v5e_system(multi_pod)
    n_chips = system.n_chips
    dp = n_chips // tp

    if shape.phase == "train":
        micro = max(1, shape.global_batch // dp)
        work = TrainWorkload(
            name=f"{arch}_{shape_name}",
            layer_graph=block_graph(cfg, shape.seq_len, micro),
            n_layers=cfg.n_blocks,
            global_batch=shape.global_batch,
            microbatch=micro,
            pre_graph=embedding_graph(_llm_shape(cfg, shape.seq_len, micro)),
            post_graph=lm_head_graph(_llm_shape(cfg, shape.seq_len, micro)))
        cands = _subdivide_dims(system.topology, (tp, 1, dp), True)
        tp_topo, pp_topo, dp_topo = cands[0]
        plan = evaluate_plan(work, system, tp, 1, dp, tp_topo, pp_topo,
                             dp_topo)
        if plan is None:
            return {"error": "no feasible plan"}
        return {
            "tp": plan.tp, "pp": plan.pp, "dp": plan.dp,
            "iter_time_s": plan.iter_time,
            "utilization": plan.utilization,
            "breakdown": plan.breakdown,
            "per_chip_mem_gb": plan.per_chip_mem_bytes / 1e9,
            "feasible": plan.feasible,
        }

    # serving cells: intra-chip view of one layer/block on the TP group
    s = _llm_shape(cfg, shape.seq_len,
                   max(1, shape.global_batch // dp))
    if shape.phase == "prefill":
        graph = block_graph(cfg, shape.seq_len,
                            max(1, shape.global_batch // dp))
    else:
        graph = decode_layer_graph(s, kv_len=shape.seq_len)
    cands = _subdivide_dims(system.topology, (tp, 1, dp), True)
    tp_topo = cands[0][0]
    sol = solve_sharding(graph, tp, tp_topo, list(range(len(tp_topo.dims))))
    sharded = DataflowGraph(
        [dataclasses.replace(k, flops=k.flops * sch.flop_factor,
                             weight_bytes=k.weight_bytes * sch.weight_factor)
         for k, sch in zip(graph.kernels, sol.schemes)],
        [dataclasses.replace(t, bytes_=t.bytes_ / tp) for t in graph.tensors],
        graph.name + f"_tp{tp}")
    res = optimize_intra_chip(sharded, system.chip, system.memory,
                              h_n=sol.h_n, h_m=sol.h_m, mode="dataflow")
    kbk = optimize_intra_chip(sharded, system.chip, system.memory,
                              h_n=sol.h_n, h_m=sol.h_m, mode="kbk")
    reps = cfg.n_blocks if shape.phase == "prefill" else cfg.n_layers
    return {
        "tp": tp, "dp": dp,
        "per_block_time_s": res.total_time,
        "total_time_s": res.total_time * reps,
        "bottleneck": res.bottleneck,
        "n_partitions": res.n_partitions,
        "kbk_time_s": kbk.total_time * reps,
        "dataflow_speedup_vs_kbk": kbk.total_time / max(res.total_time, 1e-12),
    }
