"""LLM serving performance model (paper §VIII.A, Fig 20) and speculative
decoding model (§VIII.B, Fig 21).

Prefill resembles one training forward pass; decode is one token per step
against a KV cache. Metrics: TTFT, TPOT, and system throughput (tokens/s),
as functions of (TP, PP) on a serving system.
"""
from __future__ import annotations

import dataclasses
import math

from ..systems.system import SystemSpec
from ..systems.topology import Topology
from .graph import DataflowGraph
from .interchip import _subdivide_dims
from .intrachip import optimize_intra_chip
from .sharding import solve_sharding
from .utilization import kernel_utilization

import numpy as np


@dataclasses.dataclass
class ServingPoint:
    tp: int
    pp: int
    ttft: float                 # s (prefill latency, one request)
    tpot: float                 # s per output token (decode latency)
    prefill_throughput: float   # tokens/s across the system
    decode_throughput: float    # tokens/s across the system
    breakdown_prefill: dict[str, float]
    breakdown_decode: dict[str, float]


def _phase_time(graph: DataflowGraph, system: SystemSpec, tp: int,
                tp_topo: Topology, execution: str = "dataflow",
                p_max: int = 8,
                n_streams: int = 16,
                sram_headroom: float = 0.9) -> tuple[float, dict[str, float]]:
    """Per-layer latency of one phase on a TP group + breakdown fractions."""
    dims = list(range(len(tp_topo.dims)))
    shard = solve_sharding(graph, tp, tp_topo, dims)
    sharded = graph.scaled(flop_scale=1.0, bytes_scale=1.0)  # shapes via h_*
    # per-chip flops applied through scheme factors:
    import dataclasses as _dc
    ks = [_dc.replace(k, flops=k.flops * s.flop_factor,
                      weight_bytes=k.weight_bytes * s.weight_factor)
          for k, s in zip(graph.kernels, shard.schemes)]
    ts = [_dc.replace(t, bytes_=t.bytes_ / tp) for t in graph.tensors]
    per_chip = DataflowGraph(ks, ts, graph.name + f"_tp{tp}")
    intra = optimize_intra_chip(per_chip, system.chip, system.memory,
                                h_n=shard.h_n, h_m=shard.h_m,
                                mode=execution, p_max=p_max,
                                n_streams=n_streams,
                                sram_headroom=sram_headroom)
    total = float(intra.t_critical.sum())
    denom = intra.t_comp.sum() + intra.t_mem.sum() + intra.t_net.sum()
    frac = {
        "compute": float(intra.t_comp.sum() / denom) if denom else 0.0,
        "memory": float(intra.t_mem.sum() / denom) if denom else 0.0,
        "network": float(intra.t_net.sum() / denom) if denom else 0.0,
    }
    return total, frac


def serving_sweep(prefill_layer: DataflowGraph, decode_layer: DataflowGraph,
                  n_layers: int, system: SystemSpec,
                  batch: int = 1, execution: str = "dataflow",
                  net_latency: float = 150e-9) -> list[ServingPoint]:
    """Sweep (TP, PP) with TP·PP == n_chips (paper Fig 20)."""
    n = system.n_chips
    out: list[ServingPoint] = []
    for tp in [d for d in range(1, n + 1) if n % d == 0]:
        pp = n // tp
        if pp > n_layers:
            continue
        cand = _subdivide_dims(system.topology, (tp, pp, 1), True)
        if not cand:
            continue
        tp_topo, pp_topo, _ = cand[0]
        layers_per_stage = math.ceil(n_layers / pp)
        # all resident layers of a stage share the chip's SRAM equally
        headroom = 0.9 / layers_per_stage
        t_pre, f_pre = _phase_time(prefill_layer, system, tp, tp_topo,
                                   execution, sram_headroom=headroom)
        # decode: one token per step — spilled weights and the KV cache are
        # re-streamed every step (no cross-microbatch amortization)
        t_dec, f_dec = _phase_time(decode_layer, system, tp, tp_topo,
                                   execution, n_streams=1,
                                   sram_headroom=headroom)
        stage_pre = t_pre * layers_per_stage
        stage_dec = t_dec * layers_per_stage + (net_latency if pp > 1 else 0.0)
        # TTFT: one request flows through all pp stages
        ttft = stage_pre * pp
        # TPOT: one token must traverse the whole pipeline (autoregressive)
        tpot = stage_dec * pp
        # throughput: pipeline accepts a new microbatch every stage time
        seq = _seq_of(prefill_layer)
        prefill_tp = batch * seq / stage_pre if stage_pre else 0.0
        decode_tp = batch / stage_dec if stage_dec else 0.0
        out.append(ServingPoint(tp, pp, ttft, tpot, prefill_tp, decode_tp,
                                f_pre, f_dec))
    return out


def _seq_of(graph: DataflowGraph) -> int:
    # sequence length is carried in the graph name by the builders (s<len>)
    import re
    m = re.search(r"_s(\d+)", graph.name)
    return int(m.group(1)) if m else 1


# ---------------- speculative decoding (paper §VIII.B, Fig 21) --------------
@dataclasses.dataclass
class SpecDecodePoint:
    scheme: str            # 'sequence' | 'tree'
    window: int            # K
    acceptance: float      # per-token acceptance rate
    tokens_per_s: float


def expected_accepted(window: int, acceptance: float, scheme: str) -> float:
    """Expected tokens emitted per verify step (+1 for the bonus token).

    sequence: 1 + a + a² + ... + a^K  (geometric, Leviathan et al. [50])
    tree (SpecInfer): path diversity boosts the effective per-step acceptance;
    we model the best-of-2^K tree as acceptance a_t = 1-(1-a)^2 per level.
    """
    if scheme == "sequence":
        return sum(acceptance ** k for k in range(window + 1))
    a_t = 1.0 - (1.0 - acceptance) ** 2
    return sum(a_t ** k for k in range(window + 1))


def speculative_throughput(t_draft_token: float, t_target_verify: float,
                           window: int, acceptance: float,
                           scheme: str = "sequence") -> float:
    """tokens/s of draft-then-verify decoding.

    draft cost: K tokens sequentially (sequence) or 2^K-1 tokens in a tree —
    tree drafting batches siblings but must still expand level by level; we
    charge K sequential levels with width-driven extra compute.
    """
    if scheme == "sequence":
        t_draft = window * t_draft_token
        verify_mult = 1.0 + 0.02 * window           # K+1 tokens in one pass
    else:
        width_cost = (2 ** window - 1) / max(window, 1)
        t_draft = window * t_draft_token * max(1.0, width_cost / 4.0)
        verify_mult = 1.0 + 0.05 * (2 ** window) / 8.0  # tree attention cost
    t_step = t_draft + t_target_verify * verify_mult
    return expected_accepted(window, acceptance, scheme) / t_step
