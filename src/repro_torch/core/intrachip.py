"""Intra-chip optimization pass (paper §V).

Given the per-chip subgraph (kernels with sharded FLOPs f', tensors with
sharded bytes b' for one streaming microbatch), partition it into sequential
*dataflow partitions*. Within a partition, kernels are fused and pipelined:
compute, DRAM transfer and network fully overlap, so the partition latency is

    t_cri = max(t_comp, t_mem, t_net)                       (§V.B.4)

with
    t_comp = Σ_k (f'_k / u_k) / (t_lim · t_flop)   — optimal tile allocation:
             minimizing max_k f'_k/(t_k·t_flop·u_k) s.t. Σ t_k ≤ t_lim gives
             t_k ∝ f'_k/u_k, hence the sum form (closed form of §V.B.1's max).
    t_mem  = (Dᵀb' cross-partition traffic + streamed weights/n_streams) / d_bw
    t_net  = Σ_k∈p h_n[k] + Σ_j∈p h_m[j]            (inherited from inter-chip)

Constraints: buffer_factor·Bᵀb' + pinned weights ≤ s_cap (SRAM; the streaming
pipeline double-buffers inter-kernel tensors), Lᵀb' ≤ d_cap (DRAM).

Weight handling (TPU adaptation; DESIGN.md §3): as much of a partition's
weights as fits in leftover SRAM is pinned; the remainder streams from DRAM.
A resident partition processes ``n_streams`` microbatches before the chip
reconfigures to the next partition, so streamed-weight traffic is amortized
by 1/n_streams — this is the "less memory traffic" advantage of dataflow
execution (paper §II.B) and what drives Fig 19's SRAM sweep.

The objective min Σ_p max(...) is solved exactly by interval DP over the
topological order (``solver.minsum_partition``); branch & bound over the full
assignment-matrix space certifies optimality for small graphs in tests.

Non-dataflow (kernel-by-kernel, Fig 2D) mode: every kernel is its own
partition and *nothing overlaps*: t_k = t_comp_k + t_mem_k + t_net_k with all
inputs/outputs/weights hitting DRAM every microbatch — the Calculon-style
baseline the paper compares against.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..systems.chips import ChipSpec, MemorySpec
from .graph import DataflowGraph
from .solver import bounds_to_assign, minsum_partition
from .utilization import kernel_utilizations


@dataclasses.dataclass
class IntraChipResult:
    assign: np.ndarray              # kernel -> partition id (graph order)
    n_partitions: int
    t_comp: np.ndarray              # per-partition seconds (per microbatch)
    t_mem: np.ndarray
    t_net: np.ndarray
    t_critical: np.ndarray          # max of the three per partition
    total_time: float               # Σ t_critical  (§V objective)
    sram_used: np.ndarray           # per-partition bytes (incl. pinned weights)
    dram_traffic: float             # bytes per microbatch
    mode: str                       # 'dataflow' | 'kbk'

    @property
    def bottleneck(self) -> str:
        tot = {"compute": self.t_comp.sum(), "memory": self.t_mem.sum(),
               "network": self.t_net.sum()}
        return max(tot, key=tot.get)

    def sums(self) -> tuple[float, float, float]:
        """(Σt_comp, Σt_mem, Σt_net) over partitions, as Python floats.

        This is the canonical reduction (``np.ndarray.sum`` pairwise order)
        the plan phase stores in ``pricing.PlanVector`` — the price phase
        never re-reduces the ragged per-partition arrays, so batched and
        scalar breakdowns are bit-identical by construction.
        """
        return (float(self.t_comp.sum()), float(self.t_mem.sum()),
                float(self.t_net.sum()))


@dataclasses.dataclass
class _Env:
    """Shared per-call context for group evaluation."""

    f: np.ndarray
    w: np.ndarray
    u: np.ndarray
    hn: np.ndarray
    edges: list[tuple[int, int, float, float]]
    peak: float
    s_cap: float
    mem_bw: float
    weights: str
    buffer_factor: float
    n_streams: int
    kbk_efficiency: float


def _make_env(graph: DataflowGraph, chip: ChipSpec, mem: MemorySpec,
              h_n, h_m, sram_headroom: float, weights: str,
              buffer_factor: float, n_streams: int,
              kbk_efficiency: float) -> tuple[_Env, list[int]]:
    n = graph.n
    order = graph.topo_order
    kernels = [graph.kernels[i] for i in order]
    f = np.array([k.flops for k in kernels])
    w = np.array([k.weight_bytes for k in kernels])
    u = kernel_utilizations(kernels)
    hn_full = np.zeros(n) if h_n is None else np.asarray(h_n, dtype=float)
    hn = hn_full[order]
    pos = {ki: p for p, ki in enumerate(order)}
    hm_arr = (np.zeros(graph.m) if h_m is None
              else np.asarray(h_m, dtype=float))
    edges = [(pos[graph.kernel_index(t.src)], pos[graph.kernel_index(t.dst)],
              t.bytes_, hm_arr[j]) for j, t in enumerate(graph.tensors)]
    env = _Env(f, w, u, hn, edges, chip.tiles * chip.tile_flops,
               chip.sram_capacity * sram_headroom, mem.bandwidth,
               weights, buffer_factor, max(1, n_streams), kbk_efficiency)
    return env, order


def _group_terms(env: _Env, members: set[int]
                 ) -> tuple[float, float, float, float]:
    """(t_comp, t_mem, t_net, sram) for fusing the given topo positions."""
    idx = np.fromiter(members, dtype=np.int64)
    gcomp = float((env.f[idx] / env.u[idx]).sum() / env.peak)
    intra = sum(b for s, d, b, _ in env.edges
                if s in members and d in members)
    cross = sum(b for s, d, b, _ in env.edges
                if (s in members) != (d in members))
    wsum = float(env.w[idx].sum())
    sram = intra * env.buffer_factor
    if env.weights == "stream":
        pinned = 0.0
    elif env.weights == "resident":
        pinned = wsum
    else:  # auto: pin as much as fits
        pinned = min(wsum, max(0.0, env.s_cap - sram))
    wstream = (wsum - pinned) / env.n_streams
    sram += pinned
    gmem = (cross + wstream) / env.mem_bw
    gnet = float(env.hn[idx].sum())
    gnet += sum(hm for s, d, _, hm in env.edges if s in members)
    return gcomp, gmem, gnet, sram


def optimize_intra_chip(graph: DataflowGraph, chip: ChipSpec, mem: MemorySpec,
                        h_n: Sequence[float] | None = None,
                        h_m: Sequence[float] | None = None,
                        p_max: int = 8, mode: str = "dataflow",
                        sram_headroom: float = 0.9,
                        weights: str = "auto",
                        buffer_factor: float = 2.0,
                        n_streams: int = 16,
                        kbk_efficiency: float = 0.75) -> IntraChipResult:
    """Run the §V pass (see module docstring for the model).

    ``weights``: 'resident' (RDU spatial mapping: weights count fully against
    SRAM; infeasible if they do not fit), 'auto' (pin what fits, stream the
    rest — TPU/VMEM semantics, default), 'stream'.
    ``n_streams``: microbatches streamed per partition residency (weight
    traffic amortization). ``kbk_efficiency`` derates unfused kernels.
    """
    env, order = _make_env(graph, chip, mem, h_n, h_m, sram_headroom,
                           weights, buffer_factor, n_streams, kbk_efficiency)
    n = graph.n

    if mode == "kbk":
        return _run_kbk(graph, env, order)

    def group_cost(i: int, j: int) -> float:
        c, m_, t_, _ = _group_terms(env, set(range(i, j)))
        return max(c, m_, t_)

    def feasible(i: int, j: int) -> bool:
        return _group_terms(env, set(range(i, j)))[3] <= env.s_cap

    try:
        bounds, _ = minsum_partition(n, p_max, group_cost, feasible)
    except ValueError:
        # p_max forces groups whose fused buffers exceed SRAM (large graphs /
        # long sequences); allow up to one partition per kernel — singleton
        # partitions are always feasible under 'auto'/'stream' weights.
        bounds, _ = minsum_partition(n, n, group_cost, feasible)
    assign_topo = bounds_to_assign(bounds, n)
    return _finalize(graph, env, order, assign_topo, "dataflow")


def evaluate_intra_assignment(graph: DataflowGraph, assign: Sequence[int],
                              chip: ChipSpec, mem: MemorySpec,
                              h_n: Sequence[float] | None = None,
                              h_m: Sequence[float] | None = None,
                              sram_headroom: float = 0.9,
                              weights: str = "auto",
                              buffer_factor: float = 2.0,
                              n_streams: int = 16) -> IntraChipResult:
    """Price a *given* kernel→partition assignment (e.g. the vendor mapping
    of §VII.B) under the same performance model as the optimizer."""
    assign = np.asarray(assign, dtype=np.int64)
    env, order = _make_env(graph, chip, mem, h_n, h_m, sram_headroom,
                           weights, buffer_factor, n_streams, 1.0)
    assign_topo = assign[order]
    return _finalize(graph, env, order, assign_topo, "dataflow")


def _finalize(graph: DataflowGraph, env: _Env, order: list[int],
              assign_topo: np.ndarray, mode: str) -> IntraChipResult:
    parts = sorted(set(int(p) for p in assign_topo))
    remap = {p: i for i, p in enumerate(parts)}
    assign_topo = np.array([remap[int(p)] for p in assign_topo])
    npart = len(parts)
    t_comp = np.zeros(npart)
    t_mem = np.zeros(npart)
    t_net = np.zeros(npart)
    sram = np.zeros(npart)
    dram = 0.0
    for g in range(npart):
        members = {i for i in range(len(assign_topo)) if assign_topo[i] == g}
        t_comp[g], t_mem[g], t_net[g], sram[g] = _group_terms(env, members)
        dram += t_mem[g] * env.mem_bw
    t_cri = np.maximum(np.maximum(t_comp, t_mem), t_net)
    out_assign = np.empty(len(assign_topo), dtype=np.int64)
    out_assign[order] = assign_topo
    return IntraChipResult(out_assign, npart, t_comp, t_mem, t_net, t_cri,
                           float(t_cri.sum()), sram, dram, mode=mode)


def _run_kbk(graph: DataflowGraph, env: _Env, order: list[int]
             ) -> IntraChipResult:
    n = graph.n
    assign = np.arange(n, dtype=np.int64)
    t_comp = env.f / (env.u * env.peak * env.kbk_efficiency)
    io_bytes = np.zeros(n)
    t_net_extra = np.zeros(n)
    for s, d, b, hm in env.edges:
        io_bytes[s] += b          # producer stores to DRAM
        io_bytes[d] += b          # consumer loads from DRAM
        t_net_extra[s] += hm
    t_mem = (io_bytes + env.w) / env.mem_bw
    t_net = env.hn + t_net_extra
    t_cri = t_comp + t_mem + t_net      # sequential: no overlap
    out_assign = np.empty(n, dtype=np.int64)
    out_assign[order] = assign
    return IntraChipResult(out_assign, n, t_comp, t_mem, t_net, t_cri,
                           float(t_cri.sum()), sram_used=np.zeros(n),
                           dram_traffic=float(io_bytes.sum() + env.w.sum()),
                           mode="kbk")
