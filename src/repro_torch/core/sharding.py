"""Tensor-parallel sharding schemes + layout conversion costs (paper §IV, Fig 4).

Every kernel kind exposes a small set of sharding schemes. A scheme fixes
  - the layout it requires for its activation inputs,
  - the layout it produces,
  - its inherent collective cost (paper's c_i, Eq. 5),
  - how its FLOPs and weight bytes divide across the TP group.

Layouts (of an activation tensor over the TP group of t chips):
  R  replicated
  M  sharded along the leading (batch·seq / row) dimension
  N  sharded along the trailing (feature / head) dimension

Layout conversion between a producer's output layout and a consumer's required
input layout gives the tensor cost matrix C_j (Eq. 6):

      to:   R             M             N
  from: R   0             0 (slice)     0 (slice)
        M   all-gather    0             all-to-all
        N   all-gather    all-to-all    0

The canonical Megatron pattern (QKV col-sharded → attention head-local →
Proj row-sharded + all-reduce; FFN0 col → FFN1 row + all-reduce) emerges from
this scheme set as the minimum-communication assignment — the paper validates
DFModel by recovering exactly that (4 all-reduces / layer / iteration, §VI.A).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np

from ..systems.topology import Topology
from .graph import DataflowGraph, Kernel, KernelKind

Layout = str  # 'R' | 'M' | 'N'


@dataclasses.dataclass(frozen=True)
class Scheme:
    """One sharding strategy for a kernel over a TP group of ``t`` chips."""

    name: str
    in_layout: Layout          # layout required on activation inputs
    out_layout: Layout         # layout produced
    flop_factor: float         # per-chip FLOPs = flops * flop_factor
    weight_factor: float       # per-chip weight bytes = weight_bytes * factor
    # inherent collective seconds: fn(out_bytes, topo, tp_dims) -> s
    comm: Callable[[float, Topology, Sequence[int]], float]
    # inherent collective payload bytes (for roofline accounting)
    comm_bytes: Callable[[float], float]
    # price the collective on the full logical output (a2a-style kernels)
    # instead of the replicated/sharded local size
    price_on_full: bool = False


def _zero(_b: float, _t: Topology, _d: Sequence[int]) -> float:
    return 0.0


# Scheme collective/payload callables are module-level functions (closures
# over the TP degree go through functools.partial) so Scheme — and with it
# ShardingSolution, InterChipPlan and DesignPoint — pickles cleanly across
# the DSEEngine worker-process boundary.
def _comm_all_reduce(b: float, topo: Topology, dims: Sequence[int]) -> float:
    return topo.all_reduce(b, dims)


def _comm_reduce_scatter(b: float, topo: Topology,
                         dims: Sequence[int]) -> float:
    return topo.reduce_scatter(b, dims)


def _comm_all_to_all(b: float, topo: Topology, dims: Sequence[int]) -> float:
    return topo.all_to_all(b, dims)


def _comm_all_to_all_2x(b: float, topo: Topology,
                        dims: Sequence[int]) -> float:
    return 2.0 * topo.all_to_all(b, dims)


def _bytes_zero(b: float) -> float:
    return 0.0


def _bytes_all_reduce(b: float, t: int = 2) -> float:
    return 2.0 * b * (t - 1) / t


def _bytes_shard(b: float, t: int = 2) -> float:
    return b * (t - 1) / t


def schemes_for(kernel: Kernel, t: int, seq_shardable: bool = False,
                expert_region: bool = False) -> list[Scheme]:
    """Sharding schemes available to ``kernel`` on a TP group of size ``t``.

    ``seq_shardable`` exposes batch/sequence (M) sharding inside the TP
    group. It is OFF by default: TP shards *within* one microbatch (data
    parallelism over sequences is modeled separately at the inter-chip
    level), and M-sharding self-attention would silently drop the K/V
    all-gather it actually requires. The M schemes exist for sequence-
    parallel extensions (``allow_sp``) where the norm/elementwise region is
    legitimately token-sharded between a reduce-scatter and an all-gather.

    ``t`` == 1 collapses everything to a single no-op scheme.
    """
    if t <= 1:
        return [Scheme("solo", "R", "R", 1.0, 1.0, _zero, _bytes_zero)]

    inv = 1.0 / t
    ar, rs, a2a = _comm_all_reduce, _comm_reduce_scatter, _comm_all_to_all
    ar_bytes = functools.partial(_bytes_all_reduce, t=t)
    shard_bytes = functools.partial(_bytes_shard, t=t)

    k = kernel.kind
    out: list[Scheme] = []
    if k == KernelKind.GEMM and expert_region:
        # expert-parallel GEMM: tokens already dispatched (M layout), expert
        # weights sharded, combine priced at the router.
        return [Scheme("expert_mm", "M", "M", inv, inv, _zero, _bytes_zero),
                Scheme("expert_mr", "M", "R", inv, inv, _zero, _bytes_zero)]
    if k == KernelKind.GEMM:
        # Fig 4 scheme A/B analogues + Megatron col/row pair.
        out.append(Scheme("col", "R", "N", inv, inv, _zero, _bytes_zero))
        out.append(Scheme("row_ar", "N", "R", inv, inv, ar, ar_bytes))
        # beyond-paper: Megatron-SP style reduce-scatter epilogue (output M)
        out.append(Scheme("row_rs", "N", "M", inv, inv, rs, shard_bytes))
        if seq_shardable:
            out.append(Scheme("data", "M", "M", inv, 1.0, _zero, _bytes_zero))
    elif k == KernelKind.ATTENTION:
        # head-sharded attention: inputs/outputs live in N (head) layout
        out.append(Scheme("head", "N", "N", inv, inv, _zero, _bytes_zero))
        if seq_shardable:
            out.append(Scheme("seq", "M", "M", inv, 1.0, _zero, _bytes_zero))
    elif k in (KernelKind.SOFTMAX, KernelKind.NORM, KernelKind.ELEMENTWISE):
        for lay in ("M", "N") if seq_shardable else ("N",):
            out.append(Scheme(f"ew_{lay}", lay, lay, inv, 1.0, _zero,
                              _bytes_zero))
        out.append(Scheme("ew_R", "R", "R", 1.0, 1.0, _zero, _bytes_zero))
    elif k == KernelKind.EMBEDDING:
        # vocab-sharded table: each chip gathers its hits, partial rows → AR
        out.append(Scheme("vocab_ar", "R", "R", inv, inv, ar, ar_bytes))
        out.append(Scheme("replicated", "M", "M", inv, 1.0, _zero,
                          _bytes_zero))
    elif k == KernelKind.ROUTER:
        # MoE dispatch+combine: tokens cross the EP group twice (a2a each
        # way); both directions are priced here on the dispatched tensor,
        # so downstream expert GEMMs are comm-free ('expert' schemes).
        out.append(Scheme("ep_a2a", "R", "M", inv, inv, _comm_all_to_all_2x,
                          ar_bytes, price_on_full=True))
    elif k == KernelKind.SCAN:
        # SSM: shard inner channels/heads; recurrence is along seq (local)
        out.append(Scheme("chan", "N", "N", inv, inv, _zero, _bytes_zero))
        if seq_shardable:
            out.append(Scheme("data", "M", "M", inv, 1.0, _zero, _bytes_zero))
    elif k == KernelKind.FFT:
        # distributed FFT stage: local FFTs on pencils; the transpose between
        # stages is the conversion (M<->N all-to-all) or an explicit COMM node
        out.append(Scheme("pencil_m", "M", "M", inv, 1.0, _zero, _bytes_zero))
        out.append(Scheme("pencil_n", "N", "N", inv, 1.0, _zero, _bytes_zero))
    elif k == KernelKind.COMM:
        out.append(Scheme("a2a", "M", "M", 1.0, 1.0, a2a,
                          shard_bytes, price_on_full=True))
    if not out:
        out.append(Scheme("rep", "R", "R", 1.0, 1.0, _zero, _bytes_zero))
    return out


def conversion_cost(from_lay: Layout, to_lay: Layout, bytes_: float,
                    topo: Topology, dims: Sequence[int], t: int) -> float:
    """C_j entry: seconds to convert a tensor between layouts (Eq. 6)."""
    if t <= 1 or from_lay == to_lay or from_lay == "R":
        return 0.0
    if to_lay == "R":
        return topo.all_gather(bytes_, dims)
    # M <-> N resharding
    return topo.all_to_all(bytes_, dims)


def conversion_bytes(from_lay: Layout, to_lay: Layout, bytes_: float,
                     t: int) -> float:
    """Collective payload bytes of a layout conversion (roofline term)."""
    if t <= 1 or from_lay == to_lay or from_lay == "R":
        return 0.0
    return bytes_ * (t - 1) / t


@dataclasses.dataclass
class ShardingSolution:
    """Per-kernel scheme choice + the resulting comm times.

    ``h_n[i]`` kernel inherent comm seconds (Eq. 5), ``h_m[j]`` tensor
    conversion seconds (Eq. 6); ``comm_bytes`` total collective payload.
    """

    scheme_idx: list[int]
    schemes: list[Scheme]
    h_n: list[float]
    h_m: list[float]
    comm_bytes: float
    total_comm: float


def expert_region_of(graph: DataflowGraph) -> set[str]:
    """GEMM kernels downstream of a ROUTER (until a non-GEMM): these run on
    dispatched tokens with expert-sharded weights (MoE expert parallelism)."""
    region: set[str] = set()
    frontier = [k.name for k in graph.kernels if k.kind == KernelKind.ROUTER]
    while frontier:
        cur = frontier.pop()
        for succ in graph.successors(cur):
            if succ in region:
                continue
            if graph.kernel(succ).kind == KernelKind.GEMM:
                region.add(succ)
                frontier.append(succ)
    return region


def solve_sharding(graph: DataflowGraph, t: int, topo: Topology,
                   dims: Sequence[int], exhaustive_limit: int = 12,
                   allow_sp: bool = False,
                   seq_shardable: bool = False) -> ShardingSolution:
    """Select one scheme per kernel minimizing total comm (h_n + h_m).

    This is a pairwise energy minimization on the kernel graph (node cost =
    inherent collective of the chosen scheme, edge cost = layout conversion).
    Exact by exhaustive enumeration for small graphs, otherwise greedy
    topological assignment + iterated conditional modes (ICM) refinement —
    validated against brute force in tests. (The paper feeds the same
    one-hot-scheme MIP to Gurobi.)
    """
    experts = expert_region_of(graph)
    cand = [schemes_for(k, t, seq_shardable, k.name in experts)
            for k in graph.kernels]
    if not allow_sp:  # paper-faithful scheme set: no reduce-scatter epilogue
        cand = [[s for s in cs if s.name != "row_rs"] or cs for cs in cand]
    n = graph.n
    edges = [(graph.kernel_index(tn.src), graph.kernel_index(tn.dst), tn.bytes_)
             for tn in graph.tensors]

    sizes = [len(c) for c in cand]
    out_bytes = [sum(tt.bytes_ for tt in graph.out_tensors(k.name))
                 for k in graph.kernels]

    def _priced_bytes(i: int, s: Scheme) -> float:
        out_b = out_bytes[i]
        if s.price_on_full or s.out_layout == "R":
            return out_b
        return out_b / t

    # Cost tables: kernel_cost is pure in (i, scheme), edge_cost in
    # (edge, scheme, scheme) — the search loops below (exhaustive product,
    # greedy, Viterbi, ICM) revisit each entry thousands of times, so both
    # are materialized once up front.
    kc = [np.array([cand[i][si].comm(_priced_bytes(i, cand[i][si]),
                                     topo, dims)
                    for si in range(sizes[i])]) for i in range(n)]
    ec = [np.array([[conversion_cost(cand[i][si].out_layout,
                                     cand[j][sj].in_layout,
                                     b, topo, dims, t)
                     for sj in range(sizes[j])] for si in range(sizes[i])])
          for (i, j, b) in edges]
    in_edges: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    out_edges: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for ei, (i, j, _b) in enumerate(edges):
        in_edges[j].append((ei, i))
        out_edges[i].append((ei, j))

    def kernel_cost(i: int, si: int) -> float:
        return float(kc[i][si])

    def total(assign: list[int]) -> float:
        c = sum(kernel_cost(i, assign[i]) for i in range(n))
        c += sum(float(ec[ei][assign[i], assign[j]])
                 for ei, (i, j, _b) in enumerate(edges))
        return c

    space = 1
    for z in sizes:
        space *= z
        if space > 4 ** exhaustive_limit:
            break

    best: list[int]
    if space <= 4 ** exhaustive_limit and n <= exhaustive_limit:
        # tie-break toward inherent collectives over layout conversions:
        # a conversion is a serial resynchronization on the tensor's critical
        # path, while a kernel's inherent collective overlaps with its epilogue
        # (this recovers the canonical Megatron pattern among equal-cost
        # assignments — the paper's §VI.A validation).
        #
        # Enumeration is vectorized over chunks of the scheme product space
        # in itertools.product order, accumulating kernel then edge terms in
        # the same order as ``total`` so the selected assignment (including
        # first-occurrence tie-breaks) matches the scalar scan exactly.
        best, best_key = None, (float("inf"), float("inf"))
        CHUNK = 1 << 16
        for lo in range(0, space, CHUNK):
            hi = min(space, lo + CHUNK)
            combos = np.array(np.unravel_index(np.arange(lo, hi), sizes))
            ksum = np.zeros(hi - lo)
            for i in range(n):
                ksum += kc[i][combos[i]]
            esum = np.zeros(hi - lo)
            for ei, (i, j, _b) in enumerate(edges):
                esum += ec[ei][combos[i], combos[j]]
            tot = ksum + esum
            cand_idx = np.nonzero(tot == tot.min())[0]
            ci = int(cand_idx[int(np.argmin(esum[cand_idx]))])
            key = (float(tot[ci]), float(esum[ci]))
            if key < best_key:
                best_key, best = key, [int(x) for x in combos[:, ci]]
    else:
        # Viterbi DP seed over the topo chain (exact for pure chains), then
        # multi-restart ICM sweeps (handles skip edges) — DESIGN.md §5.
        def viterbi() -> list[int]:
            """Exact on chains: DP over the topo order, scoring each node's
            scheme against its first predecessor's edge only."""
            order = graph.topo_order
            prev_of: dict[int, tuple[int, tuple[int, int, float]]] = {}
            for ei, e in enumerate(edges):  # one representative in-edge/node
                prev_of.setdefault(e[1], (ei, e))
            dp: dict[int, list[float]] = {}
            back: dict[int, list[int]] = {}
            for i in order:
                dp[i] = [0.0] * sizes[i]
                back[i] = [0] * sizes[i]
                e_in = prev_of.get(i)
                for si in range(sizes[i]):
                    c = kernel_cost(i, si)
                    if e_in is not None:
                        ei, e = e_in
                        p = e[0]
                        opts = [dp[p][sp] + float(ec[ei][sp, si])
                                for sp in range(sizes[p])]
                        bp = int(min(range(len(opts)), key=opts.__getitem__))
                        c += opts[bp]
                        back[i][si] = bp
                    dp[i][si] = c
            out = [0] * n
            for i in reversed(order):
                # choose the terminal node's best; propagate back pointers
                if not out_edges[i]:
                    out[i] = int(min(range(sizes[i]),
                                     key=dp[i].__getitem__))
            for i in reversed(order):
                e_in = prev_of.get(i)
                if e_in is not None:
                    p, d = e_in[1][0], e_in[1][1]
                    out[p] = back[d][out[d]]
            return out

        def icm(start: list[int]) -> tuple[list[int], float]:
            cur = list(start)
            for _ in range(12):
                changed = False
                for i in range(n):
                    old = cur[i]
                    cbest, sbest = float("inf"), old
                    for si in range(sizes[i]):
                        c = kernel_cost(i, si)
                        c += sum(float(ec[ei][cur[src], si])
                                 for ei, src in in_edges[i])
                        c += sum(float(ec[ei][si, cur[dst]])
                                 for ei, dst in out_edges[i])
                        if c < cbest:
                            cbest, sbest = c, si
                    cur[i] = sbest
                    changed |= sbest != old
                if not changed:
                    break
            return cur, total(cur)

        greedy = [0] * n
        for i in graph.topo_order:
            opts = []
            for si in range(sizes[i]):
                greedy[i] = si
                c = kernel_cost(i, si)
                c += sum(float(ec[ei][greedy[src], si])
                         for ei, src in in_edges[i])
                opts.append(c)
            greedy[i] = int(min(range(sizes[i]), key=opts.__getitem__))

        starts = [greedy, viterbi()]
        for s0 in range(max(sizes)):
            starts.append([min(s0, z - 1) for z in sizes])
        best, best_c = None, float("inf")
        for st in starts:
            cand_assign, c = icm(st)
            if c < best_c:
                best_c, best = c, cand_assign

    schemes = [cand[i][best[i]] for i in range(n)]
    h_n = [kernel_cost(i, best[i]) for i in range(n)]
    h_m = [float(ec[ei][best[i], best[j]])
           for ei, (i, j, _b) in enumerate(edges)]
    cbytes = 0.0
    for i, s in enumerate(schemes):
        cbytes += s.comm_bytes(_priced_bytes(i, s))
    for (i, j, b), hm in zip(edges, h_m):
        cbytes += conversion_bytes(schemes[i].out_layout, schemes[j].in_layout,
                                   b, t)
    return ShardingSolution(best, schemes, h_n, h_m, cbytes, total(best))
