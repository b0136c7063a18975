"""Inter-chip optimization pass (paper §IV).

Searches (TP, PP, DP) degrees × network-dimension assignments × per-kernel
sharding schemes × PP stage partitions, minimizing the critical per-stage time

    t_cri_inter[i] = max(t_comp[i], t_net[i], t_p2p[i])        (Eq. 7)

and, for training, composes the stages into a 1F1B pipelined iteration with a
DP gradient all-reduce (the Calculon-comparable iteration model used in the
paper's Fig 8 validation and the DSE of §VI).

Deviation from the paper noted in DESIGN.md: the paper forbids subdividing a
network dimension across strategies; its own Fig 8 sweep (TP=2..64 on fixed
systems) requires it, so we allow contiguous subdivision (a ring splits into
smaller rings, fc into fc, switch into switch) behind ``allow_subdivision``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import numpy as np

from ..systems.chips import ChipSpec
from ..systems.system import SystemSpec
from ..systems.topology import Topology, TopologyDim
from .graph import DataflowGraph
from .memo import GLOBAL_CACHE
from .pricing import (DRIFT_BAND, PlanMatrix, PlanVector, is_approx_backend,
                      price_plans, selection_columns)
from .sharding import ShardingSolution, solve_sharding
from .solver import enumerate_parallelism, minmax_partition
from .utilization import kernel_utilizations


@dataclasses.dataclass(frozen=True)
class TrainWorkload:
    """A training workload at microbatch granularity.

    ``layer_graph`` describes ONE repeated layer for ONE microbatch
    (unsharded); ``pre_graph``/``post_graph`` are the embedding / LM-head
    blocks. FLOPs are forward-pass; backward is modeled as 2× forward compute
    and 2× the TP collective volume (dgrad + wgrad all-reduces — the paper's
    "four all-reduces per layer per iteration").
    """

    name: str
    layer_graph: DataflowGraph
    n_layers: int
    global_batch: int            # sequences per iteration
    microbatch: int = 1          # sequences per pipeline microbatch
    pre_graph: DataflowGraph | None = None
    post_graph: DataflowGraph | None = None
    bwd_flop_mult: float = 2.0
    bwd_comm_mult: float = 1.0   # bwd TP comm ≈ fwd TP comm
    optimizer_bytes_per_param_byte: float = 8.0  # bf16 w+g, fp32 master+m+v
    dp_allreduce: bool = True    # False for serving: DP replicas sync nothing

    def total_weight_bytes(self) -> float:
        w = self.layer_graph.total_weight_bytes() * self.n_layers
        for g in (self.pre_graph, self.post_graph):
            if g is not None:
                w += g.total_weight_bytes()
        return w

    def total_fwd_flops_per_seq(self) -> float:
        f = self.layer_graph.total_flops() * self.n_layers / self.microbatch
        for g in (self.pre_graph, self.post_graph):
            if g is not None:
                f += g.total_flops() / self.microbatch
        return f


@dataclasses.dataclass
class InterChipPlan:
    tp: int
    pp: int
    dp: int
    sharding: ShardingSolution
    stage_bounds: list[int]          # layer-block start indices per stage
    t_stage_fwd: float               # critical stage time (Eq. 7), seconds
    t_comp_stage: float
    t_net_stage: float
    t_p2p_stage: float
    n_micro: int
    iter_time: float
    breakdown: dict[str, float]      # fwd/bwd/bubble/tp_comm/pp_comm/dp_comm
    utilization: float               # model FLOPs / (T · chips · peak)
    per_chip_mem_bytes: float
    feasible: bool
    tp_topology: Topology | None = None
    dp_topology: Topology | None = None

    def summary(self) -> str:
        return (f"TP={self.tp} PP={self.pp} DP={self.dp} "
                f"iter={self.iter_time * 1e3:.2f}ms util={self.utilization:.3f}"
                f" mem/chip={self.per_chip_mem_bytes / 1e9:.1f}GB"
                f"{'' if self.feasible else ' INFEASIBLE'}")


def _subdivide_dims(topology: Topology, degrees: tuple[int, int, int],
                    allow_subdivision: bool) -> list[tuple[Topology, ...]] :
    """Assign topology dims to (tp, pp, dp), innermost dims to TP first.

    Returns a list of candidate (tp_topo, pp_topo, dp_topo) tuples (possibly
    several orderings); empty if infeasible.
    """
    out = []
    for perm in set(itertools.permutations(range(3))):
        need = [degrees[i] for i in perm]  # consume in this strategy order
        pieces: list[list[TopologyDim]] = [[], [], []]
        ok = True
        di = 0
        dims = list(topology.dims)
        remaining = dims[di].size if dims else 1
        for s_pos, s in enumerate(perm):
            want = need[s_pos]
            while want > 1:
                if di >= len(dims):
                    ok = False
                    break
                d = dims[di]
                g = math.gcd(want, remaining)
                if g == 1:
                    if remaining == 1:
                        di += 1
                        remaining = dims[di].size if di < len(dims) else 0
                        continue
                    ok = False
                    break
                take = g if allow_subdivision else remaining
                if not allow_subdivision and remaining != g:
                    ok = False
                    break
                if want % take:
                    ok = False
                    break
                pieces[s].append(TopologyDim(take, d.kind, d.link))
                want //= take
                remaining //= take
                if remaining == 1:
                    di += 1
                    remaining = dims[di].size if di < len(dims) else 0
            if not ok:
                break
        if ok:
            topos = tuple(
                Topology(f"{topology.name}/{'tpd'[i]}", tuple(pieces[i]) or
                         (TopologyDim(1, "ring", topology.dims[0].link),))
                for i in range(3))
            out.append(topos)
    # dedupe by structure
    seen, uniq = set(), []
    for t3 in out:
        key = tuple(tuple((d.size, d.kind) for d in t.dims) for t in t3)
        if key not in seen:
            seen.add(key)
            uniq.append(t3)
    return uniq


def _cached_subdivide(topology: Topology, degrees: tuple[int, int, int],
                      allow_subdivision: bool) -> list[tuple[Topology, ...]]:
    """Memoised ``_subdivide_dims`` — a pure function of the (frozen)
    topology and degrees, and the hottest per-candidate Python loop of a
    warm sweep (profiling: ~60% of a fully-cached design-point solve)."""
    key = (topology, degrees, allow_subdivision)
    return GLOBAL_CACHE.get_or_compute(
        "subdiv", key,
        lambda: _subdivide_dims(topology, degrees, allow_subdivision))


# sharding solutions are pure functions of (graph content, tp,
# topo-structure); the (tp, pp, dp) sweep revisits the same key hundreds of
# times, and the DSE sweep rebuilds identical graphs once per system — the
# structural fingerprint key hits across both.
def _cached_sharding(graph: DataflowGraph, tp: int, topo: Topology,
                     dims) -> ShardingSolution:
    key = (graph.fingerprint(), tp, topo.dims, tuple(dims))
    return GLOBAL_CACHE.get_or_compute(
        "sharding", key, lambda: solve_sharding(graph, tp, topo, dims))


def _cached_minmax(items: list[float], p: int) -> list[int]:
    """PP stage partition, memoised on the exact cost vector."""
    key = (tuple(items), p)
    return list(GLOBAL_CACHE.get_or_compute(
        "minmax", key, lambda: tuple(minmax_partition(items, p)[0])))


def _work_key(work: TrainWorkload) -> tuple:
    """Structural identity of a workload (cache-key component)."""
    return (work.layer_graph.fingerprint(),
            work.pre_graph.fingerprint() if work.pre_graph else None,
            work.post_graph.fingerprint() if work.post_graph else None,
            work.n_layers, work.global_batch, work.microbatch,
            work.bwd_flop_mult, work.bwd_comm_mult,
            work.optimizer_bytes_per_param_byte, work.dp_allreduce)


def memo_plan(work: TrainWorkload, chip: ChipSpec, n_chips: int,
              tp: int, pp: int, dp: int,
              tp_topo: Topology, pp_topo: Topology, dp_topo: Topology,
              execution: str = "dataflow") -> InterChipPlan | None:
    """The memory-independent plan solve for one (tp, pp, dp,
    dim-assignment) point, memoised on (workload, chip, n_chips, degrees,
    dim structures). The returned plan's ``feasible`` flag is a placeholder
    (``False``); callers apply the per-memory capacity check."""
    key = (_work_key(work), chip, n_chips, tp, pp, dp,
           tp_topo.dims, pp_topo.dims, dp_topo.dims, execution)
    return GLOBAL_CACHE.get_or_compute(
        "plan", key,
        lambda: _price_plan(work, chip, n_chips, tp, pp, dp,
                            tp_topo, pp_topo, dp_topo))


def evaluate_plan(work: TrainWorkload, system: SystemSpec,
                  tp: int, pp: int, dp: int,
                  tp_topo: Topology, pp_topo: Topology, dp_topo: Topology,
                  execution: str = "dataflow") -> InterChipPlan | None:
    """Price one (tp, pp, dp, dim-assignment) point.

    Everything except the final memory-capacity check is independent of the
    system's memory part, so the priced plan is memoised on
    (workload, chip, n_chips, degrees, dim structures) and only the
    ``feasible`` flag is recomputed per memory variant — the DSE grid pairs
    each (chip, net, topology) with several memories, all of which share one
    solve.
    """
    plan = memo_plan(work, system.chip, system.n_chips, tp, pp, dp,
                     tp_topo, pp_topo, dp_topo, execution)
    if plan is None:
        return None
    return dataclasses.replace(
        plan, feasible=plan.per_chip_mem_bytes <= system.memory.capacity)


def _price_plan(work: TrainWorkload, chip: ChipSpec, n_chips: int,
                tp: int, pp: int, dp: int,
                tp_topo: Topology, pp_topo: Topology,
                dp_topo: Topology) -> InterChipPlan | None:
    peak = chip.peak_flops
    tdims = list(range(len(tp_topo.dims)))

    # --- TP sharding of the layer graph (Eq. 5/6 costs) ---------------------
    shard = _cached_sharding(work.layer_graph, tp, tp_topo, tdims)

    # per-layer fwd times on the TP group
    f = np.array([k.flops for k in work.layer_graph.kernels])
    u = kernel_utilizations(work.layer_graph.kernels)
    ff = np.array([s.flop_factor for s in shard.schemes])
    t_comp_layer = float(((f * ff) / u).sum() / peak)
    t_net_layer = float(sum(shard.h_n) + sum(shard.h_m))

    def block(graph: DataflowGraph | None) -> tuple[float, float, float]:
        if graph is None:
            return 0.0, 0.0, 0.0
        s = _cached_sharding(graph, tp, tp_topo, tdims)
        fb = np.array([k.flops for k in graph.kernels])
        ub = kernel_utilizations(graph.kernels)
        ffb = np.array([x.flop_factor for x in s.schemes])
        return (float(((fb * ffb) / ub).sum() / peak),
                float(sum(s.h_n) + sum(s.h_m)),
                graph.total_weight_bytes())

    pre = block(work.pre_graph)
    post = block(work.post_graph)

    # --- PP stage partition over [pre] + layers + [post] (minmax DP) --------
    items_comp = [pre[0]] + [t_comp_layer] * work.n_layers + [post[0]]
    items_net = [pre[1]] + [t_net_layer] * work.n_layers + [post[1]]
    items = [max(c, nn) for c, nn in zip(items_comp, items_net)]
    bounds = _cached_minmax(items, pp)

    # boundary activation bytes (largest tensor leaving a layer), sharded by tp
    boundary_b = max((t.bytes_ for t in work.layer_graph.tensors),
                     default=0.0) / tp
    t_p2p = pp_topo.p2p(boundary_b, list(range(len(pp_topo.dims)))) if pp > 1 else 0.0

    stage_comp = np.zeros(len(bounds))
    stage_net = np.zeros(len(bounds))
    nitems = len(items)
    for g, start in enumerate(bounds):
        end = bounds[g + 1] if g + 1 < len(bounds) else nitems
        stage_comp[g] = sum(items_comp[start:end])
        stage_net[g] = sum(items_net[start:end])
    t_comp_stage = float(stage_comp.max())
    t_net_stage = float(stage_net.max())
    t_stage = max(t_comp_stage, t_net_stage, t_p2p)        # Eq. 7

    # --- training iteration (1F1B) ------------------------------------------
    if work.global_batch % (dp * work.microbatch):
        return None
    n_micro = work.global_batch // (dp * work.microbatch)
    if n_micro < 1:
        return None
    t_fwd = t_stage
    t_bwd_comp = t_comp_stage * work.bwd_flop_mult
    t_bwd_net = t_net_stage * (work.bwd_flop_mult * work.bwd_comm_mult)
    t_bwd = max(t_bwd_comp, t_bwd_net, t_p2p)
    t_pipe = (n_micro + pp - 1) * (t_fwd + t_bwd)
    bubble = (pp - 1) * (t_fwd + t_bwd)

    # DP gradient all-reduce on the per-chip weight shard, overlapped with
    # bwd (skipped entirely for serving workloads: replicas sync nothing)
    w_chip = work.total_weight_bytes() / (tp * pp)
    t_dp = (dp_topo.all_reduce(w_chip, list(range(len(dp_topo.dims))))
            if dp > 1 and work.dp_allreduce else 0.0)
    exposed_dp = max(0.0, t_dp - n_micro * t_bwd_comp * 0.5)
    iter_time = t_pipe + exposed_dp

    model_flops = (work.total_fwd_flops_per_seq()
                   * (1.0 + work.bwd_flop_mult) * work.global_batch)
    util = model_flops / (iter_time * n_chips * peak)

    # --- per-chip memory -----------------------------------------------------
    w_bytes = work.total_weight_bytes() / (tp * pp)
    opt_bytes = w_bytes * work.optimizer_bytes_per_param_byte
    act_per_layer = sum(t.bytes_ for t in work.layer_graph.tensors) / tp
    layers_per_stage = math.ceil(work.n_layers / pp)
    act_bytes = act_per_layer * layers_per_stage * min(n_micro, pp)
    mem = w_bytes + opt_bytes + act_bytes
    # the capacity check is the caller's job (evaluate_plan replaces this
    # flag per memory variant); the cached plan itself is memory-agnostic
    feasible = False

    return InterChipPlan(
        tp=tp, pp=pp, dp=dp, sharding=shard, stage_bounds=bounds,
        t_stage_fwd=t_fwd, t_comp_stage=t_comp_stage, t_net_stage=t_net_stage,
        t_p2p_stage=t_p2p, n_micro=n_micro, iter_time=iter_time,
        breakdown={
            "fwd": n_micro * t_comp_stage,
            "bwd": n_micro * t_bwd_comp,
            "bubble": bubble,
            "tp_comm": n_micro * (t_net_stage + t_bwd_net),
            "pp_comm": n_micro * t_p2p,
            "dp_comm": t_dp,
            "dp_exposed": exposed_dp,
        },
        utilization=util, per_chip_mem_bytes=mem, feasible=feasible,
        tp_topology=tp_topo, dp_topology=dp_topo)


def _enumerate_candidates(work: TrainWorkload, system: SystemSpec,
                          max_tp: int | None, max_pp: int | None,
                          allow_subdivision: bool,
                          fixed: tuple[int, int, int] | None,
                          execution: str
                          ) -> list[tuple[tuple[int, int, int, int],
                                          InterChipPlan]]:
    """((tp, pp, dp, assignment-index), plan) pairs in canonical order."""
    n_chips = system.n_chips
    combos = ([fixed] if fixed is not None
              else enumerate_parallelism(n_chips, max_tp, max_pp))
    out: list[tuple[tuple[int, int, int, int], InterChipPlan]] = []
    for tp, pp, dp in combos:
        if pp > work.n_layers + 2:
            continue
        for a, (tp_topo, pp_topo, dp_topo) in enumerate(_cached_subdivide(
                system.topology, (tp, pp, dp), allow_subdivision)):
            plan = memo_plan(work, system.chip, n_chips, tp, pp, dp,
                             tp_topo, pp_topo, dp_topo, execution)
            if plan is not None:
                out.append(((tp, pp, dp, a), plan))
    return out


def candidate_plans(work: TrainWorkload, system: SystemSpec,
                    max_tp: int | None = None,
                    max_pp: int | None = None,
                    allow_subdivision: bool = True,
                    fixed: tuple[int, int, int] | None = None,
                    execution: str = "dataflow") -> list[InterChipPlan]:
    """Every memory-independent candidate plan of the (TP, PP, DP) ×
    dim-assignment search, in canonical enumeration order.

    This is the *plan phase* of the search: all discrete solves run (and
    memo-cache) here, while the memory part of the system only enters in
    :func:`select_plan`. The DSE grid pairs each (chip, net, topology) with
    several memory variants — all of them share one candidate enumeration.
    :func:`candidate_matrix` is the columnar form of the same enumeration.
    """
    return [plan for _, plan in _enumerate_candidates(
        work, system, max_tp, max_pp, allow_subdivision, fixed, execution)]


def _candidate_vector(work: TrainWorkload, plan: InterChipPlan) -> PlanVector:
    """The candidate-level pricing row: exactly the fields the selection
    argmin consumes (``iter_time`` + ``per_chip_mem_bytes`` inputs, fed to
    the same certified formula the winner's full vector goes through).
    Fields the argmin never reads — the intra-chip terms, the system
    cost/power constants — are neutral (0 / 1 / ∞) placeholders; the full
    :class:`PlanVector` for the *winner* is built by ``dse._plan_vector``
    after the intra-chip pass runs."""
    layers_per_stage = math.ceil(work.n_layers / plan.pp)
    return PlanVector(
        t_comp_stage=plan.t_comp_stage,
        t_net_stage=plan.t_net_stage,
        t_p2p=plan.t_p2p_stage,
        t_dp=plan.breakdown["dp_comm"],
        n_micro=float(plan.n_micro),
        tp=float(plan.tp),
        pp=float(plan.pp),
        bwd_flop_mult=work.bwd_flop_mult,
        bwd_comm_mult=work.bwd_comm_mult,
        opt_mult=work.optimizer_bytes_per_param_byte,
        model_flops=1.0,
        weight_bytes=work.total_weight_bytes(),
        act_bytes_layer=sum(t.bytes_ for t in work.layer_graph.tensors),
        layers_per_stage=float(layers_per_stage),
        stage_layers=float(max(1, layers_per_stage)),
        n_chips=1.0, chip_peak=1.0, mem_capacity=math.inf,
        sys_peak_flops=1.0, sys_price=1.0, sys_power=1.0,
        intra_comp=0.0, intra_mem=0.0, intra_net=0.0, intra_total=0.0)


# --- candidate pruning -------------------------------------------------------
PRUNE_MODES = ("on", "off", "auto")


def default_prune() -> str:
    """What every ``prune="auto"`` default in this module,
    ``repro_torch.core.dse`` and ``DSEEngine`` means: on."""
    return "on"


def resolve_prune(policy: str | bool) -> bool:
    """Normalize a ``prune=`` policy to a bool (``"auto"`` → on); anything
    but a bool or one of :data:`PRUNE_MODES` raises."""
    if isinstance(policy, bool):
        return policy
    if policy not in PRUNE_MODES:
        raise ValueError(f"unknown prune policy {policy!r}; "
                         f"expected a bool or one of {PRUNE_MODES}")
    if policy == "auto":
        policy = default_prune()
    return policy == "on"


def dominance_keep(iter_time: np.ndarray, iter_lb: np.ndarray,
                   mem: np.ndarray, chunk: int = 512) -> np.ndarray:
    """Boolean keep-mask of the prefix-dominance filter.

    Row ``s`` is pruned iff some EARLIER row ``r`` has
    ``iter_time[r] <= iter_lb[s]`` and ``mem[r] <= mem[s]``. Such an
    ``r`` is present in every pool ``s`` could appear in (its memory
    footprint is no larger, so it is feasible whenever ``s`` is, and the
    no-feasible fallback pool contains everything) and always beats ``s``
    in the lexicographic argmin: its exact iteration time is no larger
    than ``s``'s *lower bound*, and on exact ties ``np.argmin`` resolves
    to the lower row — ``r``'s side. Pruned rows therefore can never be
    selected for ANY capacity, which is the winner-preservation property
    ``tests/test_interchip.py`` certifies against the scalar scan.

    Checking all earlier rows (not just surviving ones) is sound: if the
    dominating ``r`` was itself pruned by an even earlier ``r'``, then
    ``iter_time[r'] <= iter_lb[r] <= iter_time[r] <= iter_lb[s]`` and the
    memory chain ``mem[r'] <= mem[r] <= mem[s]`` make ``r'`` dominate
    ``s`` too, down to a kept row by induction.

    ``iter_lb`` on the dominated side (instead of the exact iter_time)
    keeps the rule valid for any true lower bound — today the pipeline
    term of ``pricing.selection_columns``, whose communication component
    grows monotonically with TP (that monotonicity is what makes the
    filter bite along the TP axis). The quadratic row-pair scan is
    tiled ``chunk`` × ``chunk``: a block of candidate rows is compared
    against earlier full blocks (all earlier by construction — no index
    broadcast needed) and against its own strict lower triangle, so
    peak temporary memory is O(chunk²) regardless of the enumeration
    size.
    """
    n = len(iter_time)
    keep = np.ones(n, dtype=bool)
    if n <= 1:
        return keep
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        blk_lb = iter_lb[lo:hi][:, None]
        blk_mem = mem[lo:hi][:, None]
        dominated = np.zeros(hi - lo, dtype=bool)
        for plo in range(0, lo, chunk):
            phi = min(plo + chunk, lo)
            dom = ((iter_time[plo:phi][None, :] <= blk_lb)
                   & (mem[plo:phi][None, :] <= blk_mem))
            dominated |= dom.any(axis=1)
        m = hi - lo
        tri = np.arange(m)[None, :] < np.arange(m)[:, None]
        dom = (tri & (iter_time[lo:hi][None, :] <= blk_lb)
               & (mem[lo:hi][None, :] <= blk_mem))
        dominated |= dom.any(axis=1)
        keep[lo:hi] = ~dominated
    return keep


def capacity_keep(iter_time: np.ndarray, mem: np.ndarray,
                  max_capacity: float) -> np.ndarray:
    """Boolean keep-mask of the hard memory-feasibility filter.

    Rows whose footprint exceeds every memory variant's capacity can
    never be selected *feasibly*; the one exception is the no-feasible
    fallback, where the serial scan returns the first row of globally
    minimal iteration time — that row is always kept, so the fallback
    winner survives bit-for-bit. (Topology-subdivision validity, the
    other hard mask, is applied at enumeration time: invalid subdivisions
    and undecomposable (tp, pp, dp) combos never enter the matrix.)
    """
    keep = mem <= max_capacity
    if not keep.all() and len(iter_time):
        keep[int(np.argmin(iter_time))] = True
    return keep


@dataclasses.dataclass
class PrunedCandidates:
    """A pruned view of one candidate matrix: the surviving rows, their
    compacted :class:`~repro_torch.core.pricing.PlanMatrix`, and the pruning
    accounting. ``survivors`` maps pruned row ``i`` back to original
    candidate row ``survivors[i]`` (ascending, so relative enumeration
    order — and therefore argmin tie-breaking — is preserved)."""

    survivors: np.ndarray              # int64 original rows, ascending
    matrix: PlanMatrix                 # compacted candidate columns
    stats: dict                        # enumerated / mem_pruned /
                                       # dominance_pruned / survived
    _priced: dict = dataclasses.field(default_factory=dict, repr=False)

    def __len__(self) -> int:
        return int(self.survivors.shape[0])

    def priced(self, backend: str = "numpy",
               device=None) -> dict[str, np.ndarray]:
        """``price_plans`` over the surviving rows only (cached per
        backend and device) — the compacted batch every backend, including
        the kernel path, prices instead of the full enumeration."""
        key = (backend, None if device is None else str(device))
        out = self._priced.get(key)
        if out is None:
            out = price_plans(self.matrix.cols, backend=backend,
                              device=device)
            self._priced[key] = out
        return out


def prune_matrix(matrix: PlanMatrix, max_capacity: float,
                 selection: dict[str, np.ndarray] | None = None,
                 ranker=None, keep_frac: float | None = None,
                 rank_context: np.ndarray | None = None,
                 rank_capacities: Sequence[float] | None = None
                 ) -> PrunedCandidates:
    """Apply the hard feasibility mask + the dominance filter to a
    candidate matrix, columnar, before any full pricing runs.

    With a ``ranker`` (a :class:`repro_torch.learned.model.LearnedModel`)
    the learned **rank stage** runs as a third filter over the dominance
    survivors: only the model's top ``keep_frac`` fraction (default: the
    model's calibrated fraction) union the rows the dominance lower
    bound cannot exclude at ``rank_capacities`` (the group's actual
    per-variant capacities; default: just ``max_capacity``) stay —
    winner-preserving by construction, see
    :func:`repro_torch.learned.rank.rank_keep`.  ``rank_context`` is the
    per-group system feature block
    (:func:`repro_torch.learned.features.system_features`)."""
    sel = selection if selection is not None else selection_columns(
        matrix.cols)
    n = len(matrix)
    cap_keep = capacity_keep(sel["iter_time"], sel["per_chip_mem_bytes"],
                             max_capacity)
    dom_keep = dominance_keep(sel["iter_time"], sel["iter_lb"],
                              sel["per_chip_mem_bytes"])
    keep = cap_keep & dom_keep
    survivors = np.flatnonzero(keep).astype(np.int64)
    stats = {"enumerated": int(n),
             "mem_pruned": int((~cap_keep).sum()),
             "dominance_pruned": int((cap_keep & ~dom_keep).sum()),
             "survived": int(survivors.shape[0]),
             "ranked": False,
             "rank_survived": int(survivors.shape[0])}
    pruned = matrix.take(survivors)
    if ranker is not None and len(survivors) > 1:
        from ..learned.features import (SYSTEM_FEATURE_NAMES,
                                        candidate_features)
        from ..learned.rank import rank_keep

        if rank_context is None:
            # featurizable without a system: the block is constant per
            # group, so zeros never reorder rows within the group
            rank_context = np.zeros(len(SYSTEM_FEATURE_NAMES))
        frac = keep_frac if keep_frac is not None else ranker.keep_frac
        caps = (rank_capacities if rank_capacities is not None
                else (max_capacity,))
        scores = ranker.score(candidate_features(pruned.cols, rank_context))
        rk = rank_keep(scores, sel["iter_time"][survivors],
                       sel["iter_lb"][survivors],
                       sel["per_chip_mem_bytes"][survivors], caps, frac)
        survivors = survivors[rk]
        pruned = pruned.take(np.flatnonzero(rk).astype(np.int64))
        stats["ranked"] = True
        stats["rank_survived"] = int(survivors.shape[0])
        stats["rank_keep_frac"] = float(frac)
    return PrunedCandidates(survivors=survivors, matrix=pruned, stats=stats)


@dataclasses.dataclass
class CandidateSet:
    """The columnar candidate space of one (workload, chip, n_chips,
    topology) search: the plan objects in canonical enumeration order plus
    their stacked :class:`~repro_torch.core.pricing.PlanMatrix`. Priced columns
    are cached per backend so the memory variants of a system share one
    batched pricing call; pruned views are cached per capacity ceiling so
    they share one mask computation too."""

    plans: list[InterChipPlan]
    matrix: PlanMatrix
    _priced: dict = dataclasses.field(default_factory=dict, repr=False)
    _selection: dict | None = dataclasses.field(default=None, repr=False)
    _pruned: dict = dataclasses.field(default_factory=dict, repr=False)

    def __len__(self) -> int:
        return len(self.plans)

    def priced(self, backend: str = "numpy",
               device=None) -> dict[str, np.ndarray]:
        """``price_plans`` over the candidate matrix (cached per backend
        and device)."""
        key = (backend, None if device is None else str(device))
        out = self._priced.get(key)
        if out is None:
            out = price_plans(self.matrix.cols, backend=backend,
                              device=device)
            self._priced[key] = out
        return out

    def selection(self) -> dict[str, np.ndarray]:
        """The numpy selection prepass over the full matrix (cached):
        exact ``iter_time``/``per_chip_mem_bytes`` plus dominance bounds,
        without the full pricing formula."""
        if self._selection is None:
            self._selection = selection_columns(self.matrix.cols)
        return self._selection

    def pruned(self, max_capacity: float, ranker=None,
               keep_frac: float | None = None,
               rank_context: np.ndarray | None = None,
               rank_capacities: Sequence[float] | None = None
               ) -> PrunedCandidates:
        """The pruned candidate view for a capacity ceiling (cached per
        ceiling — the memory variants of one system share the pruning
        pass through their common ``max(capacities)``).  With a
        ``ranker`` the view is additionally rank-filtered and cached per
        (ceiling, model fingerprint, keep fraction, capacity set) — all
        consumers of one ranked group (selection, backend certification,
        the shipped matrix) see the SAME filtered view."""
        key = (max_capacity if ranker is None
               else (max_capacity, ranker.fingerprint, keep_frac,
                     None if rank_capacities is None
                     else tuple(sorted(set(map(float, rank_capacities))))))
        out = self._pruned.get(key)
        if out is None:
            out = prune_matrix(self.matrix, max_capacity, self.selection(),
                               ranker=ranker, keep_frac=keep_frac,
                               rank_context=rank_context,
                               rank_capacities=rank_capacities)
            self._pruned[key] = out
        return out


def candidate_matrix(work: TrainWorkload, system: SystemSpec,
                     max_tp: int | None = None,
                     max_pp: int | None = None,
                     allow_subdivision: bool = True,
                     fixed: tuple[int, int, int] | None = None,
                     execution: str = "dataflow",
                     prune: str | bool = "auto") -> CandidateSet:
    """Columnar :func:`candidate_plans`: the same enumeration, emitted as a
    :class:`CandidateSet` whose matrix rows are tagged with their
    (tp, pp, dp, dim-assignment) coordinates. Memoised (space ``candmat``)
    on the same structural key as the underlying plan solves, so a warm
    re-sweep skips straight to the batched argmin.

    ``prune`` does not change the enumeration (pruning is a per-capacity
    view, see :meth:`CandidateSet.pruned`); when it resolves on, the
    selection prepass is computed eagerly so the memoised set carries its
    warm dominance bounds into every re-sweep."""
    key = (_work_key(work), system.chip, system.n_chips,
           system.topology, max_tp, max_pp, allow_subdivision, fixed,
           execution)
    cands = GLOBAL_CACHE.get_or_compute(
        "candmat", key,
        lambda: _build_candidate_set(work, system, max_tp, max_pp,
                                     allow_subdivision, fixed, execution))
    if resolve_prune(prune):
        cands.selection()
    return cands


def _build_candidate_set(work, system, max_tp, max_pp, allow_subdivision,
                         fixed, execution) -> CandidateSet:
    tagged = _enumerate_candidates(work, system, max_tp, max_pp,
                                   allow_subdivision, fixed, execution)
    return CandidateSet(
        plans=[plan for _, plan in tagged],
        matrix=PlanMatrix.from_vectors(
            [_candidate_vector(work, plan) for _, plan in tagged],
            [tag for tag, _ in tagged]))


def winner_rows(iter_time: np.ndarray, mem: np.ndarray,
                capacities: Sequence[float]) -> list[int]:
    """The batched lexicographic argmin: per capacity, the first row
    minimizing (per_chip_mem_bytes > capacity, iter_time).

    ``np.argmin`` returns the *first* minimum, so ties resolve to the
    lowest row — exactly the serial scan's first-strictly-smaller
    acceptance order. Returns -1 per capacity when there are no rows.
    """
    n = len(iter_time)
    out: list[int] = []
    for cap in capacities:
        if n == 0:
            out.append(-1)
            continue
        feasible = np.nonzero(mem <= cap)[0]
        pool = feasible if feasible.size else np.arange(n)
        out.append(int(pool[np.argmin(iter_time[pool])]))
    return out


def select_plan(cands: "CandidateSet | Sequence[InterChipPlan]",
                capacity: float,
                backend: str = "numpy",
                prune: str | bool = "auto",
                device=None) -> InterChipPlan | None:
    """Pick the winner for one memory variant: the candidate minimizing
    (infeasible, iter_time) lexicographically — exactly the serial search's
    first-strictly-smaller acceptance order.

    Given a :class:`CandidateSet` this is a batched argmin over
    :func:`~repro_torch.core.pricing.price_plans` output on ``backend`` (the
    columnar hot path, pruned per ``prune``); given a plain plan sequence
    it is the scalar reference scan over the plans' own priced fields,
    which the columnar path — pruned or not — is certified bit-identical
    to (``tests/test_interchip.py``).
    """
    if isinstance(cands, CandidateSet):
        return select_plans(cands, [capacity], backend=backend,
                            prune=prune, device=device)[0]
    best: InterChipPlan | None = None
    bkey: tuple[bool, float] | None = None
    for plan in cands:
        key = (plan.per_chip_mem_bytes > capacity, plan.iter_time)
        if best is None or key < bkey:
            best, bkey = plan, key
    if best is None:
        return None
    return dataclasses.replace(best, feasible=not bkey[0])


def select_rows(cands: CandidateSet, capacities: Sequence[float],
                backend: str = "numpy", device=None
                ) -> tuple[list[int], dict | None]:
    """UNPRUNED winner candidate-row per capacity plus the priced columns
    used (``None`` priced for an empty candidate set, rows all -1) — the
    full-enumeration reference the pruned path is certified against."""
    if not len(cands):
        return [-1] * len(capacities), None
    priced = cands.priced(backend, device)
    return winner_rows(priced["iter_time"], priced["per_chip_mem_bytes"],
                       capacities), priced


@dataclasses.dataclass
class SelectionResult:
    """One batched selection over a candidate set, with the pruning
    bookkeeping the engine ships across processes.

    ``rows`` are winner indices in the ORIGINAL (unpruned) enumeration —
    so certification against the full scalar scan compares like with
    like; ``local_rows`` index the priced arrays, which cover only the
    ``survivors`` rows when pruning ran (``survivors is None`` means the
    full enumeration was priced)."""

    rows: list[int]                    # original-row winner per capacity
    local_rows: list[int]              # same winners, priced-array indexing
    priced: dict | None                # priced columns over the priced rows
    survivors: np.ndarray | None       # original indices of priced rows
    stats: dict                        # enumerated / survived / priced
    #: EXACT f64 per-chip memory of each winner, set by the drift-banded
    #: route (approximate backends) so downstream feasibility flags never
    #: read an f32 column; ``None`` on exact backends (read ``priced``).
    winner_mem: list[float] | None = None
    #: drift-band statistics of the banded selection (approx backends)
    drift: dict | None = None


def select_candidates(cands: CandidateSet, capacities: Sequence[float],
                      backend: str = "numpy",
                      prune: str | bool = "auto",
                      ranker=None, rank_keep_frac: float | None = None,
                      rank_context: np.ndarray | None = None,
                      device=None, band: float = DRIFT_BAND
                      ) -> SelectionResult:
    """The per-memory-variant argmin for *every* capacity at once.

    With pruning on (the default policy), the hard feasibility mask and
    the dominance filter run first on the cheap selection prepass, and
    only the surviving rows go through the full batched ``price_plans``
    call on ``backend`` — strictly fewer rows priced, identical winners
    (the pruning filters are winner-preserving by construction, and the
    property is separately certified against the scalar scan).

    A ``ranker`` (requires pruning on) inserts the learned rank stage
    between the dominance filter and pricing — see
    :func:`prune_matrix`; winners stay identical by the
    :func:`repro_torch.learned.rank.rank_keep` union guarantee.

    On an *approximate* backend (``kernel-f32``) the argmin is the
    drift-banded selection (``repro_torch.kernels.pricing.drift``, band
    ``band``): the f32 columns rank the candidate mass, the ambiguous
    slivers are re-priced exactly, and the returned winners — plus their
    ``winner_mem`` — are exact f64 values identical to the numpy reference
    selection. ``device`` is where a non-numpy backend prices."""
    n = len(cands)
    empty_stats = {"enumerated": n, "survived": n, "priced": 0,
                   "mem_pruned": 0, "dominance_pruned": 0,
                   "ranked": False, "rank_survived": n}
    if n == 0 or not len(capacities):
        return SelectionResult([-1] * len(capacities),
                               [-1] * len(capacities), None, None,
                               empty_stats)
    approx = is_approx_backend(backend)
    if approx:
        from ..kernels.pricing.drift import banded_winner_rows
    if not resolve_prune(prune):
        priced = cands.priced(backend, device)
        if approx:
            bsel = banded_winner_rows(cands.matrix.cols, priced, capacities,
                                      band=band)
            return SelectionResult(bsel.rows, list(bsel.rows), priced, None,
                                   {**empty_stats, "priced": n},
                                   winner_mem=bsel.winner_mem,
                                   drift=bsel.stats)
        rows = winner_rows(priced["iter_time"],
                           priced["per_chip_mem_bytes"], capacities)
        return SelectionResult(rows, list(rows), priced, None,
                               {**empty_stats, "priced": n})
    pc = cands.pruned(max(capacities), ranker=ranker,
                      keep_frac=rank_keep_frac, rank_context=rank_context,
                      rank_capacities=tuple(capacities))
    priced = pc.priced(backend, device)
    if approx:
        bsel = banded_winner_rows(pc.matrix.cols, priced, capacities,
                                  band=band)
        rows = [int(pc.survivors[r]) if r >= 0 else -1 for r in bsel.rows]
        return SelectionResult(rows, list(bsel.rows), priced, pc.survivors,
                               {**pc.stats, "priced": len(pc)},
                               winner_mem=bsel.winner_mem, drift=bsel.stats)
    local = winner_rows(priced["iter_time"], priced["per_chip_mem_bytes"],
                        capacities)
    rows = [int(pc.survivors[r]) if r >= 0 else -1 for r in local]
    return SelectionResult(rows, local, priced, pc.survivors,
                           {**pc.stats, "priced": len(pc)})


def certify_winner_rows(iter_time: np.ndarray, mem: np.ndarray,
                        capacities: Sequence[float],
                        expected: Sequence[int], backend: str,
                        survivors: np.ndarray | None = None) -> None:
    """The certify-or-die contract shared by the serial plan phase and
    ``DSEEngine``: a non-reference backend's batched argmin must
    reproduce the numpy reference's winner rows exactly. When the priced
    arrays cover only pruned ``survivors``, the local argmin is remapped
    through the survivor index map before comparing — ``expected`` is
    always in original-enumeration indexing."""
    rows = winner_rows(iter_time, mem, capacities)
    if survivors is not None:
        rows = [int(survivors[r]) if r >= 0 else -1 for r in rows]
    if list(rows) != list(expected):
        raise RuntimeError(
            f"pricing backend {backend!r} selected different candidates "
            f"than the numpy reference ({rows} != {list(expected)}); "
            f"the backend is not bit-identical")


def scalar_winner_rows(iter_time: Sequence[float], mem: Sequence[float],
                       capacities: Sequence[float]) -> list[int]:
    """The literal serial reference scan, as a Python loop over scalar
    rows: per capacity, the first row strictly improving the
    (infeasible, iter_time) key. This is the ground truth the pruned
    columnar selection is certified against (sampled in production,
    exhaustively in tests)."""
    out: list[int] = []
    for cap in capacities:
        bkey, bi = None, -1
        for i, (it, m) in enumerate(zip(iter_time, mem)):
            key = (m > cap, it)
            if bkey is None or key < bkey:
                bkey, bi = key, i
        out.append(bi)
    return out


def certify_scalar_rows(iter_time: Sequence[float], mem: Sequence[float],
                        capacities: Sequence[float],
                        expected: Sequence[int], context: str) -> None:
    """Certify-or-die for the pruning stage itself: the winners selected
    over the pruned matrix must reproduce the full scalar scan exactly."""
    rows = scalar_winner_rows(iter_time, mem, capacities)
    if list(rows) != list(expected):
        raise RuntimeError(
            f"pruned candidate selection diverged from the full scalar "
            f"scan ({context}): {list(expected)} != scalar {rows}; "
            f"the pruning filters are not winner-preserving")


def select_plans(cands: CandidateSet, capacities: Sequence[float],
                 backend: str = "numpy",
                 prune: str | bool = "auto", device=None,
                 band: float = DRIFT_BAND) -> list[InterChipPlan | None]:
    """The per-memory-variant argmin for *every* capacity at once: one
    batched ``price_plans`` call over the candidate matrix, then a
    vectorized lexicographic argmin per capacity — the memory variants
    of a system never price a candidate twice.

    ``prune`` (``"auto"`` → on) applies the
    winner-preserving dominance/memory filters of :func:`prune_candidates`
    before pricing, so only surviving rows hit the backend; selection is
    certified against the full scalar scan on sampled groups
    (:func:`certify_scalar_selection` — certify-or-die).

    On an *approximate* backend (``kernel-f32``) the selection
    is drift-banded: every candidate within the declared band of the f32
    argmin is re-priced exactly in f64 and the winner (and its memory
    feasibility bit, below) comes from those exact values — the returned
    plans are bit-identical to a numpy-backend run."""
    sel = select_candidates(cands, capacities, backend, prune, device=device,
                            band=band)
    if sel.priced is None:
        return [None] * len(capacities)
    if sel.winner_mem is not None:
        # drift-banded route: winners' memory is already exact f64 —
        # never derive a feasibility bit from an f32 column
        return [dataclasses.replace(cands.plans[r],
                                    feasible=bool(wm <= cap))
                for r, wm, cap in zip(sel.rows, sel.winner_mem, capacities)]
    return [dataclasses.replace(
                cands.plans[r],
                feasible=bool(sel.priced["per_chip_mem_bytes"][lr] <= cap))
            for r, lr, cap in zip(sel.rows, sel.local_rows, capacities)]


def optimize_inter_chip(work: TrainWorkload, system: SystemSpec,
                        max_tp: int | None = None,
                        max_pp: int | None = None,
                        allow_subdivision: bool = True,
                        fixed: tuple[int, int, int] | None = None,
                        execution: str = "dataflow",
                        prune: str | bool = "off") -> InterChipPlan:
    """Search the (TP, PP, DP) × dim-assignment space; return the best
    *feasible* plan by iteration time (ties → first in enumeration order).

    With ``prune="off"`` (the default HERE, unlike the engine's
    ``"auto"``) this composes :func:`candidate_plans` (the
    memory-independent plan phase) + the scalar :func:`select_plan` scan
    — the serial *reference* path, deliberately untouched by both the
    pruning stage (PR 6) and the batched/drift-banded pricing backends
    (PRs 5/7), so certification against it stays meaningful: pricing is
    always scalar f64 here. Passing ``prune="on"``/``"auto"`` routes
    through the pruned columnar
    selection instead (:func:`candidate_matrix` + :func:`select_plan` on
    the pruned matrix), which is certified winner-preserving against the
    scalar scan. Batched sweeps do not call this function per point —
    they go through :func:`candidate_matrix` / :func:`select_plans` so
    a system's memory variants share one enumeration and one pricing
    call.
    """
    if resolve_prune(prune):
        best = select_plan(
            candidate_matrix(work, system, max_tp=max_tp, max_pp=max_pp,
                             allow_subdivision=allow_subdivision,
                             fixed=fixed, execution=execution),
            system.memory.capacity, prune=prune)
    else:
        best = select_plan(
            candidate_plans(work, system, max_tp=max_tp, max_pp=max_pp,
                            allow_subdivision=allow_subdivision, fixed=fixed,
                            execution=execution),
            system.memory.capacity)
    if best is None:
        raise ValueError(f"no (tp,pp,dp) decomposition of {system.n_chips} "
                         f"chips fits {work.name}")
    return best
