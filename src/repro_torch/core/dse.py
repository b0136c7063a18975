"""Design space exploration driver (paper §VI.C, Figs 10-17).

Sweeps accelerator × topology × memory × interconnect for a workload,
running the full two-level optimization per design point and reporting
utilization, cost efficiency, power efficiency, and the compute/memory/
network latency breakdown.

Plan / price phases
-------------------
Evaluating a design point splits into two phases:

* **plan** (:func:`plan_design_cells` / :func:`plan_design_groups`) — the
  discrete solves: TP sharding, PP min-max partition and the intra-chip
  fusion DP. The (tp, pp, dp) × dim-assignment argmin itself is *columnar*:
  ``interchip.candidate_matrix`` stacks every candidate into a
  :class:`repro_torch.core.pricing.PlanMatrix` and ``interchip.select_plans``
  runs one batched ``price_plans`` call + lexicographic argmin covering
  every memory variant of the system. All solves memo-cache in
  ``repro_torch.core.memo``; the phase emits one compact
  :class:`repro_torch.core.pricing.PlanVector` per grid cell.
* **price** (:func:`price_planned` → :func:`repro_torch.core.pricing.price_plans`)
  — all closed-form roofline/latency/utilization/cost/power arithmetic,
  batched over the stacked plan vectors (the hand-written CUDA kernel by
  default, numpy or eager torch when requested), so one call prices an
  entire grid.

:func:`sweep` walks the grid through the phased path by default;
``sweep(..., phased=False)`` is the serial scalar reference — one
:func:`evaluate_design_point` per cell, pricing inline in Python — which
the batched path is certified against *element-identically* (every float
in ``DesignPoint.row()``) by ``tests/test_torch_dse.py``.

Engine API
----------
The production engine lives in :mod:`repro_torch.core.dse_engine`:

* ``DSEEngine.sweep(work_fn, spec)`` — process-parallel planning of the
  same grid (plan groups shipped to a worker pool) + one batched pricing
  call, with a deterministic ordered reduce: the returned list is
  element-for-element identical to this module's sweep.
* ``DSEEngine.sweep_iter(work_fn, spec)`` — streaming variant yielding
  grid-index-tagged points in completion order, with early-exit.
* ``DSEEngine.sweep_scenario(name, smoke=...)`` — named sweeps over the
  workload families (``repro_torch.workloads.scenarios``) plus Pareto-frontier
  extraction over utilization × cost_eff × power_eff.

Cache key contract
------------------
The expensive inner solves are memoised in ``repro_torch.core.memo.GLOBAL_CACHE``
under structural keys (see that module's docstring for the full contract):

* ``"sharding"``: ``(layer_graph.fingerprint(), tp, tp_topo.dims, dims)``
* ``"minmax"``  : ``(tuple(stage cost items), pp)``
* ``"plan"``    : ``(work key, chip, n_chips, tp, pp, dp, dim structures,
  execution)`` — memory-independent; the capacity check is re-applied per
  memory variant.
* ``"intra"``   : ``(scaled layer fingerprint, chip, mem, tuple(h_n),
  tuple(h_m), mode)``
* ``"subdiv"``  : ``(topology, degrees, allow_subdivision)``

Keys never involve object identity, so the cache hits across design points
even though ``work_fn`` rebuilds the workload graph for every system, and a
cached value is always computed from bit-identical inputs — cached and
uncached sweeps return identical results.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Sequence

from ..systems.chips import resolve_chip, resolve_interconnect, resolve_memory
from ..systems.system import SystemSpec
from ..systems.topology import TOPOLOGIES
from .costpower import (cost_efficiency, power_efficiency,
                        system_efficiency_terms)
from .interchip import (InterChipPlan, TrainWorkload, _work_key,
                        candidate_matrix, certify_scalar_rows,
                        certify_winner_rows, optimize_inter_chip,
                        resolve_prune, select_candidates)
from .intrachip import IntraChipResult, optimize_intra_chip
from .memo import GLOBAL_CACHE
from .pricing import (DRIFT_BAND, PlanMatrix, PlanVector, exact_backend,
                      is_approx_backend, price_plans, resolve_backend)


@dataclasses.dataclass
class DesignPoint:
    system: SystemSpec
    plan: InterChipPlan
    utilization: float
    cost_eff: float                 # FLOP/s per USD
    power_eff: float                # FLOP/s per W
    latency_breakdown: dict[str, float]

    def row(self) -> dict:
        return {
            "chip": self.system.chip.name,
            "memory": self.system.memory.name,
            "topology": self.system.topology.name,
            "link": self.system.topology.dims[0].link.name,
            "tp": self.plan.tp, "pp": self.plan.pp, "dp": self.plan.dp,
            "feasible": self.plan.feasible,
            "utilization": self.utilization,
            "cost_eff_gflops_per_usd": self.cost_eff / 1e9,
            "power_eff_gflops_per_w": self.power_eff / 1e9,
            **{f"t_{k}": v for k, v in self.latency_breakdown.items()},
        }


DEFAULT_CHIPS = ("H100", "TPUv4", "SN30", "WSE2")
DEFAULT_TOPOLOGIES = ("torus2d", "torus3d", "dragonfly", "dgx1", "dgx2")
DEFAULT_MEM_NET = (("DDR", "PCIe"), ("DDR", "NVLink"),
                   ("HBM", "PCIe"), ("HBM", "NVLink"))

#: One cell of the design grid: (chip, memory, interconnect, topology) names.
GridCell = tuple[str, str, str, str]


def design_grid(chips: Iterable[str] = DEFAULT_CHIPS,
                mem_net: Iterable[tuple[str, str]] = DEFAULT_MEM_NET,
                topologies: Iterable[str] = DEFAULT_TOPOLOGIES
                ) -> list[GridCell]:
    """The cartesian design grid in canonical (serial-sweep) order."""
    return [(chip, mem, net, topo)
            for chip in chips
            for mem, net in mem_net
            for topo in topologies]


def build_system(cell: GridCell, n_chips: int) -> SystemSpec:
    chip_name, mem_name, net_name, topo_name = cell
    chip, mem = resolve_chip(chip_name), resolve_memory(mem_name)
    net = resolve_interconnect(net_name)
    topo = TOPOLOGIES[topo_name](n_chips, net)
    return SystemSpec(f"{chip_name}-{mem_name}-{net_name}-{topo_name}",
                      chip, mem, topo)


# --- scalar reference path ---------------------------------------------------
def evaluate_design_point(work_fn: Callable[[SystemSpec], TrainWorkload],
                          cell: GridCell, n_chips: int,
                          max_tp: int | None = 64, max_pp: int | None = None,
                          execution: str = "auto") -> DesignPoint | None:
    """Plan *and* price one grid cell, scalar-by-scalar (the reference);
    ``None`` marks an infeasible/undecomposable cell (the sweep *skips*
    those rather than crashing)."""
    system = build_system(cell, n_chips)
    work = work_fn(system)
    try:
        plan = optimize_inter_chip(work, system, max_tp=max_tp,
                                   max_pp=max_pp, execution=execution)
    except ValueError:
        return None
    return _to_point(work, system, plan, execution)


def plan_vector_for(work: TrainWorkload, system: SystemSpec,
                    plan: InterChipPlan,
                    execution: str = "auto") -> PlanVector:
    """The full pricing row for one already-solved plan: runs the intra-chip
    pass on the plan's per-chip shard and assembles the same
    :class:`~repro_torch.core.pricing.PlanVector` the phased sweep prices. Public
    entry point for consumers that hold a single (workload, system, plan)
    triple — the validation loop feeds the result to
    :func:`repro_torch.core.pricing.decompose_iter_time` for the per-term
    modeled-vs-measured comparison."""
    intra = _intra_refine(work, system, plan, execution)
    return _plan_vector(work, system, plan, intra)


def sweep(work_fn: Callable[[SystemSpec], TrainWorkload],
          n_chips: int = 1024,
          chips: Iterable[str] = DEFAULT_CHIPS,
          topologies: Iterable[str] = DEFAULT_TOPOLOGIES,
          mem_net: Iterable[tuple[str, str]] = DEFAULT_MEM_NET,
          max_tp: int | None = 64, max_pp: int | None = None,
          execution: str = "auto", phased: bool = True,
          pricing_backend: str = "auto",
          prune: str | bool = "auto",
          device=None, band: float = DRIFT_BAND) -> list[DesignPoint]:
    """The 80-system cartesian sweep (4 chips × 5 topologies × 4 mem/net),
    evaluated in grid order.

    ``phased=True`` (default) runs the plan phase over the grid and prices
    everything in one batched call; ``phased=False`` is the serial scalar
    reference (one ``evaluate_design_point`` per cell). Both return
    element-identical ``DesignPoint`` lists — the property
    ``tests/test_torch_dse.py`` certifies. ``prune`` (phased path only)
    controls the candidate-pruning stage: ``"auto"`` (default: on) masks
    memory-infeasible and dominated candidates before pricing — certified
    winner-preserving, so the output is identical either way. ``device``
    is where a non-numpy backend prices (``None``: the CUDA card);
    ``band`` is the drift band of an approximate backend.
    """
    cells = design_grid(chips, mem_net, topologies)
    if phased:
        planned = plan_design_cells(work_fn, cells, n_chips, max_tp=max_tp,
                                    max_pp=max_pp, execution=execution,
                                    pricing_backend=pricing_backend,
                                    prune=prune, device=device, band=band)
        return price_planned(planned, backend=pricing_backend, device=device)
    points: list[DesignPoint] = []
    for cell in cells:
        point = evaluate_design_point(work_fn, cell, n_chips,
                                      max_tp=max_tp, max_pp=max_pp,
                                      execution=execution)
        if point is not None:
            points.append(point)
    return points


def _resolve_mode(system: SystemSpec, execution: str) -> str:
    # execution='auto' follows the chip's native model: spatial-dataflow
    # chips (RDU/WSE) fuse on-chip, instruction chips (GPU/TPU) run
    # kernel-by-kernel — the paper's §VI.C setting.
    if execution == "auto":
        return "dataflow" if system.chip.dataflow else "kbk"
    return execution


def _intra_refine(work: TrainWorkload, system: SystemSpec,
                  plan: InterChipPlan, execution: str) -> IntraChipResult:
    """The intra-chip pass on the winning plan's per-chip shard (memoised)."""
    mode = _resolve_mode(system, execution)
    layer = work.layer_graph.scaled(
        flop_scale=1.0 / plan.tp, bytes_scale=1.0 / plan.tp)
    key = (layer.fingerprint(), system.chip, system.memory,
           tuple(plan.sharding.h_n), tuple(plan.sharding.h_m), mode)
    return GLOBAL_CACHE.get_or_compute(
        "intra", key,
        lambda: optimize_intra_chip(layer, system.chip, system.memory,
                                    h_n=plan.sharding.h_n,
                                    h_m=plan.sharding.h_m, mode=mode))


def _to_point(work: TrainWorkload, system: SystemSpec, plan: InterChipPlan,
              execution: str) -> DesignPoint:
    # refine the critical stage with the intra-chip pass for the breakdown.
    intra = _intra_refine(work, system, plan, execution)
    tc, tm, tn = intra.sums()
    total = tc + tm + tn
    util = plan.utilization
    # memory-bound refinement: if intra-chip memory time dominates the
    # inter-chip estimate, derate utilization accordingly
    if intra.total_time > 0 and plan.t_stage_fwd > 0:
        per_layer_inter = max(plan.t_comp_stage, plan.t_net_stage) / max(
            1, _stage_layers(plan, work))
        derate = min(1.0, per_layer_inter / intra.total_time)
        util = plan.utilization * derate
    breakdown = {
        "compute": tc / total if total else 0.0,
        "memory": tm / total if total else 0.0,
        "network": tn / total if total else 0.0,
    }
    return DesignPoint(system, plan, util,
                       cost_efficiency(util, system),
                       power_efficiency(util, system), breakdown)


def _stage_layers(plan: InterChipPlan, work: TrainWorkload) -> int:
    return math.ceil(work.n_layers / plan.pp)


# --- plan phase --------------------------------------------------------------
@dataclasses.dataclass
class PlannedPoint:
    """Output of the plan phase for one grid cell: the winning discrete
    plan plus the flat numeric record the price phase consumes."""

    cell: GridCell
    system: SystemSpec
    plan: InterChipPlan
    vector: PlanVector


def _plan_vector(work: TrainWorkload, system: SystemSpec,
                 plan: InterChipPlan, intra: IntraChipResult) -> PlanVector:
    tc, tm, tn = intra.sums()
    peak, price, power = system_efficiency_terms(system)
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
        model_flops=(work.total_fwd_flops_per_seq()
                     * (1.0 + work.bwd_flop_mult) * work.global_batch),
        weight_bytes=work.total_weight_bytes(),
        act_bytes_layer=sum(t.bytes_ for t in work.layer_graph.tensors),
        layers_per_stage=float(layers_per_stage),
        stage_layers=float(max(1, layers_per_stage)),
        n_chips=float(system.n_chips),
        chip_peak=system.chip.peak_flops,
        mem_capacity=system.memory.capacity,
        sys_peak_flops=peak,
        sys_price=price,
        sys_power=power,
        intra_comp=tc,
        intra_mem=tm,
        intra_net=tn,
        intra_total=intra.total_time)


@dataclasses.dataclass
class PlannedGroup:
    """The plan-phase output for one (chip, net, topology) system group:
    the columnar candidate space plus the per-memory-variant winners.

    This is the record ``DSEEngine`` workers ship to the parent: the
    candidate :class:`~repro_torch.core.pricing.PlanMatrix` travels alongside the
    selected :class:`PlannedPoint`\\ s so the parent can re-price every
    candidate × memory variant in one batched call on its configured
    backend and certify the workers' numpy argmin against it. When the
    parent's backend *is* the numpy reference that re-pricing could never
    disagree, so the engine asks workers not to ship the matrix
    (``ship_matrix=False`` → an empty matrix travels; ``n_candidates``
    still records the enumeration size).
    """

    indices: tuple[int, ...]            # positions into the caller's cells
    capacities: tuple[float, ...]       # memory capacity per cell
    matrix: PlanMatrix                  # candidate pricing columns — the
                                        # PRUNED (surviving-row) matrix when
                                        # pruning ran (may be empty when not
                                        # shipped)
    n_candidates: int                   # size of the candidate enumeration
    winner_rows: tuple[int, ...]        # candidate row per cell (-1: none),
                                        # ORIGINAL-enumeration indexing
    planned: list[PlannedPoint | None]  # aligned with ``indices``
    #: Original-enumeration index of each shipped matrix row (``None``
    #: when the matrix rows ARE the enumeration, i.e. pruning off).
    survivors: tuple[int, ...] | None = None
    #: Per-group pruning accounting (enumerated/survived/priced/...).
    prune_stats: dict | None = None
    #: The UNPRUNED matrix, shipped only for the sampled certification
    #: subset: the parent re-prices it and certifies the shipped winners
    #: against the full scalar scan.
    full_matrix: PlanMatrix | None = None


def _group_cells(work_fn, cells: Sequence[GridCell], n_chips: int,
                 execution: str):
    """Group cell positions by shared candidate space (the memory variants
    of one system); yields (cell positions, work, system-per-position)."""
    systems = [build_system(cell, n_chips) for cell in cells]
    works = [work_fn(system) for system in systems]
    groups: dict[tuple, list[int]] = {}
    for i, (work, system) in enumerate(zip(works, systems)):
        gkey = (_work_key(work), system.chip, system.n_chips,
                system.topology, execution)
        groups.setdefault(gkey, []).append(i)
    return [(idxs, works[idxs[0]], [systems[i] for i in idxs])
            for idxs in groups.values()]


#: Sampled-certification cadence: every ``CERTIFY_EVERY``-th system group
#: of a :func:`plan_design_groups` call has its pruned selection checked
#: against the full scalar scan (and ships its unpruned matrix to the
#: engine parent for an independent re-priced check). Group order is
#: deterministic, so the sample is too.
CERTIFY_EVERY = 4


def plan_design_groups(work_fn: Callable[[SystemSpec], TrainWorkload],
                       cells: Sequence[GridCell], n_chips: int,
                       max_tp: int | None = 64, max_pp: int | None = None,
                       execution: str = "auto",
                       pricing_backend: str = "numpy",
                       ship_matrix: bool = True,
                       prune: str | bool = "auto",
                       certify: bool | str = "sample",
                       ranker=None,
                       rank_keep_frac: float | None = None,
                       device=None, band: float = DRIFT_BAND
                       ) -> list[PlannedGroup]:
    """Plan phase emitting one :class:`PlannedGroup` per system group.

    Per group: one columnar candidate enumeration
    (``interchip.candidate_matrix``), the pruning stage (hard feasibility
    mask + dominance filter over the cheap selection prepass, per
    ``prune``), then one batched selection covering every memory variant
    (``interchip.select_candidates`` — a single ``price_plans`` call over
    the SURVIVING rows + lexicographic argmin per capacity), then the
    intra-chip pass and full :class:`~repro_torch.core.pricing.PlanVector` for
    each winner only.

    Winners are always selected on the **numpy reference** columns. A
    non-numpy ``pricing_backend`` prices the same (pruned) candidate rows
    a second time and must reproduce the reference argmin row-for-row
    (:func:`interchip.certify_winner_rows`) — so a drifting backend can
    never silently change a winner. With pruning on, a *sampled* subset
    of groups has its winners additionally certified against the literal
    scalar scan over the FULL enumeration — so a filter bug can never
    silently drop a winner either. ``certify`` picks the sample:
    ``"sample"`` (the default, for direct multi-group calls) certifies
    every :data:`CERTIFY_EVERY`-th group of this call; ``True``/``False``
    certify all/none of the call's groups — the engine passes these
    per-task, since its tasks hold one group each and a call-local
    cadence would degenerate to all-or-nothing.

    ``ship_matrix=False`` replaces the matrix in the emitted groups with
    an empty one (the engine's numpy-parent path, which would never read
    it); certified groups of a ``certify=True`` call also carry the
    unpruned matrix so the engine parent can repeat the scalar-scan
    certification on its side of the IPC boundary.

    ``ranker`` (a :class:`repro_torch.learned.model.LearnedModel`,
    pruning on only) inserts the learned rank stage between the dominance
    filter and pricing: every ``pruned(...)`` view this call takes — the
    selection, the backend-certification re-pricing and the shipped
    matrix — is the SAME rank-filtered view, so the survivor maps stay
    consistent across the IPC boundary.  The sampled scalar
    certification above runs against the full enumeration and therefore
    re-proves the rank union guarantee on every sampled group.

    ``device`` is where a non-numpy ``pricing_backend`` prices (``None``:
    the CUDA card); ``band`` is the drift band of an approximate one.
    """
    backend = resolve_backend(pricing_backend)
    pruning = resolve_prune(prune)
    if ranker is not None and not pruning:
        ranker = None  # the rank stage is a refinement of the prune stage
    out: list[PlannedGroup] = []
    for gi, (idxs, work, systems) in enumerate(_group_cells(
            work_fn, cells, n_chips, execution)):
        cands = candidate_matrix(work, systems[0], max_tp=max_tp,
                                 max_pp=max_pp, execution=execution,
                                 prune=prune)
        caps = tuple(s.memory.capacity for s in systems)
        rank_ctx = None
        if ranker is not None:
            from ..learned.features import system_features

            rank_ctx = system_features(systems[0].chip, systems[0].n_chips,
                                       systems[0].topology.name)
        sel = select_candidates(cands, caps, prune=prune, ranker=ranker,
                                rank_keep_frac=rank_keep_frac,
                                rank_context=rank_ctx)  # numpy winners
        sampled = pruning and (gi % CERTIFY_EVERY == 0
                               if certify == "sample" else bool(certify))
        if sampled and len(cands):
            certify_scalar_rows([p.iter_time for p in cands.plans],
                                [p.per_chip_mem_bytes for p in cands.plans],
                                caps, sel.rows, context=f"group {gi}")
        drift_stats: dict | None = None
        if len(cands) and backend != "numpy":
            src = (cands.pruned(max(caps), ranker=ranker,
                                keep_frac=rank_keep_frac,
                                rank_context=rank_ctx,
                                rank_capacities=caps)
                   if pruning else cands)
            check = src.priced(backend, device)
            if is_approx_backend(backend):
                # approximate columns: winner identity is certified under
                # the drift-budget contract, not bit-identity
                from ..kernels.pricing.drift import certify_banded_rows

                drift_stats = certify_banded_rows(
                    src.matrix.cols, check, caps, sel.rows, backend,
                    survivors=sel.survivors, band=band).stats
            else:
                certify_winner_rows(check["iter_time"],
                                    check["per_chip_mem_bytes"], caps,
                                    sel.rows, backend,
                                    survivors=sel.survivors)
        planned: list[PlannedPoint | None] = []
        for pos, system, cap, row, lrow in zip(idxs, systems, caps,
                                               sel.rows, sel.local_rows):
            if row < 0:
                planned.append(None)
                continue
            plan = dataclasses.replace(
                cands.plans[row],
                feasible=bool(sel.priced["per_chip_mem_bytes"][lrow] <= cap))
            intra = _intra_refine(work, system, plan, execution)
            planned.append(PlannedPoint(cells[pos], system, plan,
                                        _plan_vector(work, system, plan,
                                                     intra)))
        if ship_matrix:
            matrix = (cands.pruned(max(caps), ranker=ranker,
                                   keep_frac=rank_keep_frac,
                                   rank_context=rank_ctx,
                                   rank_capacities=caps).matrix
                      if pruning and len(cands) else cands.matrix)
        else:
            matrix = PlanMatrix.concat([])
        out.append(PlannedGroup(
            indices=tuple(idxs), capacities=caps, matrix=matrix,
            n_candidates=len(cands),
            winner_rows=tuple(sel.rows), planned=planned,
            survivors=(tuple(int(s) for s in sel.survivors)
                       if ship_matrix and sel.survivors is not None
                       else None),
            prune_stats=dict(sel.stats,
                             scalar_certified=bool(sampled and len(cands)),
                             **({"drift": drift_stats} if drift_stats
                                else {})),
            full_matrix=(cands.matrix if certify is True and sampled
                         and len(cands) else None)))
    return out


def plan_design_cells(work_fn: Callable[[SystemSpec], TrainWorkload],
                      cells: Sequence[GridCell], n_chips: int,
                      max_tp: int | None = 64, max_pp: int | None = None,
                      execution: str = "auto",
                      pricing_backend: str = "numpy",
                      prune: str | bool = "auto",
                      certify: bool | str = "sample",
                      ranker=None,
                      rank_keep_frac: float | None = None,
                      device=None, band: float = DRIFT_BAND
                      ) -> list[PlannedPoint | None]:
    """Plan phase over a list of grid cells (output aligned to ``cells``).

    Cells whose (workload, chip, n_chips, topology) coincide — the memory
    variants of one system — share a single columnar candidate enumeration
    and one batched selection call (:func:`plan_design_groups`); only the
    capacity check and intra-chip pass run per cell. ``None`` marks an
    undecomposable cell, mirroring :func:`evaluate_design_point`.
    ``certify`` passes straight through — callers streaming one cell per
    call must pick the sample themselves (the call-local ``"sample"``
    cadence would certify every single-group call).
    """
    out: list[PlannedPoint | None] = [None] * len(cells)
    for group in plan_design_groups(work_fn, cells, n_chips, max_tp=max_tp,
                                    max_pp=max_pp, execution=execution,
                                    pricing_backend=pricing_backend,
                                    prune=prune, certify=certify,
                                    ranker=ranker,
                                    rank_keep_frac=rank_keep_frac,
                                    device=device, band=band):
        for pos, planned in zip(group.indices, group.planned):
            out[pos] = planned
    return out


# --- price phase -------------------------------------------------------------
def price_planned(planned: Sequence[PlannedPoint | None],
                  backend: str = "auto", device=None) -> list[DesignPoint]:
    """Batch-price planned points (``None`` entries are skipped, matching
    the scalar sweep's infeasible-cell skip).

    Approximate backends resolve to their exact reference here
    (:func:`exact_backend`): the compiled f32 path earns its keep on the
    candidate mass during selection; the handful of *winners* that land
    in sweep output are always priced bit-identically."""
    live = [p for p in planned if p is not None]
    if not live:
        return []
    priced = price_plans([p.vector for p in live],
                         backend=exact_backend(backend), device=device)
    return [_assemble(p, priced, i) for i, p in enumerate(live)]


def _assemble(planned: PlannedPoint, priced: dict, i: int) -> DesignPoint:
    plan = dataclasses.replace(planned.plan,
                               feasible=bool(priced["feasible"][i]))
    return DesignPoint(
        planned.system, plan,
        float(priced["utilization"][i]),
        float(priced["cost_eff"][i]),
        float(priced["power_eff"][i]),
        {"compute": float(priced["frac_compute"][i]),
         "memory": float(priced["frac_memory"][i]),
         "network": float(priced["frac_network"][i])})
