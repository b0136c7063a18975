"""DFModel core — the port's copy of the reference's numpy DSE pipeline.

Public surface:
  graph IR            : DataflowGraph, Kernel, Tensor, KernelKind
  matrices (Eq. 1-4)  : assignment_matrix, matrix_B/D/L/H
  sharding (Fig 4)    : solve_sharding, Scheme
  inter-chip (§IV)    : TrainWorkload, optimize_inter_chip, InterChipPlan
  intra-chip (§V)     : optimize_intra_chip, IntraChipResult
  solver              : minmax_partition, minsum_partition, branch_and_bound
  DSE (§VI.C)         : sweep, DesignPoint, DSEEngine, SweepSpec,
                        pareto_frontier (parallel+cached: dse_engine.py);
                        plan phase: plan_design_cells → PlannedPoint,
                        plan_design_groups → PlannedGroup (candidate
                        matrices shipped worker → parent);
                        streaming: DSEEngine.sweep_iter → SweepItem;
                        budgeted search: DSEEngine.search (repro_torch.search);
                        learned rank stage: DSEEngine(rank="on")
                        (repro_torch.learned)
  candidates (columnar): CandidateSet, candidate_matrix, select_plans —
                        the batched (tp, pp, dp) × dim-assignment argmin
  pruning             : PrunedCandidates, prune_matrix, select_candidates —
                        hard feasibility mask + dominance filter applied
                        columnar before pricing (prune= policy on
                        candidate_matrix / select_plan(s) / sweep /
                        DSEEngine; winners certified identical to the
                        unpruned scalar scan)
  pricing (batched)   : PlanVector, PlanMatrix, price_plans,
                        price_plan_scalar, stack_plans, batched_roofline
                        (numpy | torch | the f64 / f32 CUDA kernel)
  memo cache          : cache_stats, clear_caches, caching_disabled;
                        cross-process tier (memo_store.py): create_store,
                        StoreHandle — mmap table / socket server shared by
                        sweep workers, DSEEngine(shared_cache=...)

The reference's ``roofline`` and ``serving`` modules are not part of the
DSE price phase and are not copied.
"""
from .graph import DataflowGraph, Kernel, KernelKind, Tensor, chain_graph
from .matrices import (assignment_matrix, matrix_B, matrix_D, matrix_H,
                       matrix_L, partition_summaries, validate_assignment)
from .sharding import Scheme, ShardingSolution, solve_sharding
from .solver import (branch_and_bound, bounds_to_assign, design_space_size,
                     enumerate_parallelism, minmax_partition, minsum_partition)
from .utilization import gemm_utilization, kernel_utilization
from .interchip import (CandidateSet, InterChipPlan, PrunedCandidates,
                        SelectionResult, TrainWorkload, candidate_matrix,
                        candidate_plans, default_prune, optimize_inter_chip,
                        prune_matrix, resolve_prune, select_candidates,
                        select_plan, select_plans)
from .intrachip import IntraChipResult, optimize_intra_chip
from .costpower import (cost_efficiency, power_efficiency, silicon_power_w,
                        silicon_price_usd)
from .dse import (DesignPoint, PlannedGroup, PlannedPoint, design_grid,
                  plan_design_cells, plan_design_groups, price_planned,
                  sweep)
from .dse_engine import (DSEEngine, ScenarioResult, SweepItem, SweepSpec,
                         pareto_frontier, stop_after_feasible)
from .pricing import (PlanMatrix, PlanVector, batched_roofline,
                      price_plan_scalar, price_plans, stack_plans)
from .memo import (CacheStats, SolveCache, cache_stats, caching_disabled,
                   clear_caches)
from .memo_store import (MmapStore, ServerStore, StoreHandle, choose_backend,
                         create_store)

__all__ = [
    "DataflowGraph", "Kernel", "KernelKind", "Tensor", "chain_graph",
    "assignment_matrix", "matrix_B", "matrix_D", "matrix_H", "matrix_L",
    "partition_summaries", "validate_assignment",
    "Scheme", "ShardingSolution", "solve_sharding",
    "branch_and_bound", "bounds_to_assign", "design_space_size",
    "enumerate_parallelism", "minmax_partition", "minsum_partition",
    "gemm_utilization", "kernel_utilization",
    "CandidateSet", "InterChipPlan", "PrunedCandidates", "SelectionResult",
    "TrainWorkload", "candidate_matrix", "candidate_plans", "default_prune",
    "optimize_inter_chip", "prune_matrix", "resolve_prune",
    "select_candidates", "select_plan", "select_plans",
    "IntraChipResult", "optimize_intra_chip",
    "cost_efficiency", "power_efficiency", "silicon_power_w",
    "silicon_price_usd",
    "DesignPoint", "PlannedGroup", "PlannedPoint", "design_grid",
    "plan_design_cells", "plan_design_groups", "price_planned", "sweep",
    "DSEEngine", "ScenarioResult", "SweepItem", "SweepSpec",
    "pareto_frontier", "stop_after_feasible",
    "PlanMatrix", "PlanVector", "batched_roofline", "price_plan_scalar",
    "price_plans", "stack_plans",
    "CacheStats", "SolveCache", "cache_stats", "caching_disabled",
    "clear_caches",
    "MmapStore", "ServerStore", "StoreHandle", "choose_backend",
    "create_store",
]
