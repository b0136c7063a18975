"""DSEEngine — process-parallel, memoised, phase-split design-space sweeps.

The engine evaluates the same design grid as the serial reference
:func:`repro_torch.core.dse.sweep`, but

* **phase-split & columnar**: the *plan* phase (the discrete solves,
  grouped so the memory variants of each (chip, net, topology) system
  share one candidate enumeration) yields
  :class:`repro_torch.core.dse.PlannedGroup` records — the candidate-level
  :class:`repro_torch.core.pricing.PlanMatrix` plus the per-memory winners.
  The parent row-concatenates every shipped matrix, prices all candidates
  of all memory variants in batched ``price_plans`` calls on the
  configured backend (the CUDA pricing kernel by default) and certifies
  the batched lexicographic argmin against the numpy selection — skipped
  when the backend resolves to numpy, the selection's own reference —
  then batch-prices the winners' full vectors.
* **in parallel**: design points are independent, so plan groups are
  evaluated by a ``concurrent.futures`` process pool. Results are reduced
  *by grid index* (a deterministic ordered reduce), so the output list —
  including every float in ``DesignPoint.row()`` — is identical to the
  serial sweep's, regardless of worker count or completion order. The pool
  transport is configurable via ``mp_context`` (fork / spawn / forkserver);
  by default fork is used when safe and forkserver once this process
  holds a CUDA context (a forked child cannot use its parent's context;
  the forkserver's template process predates it). Workers plan and
  select in numpy only; CUDA stays in the parent, which prices and
  certifies in batched calls.
* **cached**: the inner solves (TP sharding, PP min-max partition, the
  memory-independent inter-chip plan, dim subdivision, the intra-chip pass)
  are memoised in ``repro_torch.core.memo`` under structural keys. Workers
  forked after a warm-up inherit the parent's cache.
* **scenario-first**: :meth:`DSEEngine.sweep_scenario` runs the named
  sweeps over the workload families (LLM / DLRM / HPL / FFT / MoE / Mamba2
  / serving, see :mod:`repro_torch.workloads.scenarios`) and extracts the
  Pareto frontier over ``utilization × cost_eff × power_eff`` — the
  decision surface the paper's heat maps (Figs 10-17) visualize.
* **at scale**: :meth:`DSEEngine.reprice_grid` streams a whole grid's
  candidate space through the pricing backend in fixed-size chunks.

The reference engine's streaming API (``sweep_iter``), warm sessions,
cross-process shared memo store, per-point and uncached baselines serve
its search layer and service daemon, which are not ported yet (ROADMAP.md
queue 1, item 5); the port's engine has none of them.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import sys
import time
import warnings
from typing import Callable, Iterable, Sequence

from ..systems.system import SystemSpec
from .dse import (CERTIFY_EVERY, DEFAULT_CHIPS, DEFAULT_MEM_NET,
                  DEFAULT_TOPOLOGIES, DesignPoint, GridCell, PlannedGroup,
                  PlannedPoint, design_grid, plan_design_groups,
                  price_planned)
from .interchip import (TrainWorkload, candidate_matrix, certify_scalar_rows,
                        certify_winner_rows, resolve_prune,
                        select_candidates)
from .pricing import (DRIFT_BAND, PlanMatrix, is_approx_backend, price_plans,
                      resolve_backend)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Immutable description of one design-grid sweep."""

    n_chips: int = 1024
    chips: tuple[str, ...] = DEFAULT_CHIPS
    topologies: tuple[str, ...] = DEFAULT_TOPOLOGIES
    mem_net: tuple[tuple[str, str], ...] = DEFAULT_MEM_NET
    max_tp: int | None = 64
    max_pp: int | None = None
    execution: str = "auto"

    def grid(self) -> list[GridCell]:
        return design_grid(self.chips, self.mem_net, self.topologies)


@dataclasses.dataclass
class ScenarioResult:
    """Points + Pareto frontier for one named workload scenario."""

    name: str
    smoke: bool
    spec: SweepSpec
    points: list[DesignPoint]
    frontier: list[DesignPoint]

    def rows(self) -> list[dict]:
        return [{"workload": self.name, **p.row()} for p in self.points]


def pareto_frontier(points: Sequence[DesignPoint],
                    metrics: tuple[str, ...] = ("utilization", "cost_eff",
                                                "power_eff"),
                    feasible_only: bool | str = "auto"
                    ) -> list[DesignPoint]:
    """Non-dominated subset of ``points`` maximizing every metric.

    A point is dominated if some other point is ≥ on every metric and
    strictly better on at least one. ``feasible_only="auto"`` restricts to
    memory-feasible points when any exist (the paper's heat maps grey out
    infeasible systems) and falls back to the full set otherwise, so the
    frontier of a non-empty sweep is never empty.
    """
    pts = list(points)
    if feasible_only == "auto":
        feas = [p for p in pts if p.plan.feasible]
        pts = feas or pts
    elif feasible_only:
        pts = [p for p in pts if p.plan.feasible]
    vals = [tuple(getattr(p, m) for m in metrics) for p in pts]
    out = []
    for i, vi in enumerate(vals):
        dominated = any(
            vj != vi and all(vj[k] >= vi[k] for k in range(len(vi)))
            for j, vj in enumerate(vals) if j != i)
        if not dominated:
            out.append(pts[i])
    return out


# --- worker plumbing ---------------------------------------------------------
# Two transports:
#   fork        — the work_fn closure (often a lambda) cannot be pickled, so
#                 the parent parks the sweep context in a module global,
#                 forks the pool, and ships only grid *indices* to workers.
#   spawn /     — used when forking is unsafe (a CUDA context is live in the
#   forkserver    parent: a forked child cannot use it) or requested via
#                 ``mp_context``. Requires a picklable work_fn
#                 (the scenario registry's builders all are); each task
#                 carries its full arguments.
_WORKER_CTX: dict = {}


# Workers always select on the numpy reference backend (CUDA stays in the
# parent). With a non-numpy parent backend they also ship
# the candidate matrix so the parent can re-price it and certify the
# argmin; a numpy parent could never disagree with them, so it asks for
# lean groups (ship_matrix=False) instead of megabytes of unused IPC.
def _remap_group(group: PlannedGroup,
                 idxs: tuple[int, ...]) -> PlannedGroup:
    """Re-key a group's cell positions to the parent's grid indices."""
    return dataclasses.replace(
        group, indices=tuple(idxs[p] for p in group.indices))


def _plan_group_index(task: tuple) -> list[PlannedGroup]:
    idxs, certify = task
    ctx = _WORKER_CTX
    cells = [ctx["grid"][i] for i in idxs]
    groups = plan_design_groups(ctx["work_fn"], cells, ctx["n_chips"],
                                max_tp=ctx["max_tp"], max_pp=ctx["max_pp"],
                                execution=ctx["execution"],
                                ship_matrix=ctx["ship_matrix"],
                                prune=ctx["prune"], certify=certify)
    return [_remap_group(g, idxs) for g in groups]


def _plan_group_args(args: tuple) -> list[PlannedGroup]:
    (work_fn, cells, idxs, n_chips, max_tp, max_pp, execution, ship,
     prune, certify) = args
    groups = plan_design_groups(work_fn, cells, n_chips, max_tp=max_tp,
                                max_pp=max_pp, execution=execution,
                                ship_matrix=ship, prune=prune,
                                certify=certify)
    return [_remap_group(g, idxs) for g in groups]


def _group_indices(grid: Sequence[GridCell]) -> list[tuple[int, ...]]:
    """Grid indices grouped by (chip, net, topology): the memory variants
    of one system, which share a plan-phase candidate enumeration."""
    groups: dict[tuple, list[int]] = {}
    for i, (chip, _mem, net, topo) in enumerate(grid):
        groups.setdefault((chip, net, topo), []).append(i)
    return [tuple(v) for v in groups.values()]


def _chunk_groups(groups: Sequence, chunk_rows: int):
    """Split groups into consecutive batches of at most ~``chunk_rows``
    candidate rows (batches hold whole groups; one oversized group is its
    own batch). This is what bounds the whole-grid re-pricing pass's peak
    memory: a 10⁶-row candidate matrix never materializes at once —
    fixed-size blocks stream through the kernel instead."""
    batch: list = []
    rows = 0
    for g in groups:
        n = len(g.matrix)
        if batch and rows + n > chunk_rows:
            yield batch
            batch, rows = [], 0
        batch.append(g)
        rows += n
    if batch:
        yield batch


@dataclasses.dataclass
class _RepriceGroup:
    """One name-group of :meth:`DSEEngine.reprice_grid`: the (pruned)
    candidate matrix, the group's memory-variant capacities, and the
    numpy reference winners it must reproduce. Shape-compatible with
    ``PlannedGroup`` where ``_verify_group_winners`` reads it."""

    matrix: PlanMatrix
    capacities: tuple[float, ...]
    winner_rows: tuple[int, ...]
    survivors: object                  # np.ndarray | None


def _cuda_initialized() -> bool:
    """True once this process holds a CUDA context (without importing
    torch when nothing has yet)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


#: Infrastructure failures that justify a silent-ish serial fallback (the
#: fallback is warned about). Anything else — e.g. a work_fn bug — must
#: propagate with its real traceback, not be retried serially.
def _pool_infra_errors() -> tuple[type[BaseException], ...]:
    from concurrent.futures.process import BrokenProcessPool

    return (OSError, BrokenProcessPool, pickle.PicklingError)


def _require_picklable(work_fn) -> None:
    """Probe work_fn for non-fork transports. Pickle reports unpicklable
    callables inconsistently (PicklingError, AttributeError for local
    closures, TypeError) — normalize to PicklingError so the probe always
    lands in the infra-error fallback, never masquerades as a work_fn bug."""
    try:
        pickle.dumps(work_fn)
    except Exception as exc:
        raise pickle.PicklingError(
            f"work_fn {work_fn!r} is not picklable, which the non-fork "
            f"pool transport requires: {exc}") from exc


RANK_MODES = ("on", "off", "auto")


def check_rank(policy: str | bool) -> None:
    """Validate a ``rank=`` policy as the reference does (a bool or one of
    :data:`RANK_MODES`; ``"auto"`` means off). The learned rank stage is
    not ported, so a policy that turns it on raises
    ``NotImplementedError``."""
    if not isinstance(policy, bool) and policy not in RANK_MODES:
        raise ValueError(f"unknown rank policy {policy!r}; "
                         f"expected a bool or one of {RANK_MODES}")
    if policy is True or policy == "on":
        raise NotImplementedError(
            "the learned rank stage is not ported yet; ROADMAP.md queue 1, "
            "item 5 (the learned/ and search/ layers)")


class DSEEngine:
    """Parallel + cached + phase-split design-space sweep engine.

    Parameters
    ----------
    max_workers:
        Process count for the parallel path (default: CPU count).
    parallel:
        ``"auto"`` (parallel when >1 CPU and the grid is big enough),
        ``True`` (force), or ``False`` (serial in-process, still cached).
    mp_context:
        Explicit multiprocessing start method (``"fork"``, ``"spawn"``,
        ``"forkserver"``) or a ``multiprocessing`` context object. Default
        ``None`` keeps the auto-detection: fork when available and no CUDA
        context is live in this process, forkserver otherwise. Non-fork
        transports ship full task arguments, so ``work_fn`` must be
        picklable.
    pricing_backend:
        ``"numpy"``, ``"torch"`` (eager f64 tensors), ``"kernel"`` (the f64
        CUDA pricing kernel, :mod:`repro_torch.kernels.pricing`),
        ``"kernel-f32"`` (its f32 instantiation — approximate columns
        settled through the drift-budget contract of
        :mod:`repro_torch.kernels.pricing.drift`; ``last_drift_stats``
        reports the band accounting), or ``"auto"`` (``"kernel"``) — used
        for the parent's batched candidate-selection and final pricing
        calls (:func:`repro_torch.core.pricing.price_plans`). Workers
        always select on the numpy reference; the parent certifies its
        backend against them. Final winner pricing on an approximate
        backend resolves to the exact reference
        (``pricing.exact_backend``), so sweep rows stay bit-identical
        across every backend. On an H100, ``"kernel-f32"`` is slower end
        to end than ``"kernel"`` at every size measured: its kernel saves
        about a tenth of a bytes-bound call, and the exact re-pricing of
        the drift band on the host costs more than that (``PERF.md``,
        Findings).
    device:
        Where a non-numpy backend prices: ``None`` (default) is the CUDA
        card, which raises when there is none; ``"cpu"`` runs the
        kernel's plain PyTorch version.
    drift_band:
        The relative drift band δ of the approximate backend's
        drift-budget contract, in (0, 0.5) (default 1e-5).
    price_chunk_rows:
        Upper bound (approximate — whole groups only) on candidate rows
        per batched re-pricing call in the parent's whole-grid pass and
        :meth:`reprice_grid`. Bounds peak memory when the grid carries
        10⁵–10⁶ candidate rows; the default (65536) keeps one f32 block
        comfortably cache-sized while amortizing dispatch.
    prune:
        Candidate-pruning policy for the plan phase: ``"on"``,
        ``"off"``, a bool, or ``"auto"`` (on). With pruning on, workers
        apply the hard feasibility mask + dominance filter
        (``interchip.prune_matrix``) before pricing and ship the
        compacted matrix plus its survivor index map; the parent's
        batched re-pricing (including the kernel path) then covers only
        surviving rows, and every sampled group's
        winners are re-certified against the full scalar scan on the
        parent's side of the IPC boundary. Winners are certified
        bit-identical to the unpruned reference either way; pruning only
        shrinks how many rows get priced (``last_plan_stats`` reports
        enumerated / survived / priced).
    rank:
        Learned rank-stage policy: ``"on"``, ``"off"``, a bool, or
        ``"auto"`` (off). The learned stage is not ported yet, so a policy
        that turns it on raises ``NotImplementedError``.
    """

    def __init__(self, max_workers: int | None = None,
                 parallel: bool | str = "auto",
                 mp_context: str | multiprocessing.context.BaseContext | None
                 = None,
                 pricing_backend: str = "auto",
                 prune: str | bool = "auto",
                 price_chunk_rows: int = 65536,
                 rank: str | bool = "auto",
                 device=None,
                 drift_band: float = DRIFT_BAND) -> None:
        self.max_workers = max_workers or (os.cpu_count() or 1)
        self.parallel = parallel
        if isinstance(mp_context, str):
            if mp_context not in multiprocessing.get_all_start_methods():
                raise ValueError(
                    f"mp_context {mp_context!r} not available on this "
                    f"platform; have {multiprocessing.get_all_start_methods()}")
        self.mp_context = mp_context
        resolve_backend(pricing_backend)  # reject unknown backends now
        self.pricing_backend = pricing_backend
        self.device = device
        from ..kernels.pricing.drift import drift_band as _check_band

        self.drift_band = _check_band(drift_band)
        resolve_prune(prune)  # reject unknown policies at construction
        self.prune = prune
        if not isinstance(price_chunk_rows, int) or price_chunk_rows < 1:
            raise ValueError(f"price_chunk_rows must be a positive int, "
                             f"got {price_chunk_rows!r}")
        self.price_chunk_rows = price_chunk_rows
        check_rank(rank)
        self.rank = rank
        #: Plan-phase accounting of the last sweep: {"groups",
        #: "candidates", "cells", "backend", "verified", "prune",
        #: "enumerated", "survived", "priced", ...}. ``None`` until a sweep
        #: completes.
        self.last_plan_stats: dict | None = None
        #: Aggregated drift-band accounting of the last sweep's banded
        #: certifications on an approximate backend ({"backend", "band",
        #: "groups", "rows", "caps", "repriced", "ambiguous_mem",
        #: "band_hits", "fallback_caps", "max_iter_drift",
        #: "max_mem_drift"}), or ``None`` when no banded selection ran.
        self.last_drift_stats: dict | None = None

    # -- core sweep ----------------------------------------------------------
    def sweep(self, work_fn: Callable[[SystemSpec], TrainWorkload],
              spec: SweepSpec = SweepSpec()) -> list[DesignPoint]:
        """Price every grid cell of ``spec``; skip infeasible cells.

        Output order and values are identical to
        ``repro_torch.core.dse.sweep(work_fn, **spec fields, phased=False)``.
        """
        grid = spec.grid()
        self.last_plan_stats = None
        self.last_drift_stats = None
        planned: list[PlannedPoint | None] | None = None
        if self._should_parallelize(len(grid)):
            try:
                planned = self._parallel_plan(work_fn, spec, grid)
            except _pool_infra_errors() as exc:
                warnings.warn(f"parallel sweep unavailable ({exc!r}); "
                              f"falling back to serial", RuntimeWarning,
                              stacklevel=2)
        if planned is None:
            # the serial path goes through the same group reduce as the
            # pool path, so ``last_plan_stats`` (incl. the pruning
            # accounting) is populated either way; the matrices are not
            # shipped anywhere — backend and sampled scalar certification
            # already ran inside the call
            groups = plan_design_groups(
                work_fn, grid, spec.n_chips, max_tp=spec.max_tp,
                max_pp=spec.max_pp, execution=spec.execution,
                pricing_backend=self.pricing_backend,
                ship_matrix=False, prune=self.prune,
                device=self.device, band=self.drift_band)
            planned = self._finish_plan_groups(groups, len(grid))
        return price_planned(planned, backend=self.pricing_backend,
                             device=self.device)

    def sweep_scenario(self, name: str, smoke: bool = False
                       ) -> ScenarioResult:
        """Run a named workload-family sweep + Pareto extraction."""
        from ..workloads.scenarios import get_scenario

        sc = get_scenario(name, smoke=smoke)
        points = self.sweep(sc.work_fn, sc.spec)
        return ScenarioResult(name=sc.name, smoke=smoke, spec=sc.spec,
                              points=points,
                              frontier=pareto_frontier(points))

    def sweep_all_scenarios(self, smoke: bool = False,
                            names: Iterable[str] | None = None
                            ) -> dict[str, ScenarioResult]:
        from ..workloads.scenarios import scenario_names

        return {n: self.sweep_scenario(n, smoke=smoke)
                for n in (names or scenario_names())}

    # -- budgeted search -----------------------------------------------------
    def search(self, work_fn: Callable[[SystemSpec], TrainWorkload],
               spec: SweepSpec = SweepSpec(), **kwargs):
        """Budgeted adaptive exploration of ``spec``'s design grid: the
        reference's search policies are not ported yet."""
        raise NotImplementedError(
            "DSEEngine.search is not ported yet; ROADMAP.md queue 1, item 5 "
            "(the learned/ and search/ layers)")

    # -- internals -----------------------------------------------------------
    def _should_parallelize(self, grid_size: int) -> bool:
        if self.parallel is False:
            return False
        if self.parallel is True:
            return self.max_workers > 1
        return self.max_workers > 1 and grid_size >= 4

    def _start_method(self) -> str:
        """Pick the pool transport.

        An explicit ``mp_context`` wins. Otherwise: a child forked from a
        process that holds a CUDA context cannot use the card and may hang
        on the context's state — so once CUDA is initialized (the parent
        priced on the card) we prefer forkserver: its server process
        starts clean, while task submission still needs only picklable
        work_fns (same contract as spawn, but without re-importing the
        world per worker). Before CUDA is initialized fork stays the
        default — it supports closures and is faster cold.
        """
        if isinstance(self.mp_context, str):
            return self.mp_context
        if self.mp_context is not None:
            return self.mp_context.get_start_method()
        methods = multiprocessing.get_all_start_methods()
        if not _cuda_initialized() and "fork" in methods:
            return "fork"
        if "forkserver" in methods:
            return "forkserver"
        return "spawn"

    def _mp_context(self) -> multiprocessing.context.BaseContext:
        if (self.mp_context is not None
                and not isinstance(self.mp_context, str)):
            return self.mp_context
        return multiprocessing.get_context(self._start_method())

    def _plan_tasks(self, work_fn, spec: SweepSpec, grid):
        """(worker fn, payload per group, cleanup-needed) for the pool."""
        groups = _group_indices(grid)
        ship = self._resolved_backend() != "numpy"
        # sampled prune certification: every CERTIFY_EVERY-th task's
        # worker runs the in-call scalar-scan check AND attaches the
        # unpruned matrix so the parent can re-price and re-run the scan
        # independently across the IPC boundary. The sample is chosen
        # HERE per task (tasks are one system group each, so a call-local
        # cadence would degenerate to all-or-nothing) and is
        # deterministic in grid order.
        prune_on = self._resolved_prune()
        certify = [prune_on and ti % CERTIFY_EVERY == 0
                   for ti in range(len(groups))]
        if self._start_method() != "fork":
            # non-fork transports ship full task arguments instead of
            # _WORKER_CTX
            _require_picklable(work_fn)
            payload = [(work_fn, [grid[i] for i in idxs], idxs, spec.n_chips,
                        spec.max_tp, spec.max_pp, spec.execution, ship,
                        self.prune, cert)
                       for idxs, cert in zip(groups, certify)]
            return _plan_group_args, payload, False
        _WORKER_CTX.update(work_fn=work_fn, grid=grid, n_chips=spec.n_chips,
                           max_tp=spec.max_tp, max_pp=spec.max_pp,
                           execution=spec.execution, ship_matrix=ship,
                           prune=self.prune)
        return _plan_group_index, list(zip(groups, certify)), True

    def _parallel_plan(self, work_fn, spec: SweepSpec, grid
                       ) -> list[PlannedPoint | None]:
        import concurrent.futures as cf

        workers = min(self.max_workers, max(1, len(grid) // 2))
        used_ctx = False
        try:
            fn, payload, used_ctx = self._plan_tasks(work_fn, spec, grid)
            pool = cf.ProcessPoolExecutor(max_workers=workers,
                                          mp_context=self._mp_context())
            try:
                groups = [g for result in pool.map(fn, payload)
                          for g in result]
            finally:
                pool.shutdown(wait=True, cancel_futures=True)
        finally:
            if used_ctx:
                _WORKER_CTX.clear()
        return self._finish_plan_groups(groups, len(grid))

    def _finish_plan_groups(self, groups: list[PlannedGroup], n_cells: int
                            ) -> list[PlannedPoint | None]:
        """Reduce plan groups into a grid-aligned list.

        With a non-numpy backend, the shipped candidate matrices —
        PRUNED to the surviving rows when pruning ran — are
        row-concatenated and priced in batched ``price_plans`` calls,
        and the resulting per-group argmins (remapped through each
        group's survivor index map) are certified against the workers'
        numpy selection before the winners are accepted. When the backend
        resolves to numpy (the workers' own reference), re-pricing the
        identical deterministic formula could never disagree, so the
        duplicate whole-grid pass is skipped.

        Independently of the backend, every sampled group that shipped
        its unpruned matrix is re-priced on the numpy reference and its
        winners re-certified against the literal full scalar scan — the
        parent-side proof that the pruning filters dropped no winner.
        """
        backend = self._resolved_backend()
        live = [g for g in groups if len(g.matrix)]
        if live and backend != "numpy":
            # stream fixed-size candidate blocks (price_chunk_rows) instead
            # of concatenating the whole grid: peak memory stays bounded
            # no matter how many candidate rows the grid carries
            for batch in _chunk_groups(live, self.price_chunk_rows):
                big = PlanMatrix.concat([g.matrix for g in batch])
                priced = price_plans(big.cols, backend=backend,
                                     device=self.device)
                off = 0
                for g in batch:
                    n = len(g.matrix)
                    self._verify_group_winners(
                        priced["iter_time"][off:off + n],
                        priced["per_chip_mem_bytes"][off:off + n], g)
                    off += n
        # serial path: the banded certification ran inside
        # plan_design_groups (matrices never shipped) and left its stats
        # on the group — fold them in so last_drift_stats is populated
        # on both sides of the IPC boundary
        for g in groups:
            in_call = (g.prune_stats or {}).get("drift")
            if in_call:
                self._note_drift(in_call)
        parent_certified = sum(self._certify_group_prune(g) for g in groups)
        out: list[PlannedPoint | None] = [None] * n_cells
        for g in groups:
            for i, planned in zip(g.indices, g.planned):
                out[i] = planned
        prune_on = self._resolved_prune()
        pstats = [g.prune_stats for g in groups if g.prune_stats]
        self.last_plan_stats = {
            "groups": len(groups),
            "candidates": sum(g.n_candidates for g in groups),
            "cells": sum(len(g.indices) for g in groups),
            "backend": backend,
            "verified": backend != "numpy",
            "prune": prune_on,
            "enumerated": sum(s["enumerated"] for s in pstats),
            "survived": sum(s["survived"] for s in pstats),
            "priced": sum(s["priced"] for s in pstats),
            # groups whose winners were certified against the full scalar
            # scan anywhere (in the planning call, serial or worker), and
            # the subset the parent independently re-priced + re-certified
            # from a shipped unpruned matrix
            "scalar_certified_groups": sum(
                1 for s in pstats if s.get("scalar_certified")),
            "parent_certified_groups": parent_certified,
            # the reference's learned rank stage (not ported): ``rank``
            # stays False and ``rank_survived`` equals ``survived``
            "rank": any(s.get("ranked") for s in pstats),
            "rank_survived": sum(s.get("rank_survived", s["survived"])
                                 for s in pstats),
        }
        return out

    def _certify_group_prune(self, group: PlannedGroup) -> bool:
        """Parent-side sampled pruning certification: re-price the
        group's unpruned matrix on the numpy reference and require the
        shipped winners to reproduce the full scalar scan bit-for-bit."""
        if group.full_matrix is None or not len(group.full_matrix):
            return False
        priced = price_plans(group.full_matrix.cols, backend="numpy")
        certify_scalar_rows(priced["iter_time"].tolist(),
                            priced["per_chip_mem_bytes"].tolist(),
                            group.capacities, group.winner_rows,
                            context=f"parent certify, cells {group.indices}")
        return True

    def _resolved_backend(self) -> str:
        return resolve_backend(self.pricing_backend)

    def _resolved_prune(self) -> bool:
        return resolve_prune(self.prune)

    def _verify_group_winners(self, iter_time, mem,
                              group: PlannedGroup) -> None:
        backend = self._resolved_backend()
        if is_approx_backend(backend):
            # approximate columns: certify winner identity under the
            # drift-budget contract (exact re-pricing of the banded
            # slivers from the group's shipped candidate matrix)
            from ..kernels.pricing.drift import certify_banded_rows

            sel = certify_banded_rows(
                group.matrix.cols,
                {"iter_time": iter_time, "per_chip_mem_bytes": mem},
                group.capacities, group.winner_rows, backend,
                survivors=group.survivors, band=self.drift_band)
            self._note_drift(sel.stats)
            return
        certify_winner_rows(iter_time, mem, group.capacities,
                            group.winner_rows, backend,
                            survivors=group.survivors)

    def _note_drift(self, stats: dict) -> None:
        """Fold one banded selection's stats into ``last_drift_stats``."""
        agg = self.last_drift_stats
        if agg is None:
            agg = self.last_drift_stats = {
                "backend": self._resolved_backend(), "band": stats["band"],
                "groups": 0, "rows": 0, "caps": 0, "repriced": 0,
                "ambiguous_mem": 0, "band_hits": 0, "fallback_caps": 0,
                "max_iter_drift": 0.0, "max_mem_drift": 0.0}
        agg["groups"] += 1
        for key in ("rows", "caps", "repriced", "ambiguous_mem",
                    "band_hits", "fallback_caps"):
            agg[key] += stats[key]
        agg["max_iter_drift"] = max(agg["max_iter_drift"],
                                    stats["max_iter_drift"])
        agg["max_mem_drift"] = max(agg["max_mem_drift"],
                                   stats["max_mem_drift"])

    # -- whole-grid re-pricing at scale --------------------------------------
    def reprice_grid(self, work_fn: Callable[[SystemSpec], TrainWorkload],
                     spec: SweepSpec = SweepSpec(),
                     chunk_rows: int | None = None) -> dict:
        """Price-and-certify an entire design grid's candidate space in
        fixed-size streamed blocks — the 10⁵–10⁶-cell scaling harness for
        the batched pricing backends.

        Each (chip, net, topology) name-group of ``spec``'s grid is
        planned ONCE: one representative :class:`SystemSpec`, one columnar
        candidate enumeration shared by every memory variant, and the
        numpy reference selection over the group's capacity column (memory
        capacities resolve per *name*, so a million-cell grid never builds
        a million systems or plan vectors — the memory axis is just
        numbers). The groups' candidate matrices then stream through the
        engine's pricing backend in blocks of ≤ ``chunk_rows`` rows
        (default ``price_chunk_rows``; peak re-pricing memory is bounded
        by the block, not the grid), and every group's winners are
        certified against the reference — under the drift-budget contract
        on an approximate backend (``kernel-f32``; accounting lands
        in ``last_drift_stats``), bit-identically otherwise.

        ``work_fn`` must not depend on the memory variant of the system
        it receives (the standard workload factories don't) — each
        name-group sees only its representative system.

        Returns a report dict: cell/group/row counts, chunk accounting,
        phase timings + throughput (``cells_per_s``, ``rows_per_s``),
        ``winners_identical`` (certify-or-die — the call raises rather
        than return ``False``), and the drift-band block on approximate
        backends.
        """
        backend = self._resolved_backend()
        chunk = self.price_chunk_rows if chunk_rows is None else chunk_rows
        if not isinstance(chunk, int) or chunk < 1:
            raise ValueError(f"chunk_rows must be a positive int, "
                             f"got {chunk!r}")
        from ..systems.chips import resolve_memory
        from .dse import build_system

        grid = spec.grid()
        self.last_drift_stats = None
        prune_on = self._resolved_prune()
        cap_by_name: dict[str, float] = {}

        def capacity(mem_name: str) -> float:
            cap = cap_by_name.get(mem_name)
            if cap is None:
                cap = cap_by_name[mem_name] = float(
                    resolve_memory(mem_name).capacity)
            return cap

        t0 = time.perf_counter()
        groups: list[_RepriceGroup] = []
        enumerated = 0
        empty_groups = 0
        dom_survived = 0
        rank_survived = 0
        for idxs in _group_indices(grid):
            system = build_system(grid[idxs[0]], spec.n_chips)
            work = work_fn(system)
            cands = candidate_matrix(work, system, max_tp=spec.max_tp,
                                     max_pp=spec.max_pp,
                                     execution=spec.execution,
                                     prune=self.prune)
            enumerated += len(cands)
            if not len(cands):
                empty_groups += 1
                continue
            caps = tuple(capacity(grid[i][1]) for i in idxs)
            sel = select_candidates(cands, caps, prune=self.prune)
            dom_survived += sel.stats["survived"]
            rank_survived += sel.stats["rank_survived"]
            matrix = (cands.pruned(max(caps)).matrix
                      if prune_on else cands.matrix)
            groups.append(_RepriceGroup(matrix, caps, tuple(sel.rows),
                                        sel.survivors))
        plan_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        priced_rows = 0
        chunks = 0
        for batch in _chunk_groups(groups, chunk):
            big = PlanMatrix.concat([g.matrix for g in batch])
            priced = price_plans(big.cols, backend=backend,
                                 device=self.device)
            off = 0
            for g in batch:
                n = len(g.matrix)
                self._verify_group_winners(
                    priced["iter_time"][off:off + n],
                    priced["per_chip_mem_bytes"][off:off + n], g)
                off += n
            priced_rows += len(big)
            chunks += 1
        price_s = time.perf_counter() - t1
        total_s = time.perf_counter() - t0

        drift = self.last_drift_stats
        return {
            "backend": backend,
            "cells": len(grid),
            "groups": len(groups),
            "empty_groups": empty_groups,
            "enumerated": enumerated,
            "rank": False,
            "survived": dom_survived,
            "rank_survived": rank_survived,
            "priced_rows": priced_rows,
            "chunk_rows": chunk,
            "chunks": chunks,
            "plan_s": plan_s,
            "price_s": price_s,
            "total_s": total_s,
            "cells_per_s": len(grid) / total_s if total_s > 0 else 0.0,
            "rows_per_s": priced_rows / price_s if price_s > 0 else 0.0,
            # certify-or-die: a winner mismatch raised inside
            # _verify_group_winners, so reaching here proves identity
            "winners_identical": True,
            "drift": drift,
            "repriced_frac": (drift["repriced"] / max(1, drift["rows"])
                              if drift else 0.0),
        }
