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
  ``DSEEngine(phased=False)`` keeps the per-point path (each worker plans
  *and* prices one cell, scalar numpy) as a baseline.
* **streaming**: :meth:`DSEEngine.sweep_iter` yields grid-index-tagged
  :class:`SweepItem`\\ s in completion order with windowed submission, so
  an early-exit predicate (e.g. :func:`stop_after_feasible`) stops
  submitting new work.
* **at scale**: :meth:`DSEEngine.reprice_grid` streams a whole grid's
  candidate space through the pricing backend in fixed-size chunks.
* **learned rank stage and budgeted search**: ``rank="on"`` fits a ridge
  ranker on the memo harvest (:mod:`repro_torch.learned`) and prices only
  its calibrated top fraction union the certified safety set;
  :meth:`DSEEngine.search` drives a :mod:`repro_torch.search` policy under
  an evaluation budget and certifies its winner against the exhaustive
  argmin.
* **warm sessions**: :meth:`DSEEngine.start` keeps one pool and (with
  ``shared_cache``) one cross-process memo store
  (:mod:`repro_torch.core.memo_store`) alive across calls — what the DSE
  service daemon (:mod:`repro_torch.service`) runs on.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
import pickle
import sys
import time
import warnings
from typing import Callable, Iterable, Iterator, Sequence

from ..systems.system import SystemSpec
from .dse import (CERTIFY_EVERY, DEFAULT_CHIPS, DEFAULT_MEM_NET,
                  DEFAULT_TOPOLOGIES, DesignPoint, GridCell, PlannedGroup,
                  PlannedPoint, _group_cells, design_grid,
                  evaluate_design_point, plan_design_cells,
                  plan_design_groups, price_planned)
from .interchip import (TrainWorkload, candidate_matrix, certify_scalar_rows,
                        certify_winner_rows, resolve_prune,
                        select_candidates, winner_rows)
from .memo import GLOBAL_CACHE, caching_disabled
from .memo_store import StoreHandle, choose_backend, create_store
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


@dataclasses.dataclass
class SweepItem:
    """One streamed sweep result: the grid index, its cell, and the priced
    point (``None`` for undecomposable cells, which ``sweep`` would skip)."""

    index: int
    cell: GridCell
    point: DesignPoint | None


def stop_after_feasible(n: int) -> Callable[[SweepItem], bool]:
    """Early-exit predicate for :meth:`DSEEngine.sweep_iter`: stop once
    ``n`` memory-feasible points have streamed out."""
    seen = 0

    def _stop(item: SweepItem) -> bool:
        nonlocal seen
        if item.point is not None and item.point.plan.feasible:
            seen += 1
        return seen >= n

    return _stop


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


def _init_worker_shared(handle: StoreHandle) -> None:
    """Pool-worker initializer: attach a fresh connection to the sweep's
    shared memo store.  Runs before any task in every worker, for every
    start method — fork children must not reuse the parent's socket or
    lock-owning fd, so inheriting the parent's attached client is never
    enough.  The exit hook flushes whatever the client still buffers
    (trailing puts, stats deltas) when the pool retires the worker; it is
    a ``multiprocessing.util.Finalize``, NOT ``atexit`` — pool children
    leave via ``os._exit``, which skips atexit handlers."""
    from multiprocessing.util import Finalize

    client = handle.connect()
    GLOBAL_CACHE.attach_shared(client)
    Finalize(None, client.close, exitpriority=10)


def _noop(_i: int) -> None:
    """Warm-up task for :meth:`DSEEngine.start` (module-level so every
    start method can pickle it)."""
    return None


def _eval_index(i: int) -> DesignPoint | None:
    ctx = _WORKER_CTX
    return evaluate_design_point(ctx["work_fn"], ctx["grid"][i],
                                 ctx["n_chips"], max_tp=ctx["max_tp"],
                                 max_pp=ctx["max_pp"],
                                 execution=ctx["execution"])


def _eval_args(args: tuple) -> DesignPoint | None:
    work_fn, cell, n_chips, max_tp, max_pp, execution = args
    return evaluate_design_point(work_fn, cell, n_chips, max_tp=max_tp,
                                 max_pp=max_pp, execution=execution)


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
                                prune=ctx["prune"], certify=certify,
                                ranker=ctx.get("ranker"),
                                rank_keep_frac=ctx.get("rank_keep_frac"))
    return [_remap_group(g, idxs) for g in groups]


def _plan_group_args(args: tuple) -> list[PlannedGroup]:
    (work_fn, cells, idxs, n_chips, max_tp, max_pp, execution, ship,
     prune, ranker, rank_keep_frac, certify) = args
    groups = plan_design_groups(work_fn, cells, n_chips, max_tp=max_tp,
                                max_pp=max_pp, execution=execution,
                                ship_matrix=ship, prune=prune,
                                certify=certify, ranker=ranker,
                                rank_keep_frac=rank_keep_frac)
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


class DSEEngine:
    """Parallel + cached + phase-split design-space sweep engine.

    Parameters
    ----------
    max_workers:
        Process count for the parallel path (default: CPU count).
    parallel:
        ``"auto"`` (parallel when >1 CPU and the grid is big enough),
        ``True`` (force), or ``False`` (serial in-process, still cached).
    use_cache:
        ``False`` runs every solve cold — the serial baseline. (Fork
        workers inherit the disabled flag; spawn workers start fresh
        either way.)
    mp_context:
        Explicit multiprocessing start method (``"fork"``, ``"spawn"``,
        ``"forkserver"``) or a ``multiprocessing`` context object. Default
        ``None`` keeps the auto-detection: fork when available and no CUDA
        context is live in this process, forkserver otherwise. Non-fork
        transports ship full task arguments, so ``work_fn`` must be
        picklable.
    phased:
        ``True`` (default) splits evaluation into a parallel plan phase +
        batched pricing calls; ``False`` keeps the per-point path where
        each worker plans and prices a single cell (scalar numpy).
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
    shared_cache:
        ``False`` (default) keeps worker memo caches process-private.
        ``True``/``"auto"`` layers a cross-process shared memo store
        (:mod:`repro_torch.core.memo_store`) under every worker's cache
        for the duration of each parallel sweep, so workers reuse each
        other's plan/sharding/minmax/subdiv/candmat solves; the backend
        follows the pool transport (mmap table for fork/forkserver,
        unix-socket server for spawn). ``"mmap"``/``"server"`` force a
        backend. The store lives for one sweep (or one warm session): it
        is created next to the pool and torn down — even on pool failure
        — before the sweep returns, leaving its aggregated cross-process
        stats in ``last_shared_stats``.
    prune:
        Candidate-pruning policy for the phased plan phase: ``"on"``,
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
        Learned rank-stage policy (:mod:`repro_torch.learned`): ``"on"``,
        ``"off"``, a bool, or ``"auto"`` (**off** — the learned stage is
        opt-in). With rank on (and pruning on — the rank stage refines
        the dominance survivors, so prune off implies rank off), the
        engine fits a ridge ranker on the memo cache's ``candmat`` harvest
        once per sweep (warm sessions refit incrementally when
        :meth:`repro_torch.core.memo.SolveCache.diff_stats` shows the
        harvest grew) and ships it to the workers; each group then prices
        only the model's calibrated top fraction union the staircase
        safety set (:func:`repro_torch.learned.rank.rank_keep`). When the
        harvest is below the staleness guard
        (:data:`repro_torch.learned.model.MIN_TRAIN_ROWS`) the engine
        degrades to rank-off for that sweep. Winners stay certified
        identical to the unranked pipeline (same sampled scalar
        certification); ``last_plan_stats`` reports ``rank`` /
        ``rank_survived`` / ``rank_keep_frac``.
    rank_keep_frac:
        Override for the model's calibrated keep fraction, a float in
        (0, 1] (default ``None``: the calibrated fraction).
    rank_model_path:
        Optional persistence path for the trained
        :class:`repro_torch.learned.model.LearnedModel`: loaded when the
        in-process harvest is too small to fit (a cold service process
        reusing the previous session's model), saved after every
        successful fit.
    """

    def __init__(self, max_workers: int | None = None,
                 parallel: bool | str = "auto",
                 use_cache: bool = True,
                 mp_context: str | multiprocessing.context.BaseContext | None
                 = None,
                 phased: bool = True,
                 pricing_backend: str = "auto",
                 shared_cache: bool | str = False,
                 prune: str | bool = "auto",
                 price_chunk_rows: int = 65536,
                 rank: str | bool = "auto",
                 rank_keep_frac: float | None = None,
                 rank_model_path: str | None = None,
                 device=None,
                 drift_band: float = DRIFT_BAND) -> None:
        self.max_workers = max_workers or (os.cpu_count() or 1)
        self.parallel = parallel
        self.use_cache = use_cache
        if isinstance(mp_context, str):
            if mp_context not in multiprocessing.get_all_start_methods():
                raise ValueError(
                    f"mp_context {mp_context!r} not available on this "
                    f"platform; have {multiprocessing.get_all_start_methods()}")
        self.mp_context = mp_context
        self.phased = phased
        resolve_backend(pricing_backend)  # reject unknown backends now
        self.pricing_backend = pricing_backend
        self.device = device
        from ..kernels.pricing.drift import drift_band as _check_band

        self.drift_band = _check_band(drift_band)
        if shared_cache not in (False, True, "auto", "mmap", "server"):
            raise ValueError(
                f"shared_cache {shared_cache!r}; expected False, True, "
                f"'auto', 'mmap' or 'server'")
        self.shared_cache = shared_cache
        resolve_prune(prune)  # reject unknown policies at construction
        self.prune = prune
        if not isinstance(price_chunk_rows, int) or price_chunk_rows < 1:
            raise ValueError(f"price_chunk_rows must be a positive int, "
                             f"got {price_chunk_rows!r}")
        self.price_chunk_rows = price_chunk_rows
        from ..learned.rank import resolve_rank

        resolve_rank(rank)  # reject unknown policies at construction
        self.rank = rank
        if rank_keep_frac is not None and not 0.0 < rank_keep_frac <= 1.0:
            raise ValueError(f"rank_keep_frac must lie in (0, 1], "
                             f"got {rank_keep_frac!r}")
        self.rank_keep_frac = rank_keep_frac
        self.rank_model_path = rank_model_path
        # learned rank-stage session state: the current fitted model and
        # the cache-stats snapshot its harvest was taken at (warm-session
        # incremental retrain compares against it; see _ranker_for_run)
        self._ranker = None
        self._rank_snapshot = None
        #: Plan-phase accounting of the last phased sweep: {"groups",
        #: "candidates", "cells", "backend", "verified", "prune",
        #: "enumerated", "survived", "priced", "rank", "rank_survived",
        #: "rank_keep_frac", ...}. ``None`` until a phased sweep completes.
        self.last_plan_stats: dict | None = None
        #: Aggregated cross-process stats of the last parallel sweep's
        #: shared memo store ({"backend", "hits", "misses", "inserts",
        #: "dropped", "entries", "by_space"}), or ``None`` when no shared
        #: store ran. ``hits`` counts lookups served by *another*
        #: process's solve.
        self.last_shared_stats: dict | None = None
        #: Aggregated drift-band accounting of the last sweep's banded
        #: certifications on an approximate backend ({"backend", "band",
        #: "groups", "rows", "caps", "repriced", "ambiguous_mem",
        #: "band_hits", "fallback_caps", "max_iter_drift",
        #: "max_mem_drift"}), or ``None`` when no banded selection ran.
        self.last_drift_stats: dict | None = None
        # warm-session state (:meth:`start` / :meth:`shutdown`): one
        # process pool + one shared memo store reused across calls
        self._session = False
        self._session_pool = None
        self._session_store = None

    # -- core sweep ----------------------------------------------------------
    def sweep(self, work_fn: Callable[[SystemSpec], TrainWorkload],
              spec: SweepSpec = SweepSpec()) -> list[DesignPoint]:
        """Price every grid cell of ``spec``; skip infeasible cells.

        Output order and values are identical to
        ``repro_torch.core.dse.sweep(work_fn, **spec fields, phased=False)``.
        """
        grid = spec.grid()
        self.last_plan_stats = None
        self.last_shared_stats = None
        self.last_drift_stats = None
        if not self.phased:
            return self._sweep_perpoint(work_fn, spec, grid)
        planned: list[PlannedPoint | None] | None = None
        if self._should_parallelize(len(grid)):
            try:
                planned = self._parallel_plan(work_fn, spec, grid)
            except _pool_infra_errors() as exc:
                warnings.warn(f"parallel sweep unavailable ({exc!r}); "
                              f"falling back to serial", RuntimeWarning,
                              stacklevel=2)
        if planned is None:
            with self._cache_mode():
                # the serial phased path goes through the same group
                # reduce as the pool path, so ``last_plan_stats`` (incl.
                # the pruning accounting) is populated either way; the
                # matrices are not shipped anywhere — backend and sampled
                # scalar certification already ran inside the call
                ranker, rkf = self._ranker_for_run()
                groups = plan_design_groups(
                    work_fn, grid, spec.n_chips, max_tp=spec.max_tp,
                    max_pp=spec.max_pp, execution=spec.execution,
                    pricing_backend=self.pricing_backend,
                    ship_matrix=False, prune=self.prune,
                    ranker=ranker, rank_keep_frac=rkf,
                    device=self.device, band=self.drift_band)
                planned = self._finish_plan_groups(groups, len(grid))
        return price_planned(planned, backend=self.pricing_backend,
                             device=self.device)

    def sweep_iter(self, work_fn: Callable[[SystemSpec], TrainWorkload],
                   spec: SweepSpec = SweepSpec(),
                   stop: Callable[[SweepItem], bool] | None = None
                   ) -> Iterator[SweepItem]:
        """Stream :class:`SweepItem`\\ s as plan groups finish.

        Items carry their grid index so consumers can re-order; every index
        of the grid is delivered exactly once (unless ``stop`` ends the
        sweep early). ``stop`` is called after each yield; a truthy return
        cancels all not-yet-running work and ends the iteration. Work is
        submitted in a bounded window (≈2 tasks per worker), so an early
        stop genuinely avoids planning the rest of the grid.

        Points are priced through the same batched backend as :meth:`sweep`
        (one batch per plan group) — pricing is elementwise over the batch
        axis, so streamed values are bit-identical to a full sweep's.
        """
        return self._iter_cells(work_fn, spec, spec.grid(), stop)

    def sweep_cells_iter(self, work_fn: Callable[[SystemSpec], TrainWorkload],
                         cells: Sequence[GridCell],
                         spec: SweepSpec = SweepSpec(),
                         stop: Callable[[SweepItem], bool] | None = None
                         ) -> Iterator[SweepItem]:
        """Stream :class:`SweepItem`\\ s for an explicit list of grid cells.

        Identical machinery (and therefore bit-identical points) to
        :meth:`sweep_iter`, but over ``cells`` instead of ``spec``'s own
        cartesian grid — ``spec`` contributes only the non-grid sweep
        parameters (``n_chips``, ``max_tp``, ``max_pp``, ``execution``).
        Item indices are positions in ``cells``; every position is
        delivered exactly once (unless ``stop`` fires).

        This is the warm-service entry point: the service scheduler
        (:mod:`repro_torch.service`) batches deduplicated cells from many
        concurrent requests and streams each batch through the same
        certified plan → price pipeline, usually on a warm session pool
        (:meth:`start`).
        """
        return self._iter_cells(work_fn, spec, list(cells), stop)

    def _iter_cells(self, work_fn, spec: SweepSpec, grid, stop
                    ) -> Iterator[SweepItem]:
        self.last_shared_stats = None
        self.last_drift_stats = None
        delivered: set[int] = set()
        if self._should_parallelize(len(grid)):
            gen = self._parallel_iter(work_fn, spec, grid, stop)
            while True:
                try:
                    item = next(gen)
                except StopIteration:
                    # the parallel stream completed (or stop() fired in it)
                    return
                except _pool_infra_errors() as exc:
                    # mid-stream pool failure: fall through to the serial
                    # path for the *undelivered* indices only, preserving
                    # the exactly-once contract (and any state the stop
                    # predicate accumulated so far)
                    warnings.warn(f"parallel sweep unavailable ({exc!r}); "
                                  f"streaming serially", RuntimeWarning,
                                  stacklevel=2)
                    break
                delivered.add(item.index)
                yield item
        pending = [(i, cell) for i, cell in enumerate(grid)
                   if i not in delivered]
        yield from self._serial_iter(work_fn, spec, pending, stop)

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

    # -- warm-session lifecycle ----------------------------------------------
    @property
    def session_active(self) -> bool:
        """True between :meth:`start` and :meth:`shutdown`."""
        return self._session

    def start(self) -> "DSEEngine":
        """Switch the engine into *warm-session* mode.

        One process pool and (with ``shared_cache``) one cross-process
        memo store are created now — workers forked/spawned up front,
        store attached to the parent's cache — and reused by every
        subsequent ``sweep`` / ``sweep_iter`` / ``sweep_cells_iter`` /
        ``search`` / ``reprice_grid`` call until :meth:`shutdown`,
        instead of being built and torn down per sweep. This is what the
        DSE service daemon (:mod:`repro_torch.service`) runs on: request
        latency stops paying pool spin-up, and solves harvested by one
        request seed every later one through the persistent store.

        Two session-mode consequences:

        * all workers predate later calls, so even the fork transport
          ships full task arguments — ``work_fn`` must be picklable
          (the scenario registry's builders all are);
        * calls must not run concurrently from multiple threads — the
          engine serializes nothing internally (the service scheduler
          owns exactly one engine thread for this reason).

        Idempotent; returns ``self`` so it nests in ``with``:
        ``with DSEEngine(...) as engine: ...``. If the pool cannot be
        built (or ``parallel=False`` / one worker), the session still
        starts — sweeps run serially against the warm store.
        """
        if self._session:
            return self
        store = self._open_shared_store()
        self._session_store = store
        self._session = True
        pool = None
        if self.parallel is not False and self.max_workers > 1:
            import concurrent.futures as cf

            try:
                pool = cf.ProcessPoolExecutor(
                    max_workers=self.max_workers,
                    mp_context=self._mp_context(),
                    **self._pool_kwargs(store))
                # force every worker into existence NOW: the daemon
                # starts its accept/scheduler threads after this, and
                # forking a multithreaded process later is the exact
                # hazard the transport auto-pick exists to avoid
                list(pool.map(_noop, range(self.max_workers * 4),
                              chunksize=1))
            except _pool_infra_errors() as exc:
                warnings.warn(
                    f"warm session pool unavailable ({exc!r}); session "
                    f"continues serially", RuntimeWarning, stacklevel=2)
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)
                pool = None
        self._session_pool = pool
        return self

    def shutdown(self) -> None:
        """End the warm session: drain + close the session pool, detach
        and tear down the session store (its aggregated cross-process
        stats land in ``last_shared_stats``). Idempotent."""
        pool, self._session_pool = self._session_pool, None
        store, self._session_store = self._session_store, None
        self._session = False
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        if store is not None:
            self._close_shared_store(store)

    def __enter__(self) -> "DSEEngine":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False

    # -- budgeted search -----------------------------------------------------
    def search(self, work_fn: Callable[[SystemSpec], TrainWorkload],
               spec: SweepSpec = SweepSpec(), *,
               policy, budget: int,
               certify: bool = True,
               progress: Callable[[dict], None] | None = None):
        """Budgeted adaptive exploration of ``spec``'s design grid.

        ``policy`` (a :class:`repro_torch.search.SearchPolicy`) proposes
        batches of grid indices; each batch is planned + priced through
        the same columnar pipeline as :meth:`sweep` (one batched
        ``plan_design_cells`` + ``price_planned`` call per batch on the
        configured pricing backend) and the priced observations feed
        back into the policy.  The loop ends when the policy stops
        asking or ``budget`` full evaluations are spent.

        The proposal contract is enforced strictly — an index out of
        range, proposed twice, or past the budget raises RuntimeError
        (exactly-once evaluation accounting is part of the result's
        meaning, not a best-effort hint).  Per-round progress records
        (evals, elapsed, ETA) accumulate in the result and stream
        through ``progress`` when given.

        ``certify=True`` (default, the house rule) evaluates the FULL
        grid through the identical machinery afterwards and requires the
        search winner to be the exhaustive argmin of the lexicographic
        ``(infeasible, iter_time, index)`` objective — a policy that
        misses the true winner raises rather than returning silently
        wrong results.  All values are bit-identical between search and
        oracle (same certified planning/pricing path), so the
        comparison is exact, not tolerance-based.
        """
        from ..search.policy import SearchContext, SearchResult
        from ..search.surrogate import cell_features

        grid = spec.grid()
        n = len(grid)
        if n == 0:
            raise ValueError("search needs a non-empty design grid")
        if int(budget) < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        granted = min(int(budget), n)
        t0 = time.perf_counter()
        cheap_evals = 0

        def cheap_bound(indices: Sequence[int]) -> list[tuple[bool, float]]:
            nonlocal cheap_evals
            idx = [int(i) for i in indices]
            bad = [i for i in idx if not 0 <= i < n]
            if bad:
                raise IndexError(f"cheap_bound indices out of range "
                                 f"(grid size {n}): {bad[:5]}")
            out: list = [None] * len(idx)
            cells = [grid[i] for i in idx]
            with self._cache_mode():
                for pos_list, work, systems in _group_cells(
                        work_fn, cells, spec.n_chips, spec.execution):
                    caps = [s.memory.capacity for s in systems]
                    cands = candidate_matrix(
                        work, systems[0], max_tp=spec.max_tp,
                        max_pp=spec.max_pp, execution=spec.execution,
                        prune=self.prune)
                    if not len(cands):
                        for pos in pos_list:
                            out[pos] = (True, math.inf)
                        continue
                    sel = cands.selection()
                    rows = winner_rows(sel["iter_time"],
                                       sel["per_chip_mem_bytes"], caps)
                    for pos, cap, r in zip(pos_list, caps, rows):
                        out[pos] = (
                            bool(sel["per_chip_mem_bytes"][r] > cap),
                            float(sel["iter_time"][r]))
            cheap_evals += len(idx)
            return out

        topo_vocab = {t: k for k, t in enumerate(spec.topologies)}

        def features(index: int):
            return cell_features(grid[int(index)], spec.n_chips, topo_vocab)

        policy.reset(SearchContext(n_points=n, budget=granted,
                                   cheap_bound=cheap_bound,
                                   features=features))
        evaluated: dict = {}
        rounds: list[dict] = []
        round_no = 0
        while len(evaluated) < granted:
            asked = [int(i) for i in policy.ask()]
            if not asked:
                break
            self._check_proposals(policy, asked, evaluated, granted, n)
            obs = self._search_eval(work_fn, spec, grid, asked,
                                    certify=round_no % CERTIFY_EVERY == 0)
            for o in obs:
                evaluated[o.index] = o
            policy.tell(obs)
            round_no += 1
            elapsed = time.perf_counter() - t0
            done = len(evaluated)
            best = min(evaluated.values(), key=lambda o: o.objective)
            record = {"round": round_no, "asked": len(asked),
                      "evals": done, "budget": granted,
                      "elapsed_s": elapsed,
                      "eta_s": elapsed / done * (granted - done),
                      "best_index": best.index,
                      "best_iter_time": best.iter_time,
                      "best_feasible": best.feasible}
            rounds.append(record)
            if progress is not None:
                progress(record)
        best = (min(evaluated.values(), key=lambda o: o.objective)
                if evaluated else None)
        oracle_index = None
        if certify:
            oracle = min(
                self._search_eval(work_fn, spec, grid, list(range(n)),
                                  certify="sample"),
                key=lambda o: o.objective)
            oracle_index = oracle.index
            if best is None or best.index != oracle.index:
                raise RuntimeError(
                    f"search policy {policy.name!r} missed the true argmin: "
                    f"policy best "
                    f"{(best.index, best.objective[:2]) if best else None} "
                    f"vs exhaustive argmin "
                    f"{(oracle.index, oracle.objective[:2])} "
                    f"(budget {granted}/{n}, evals {len(evaluated)})")
        return SearchResult(
            policy=policy.name, budget=granted, evals_used=len(evaluated),
            cheap_evals=cheap_evals, rounds=rounds,
            best_index=best.index if best else -1,
            best_point=best.point if best else None,
            best_objective=((best.feasible, best.iter_time)
                            if best else None),
            evaluated=evaluated, certified=certify,
            oracle_index=oracle_index,
            seconds=time.perf_counter() - t0)

    @staticmethod
    def _check_proposals(policy, asked, evaluated, budget: int,
                         n: int) -> None:
        """Exactly-once/bounded proposal contract (violations raise)."""
        seen: set[int] = set()
        for i in asked:
            if not 0 <= i < n:
                raise RuntimeError(
                    f"search policy {policy.name!r} proposed out-of-range "
                    f"index {i} (grid size {n})")
            if i in seen or i in evaluated:
                raise RuntimeError(
                    f"search policy {policy.name!r} proposed index {i} "
                    f"more than once")
            seen.add(i)
        if len(evaluated) + len(asked) > budget:
            raise RuntimeError(
                f"search policy {policy.name!r} exceeded the evaluation "
                f"budget: {len(evaluated)} evaluated + {len(asked)} "
                f"proposed > {budget}")

    def _search_eval(self, work_fn, spec: SweepSpec, grid, indices,
                     certify: bool | str):
        """Plan + price one proposed batch; one Observation per index.

        The same columnar path as :meth:`sweep` — memory variants in the
        batch share candidate enumerations, the backend prices one
        batch, and ``certify`` (the engine's sampled cadence) runs the
        scalar-scan check inside the planning call."""
        from ..search.policy import Observation

        cells = [grid[i] for i in indices]
        ranker, rkf = self._ranker_for_run()
        with self._cache_mode():
            planned = plan_design_cells(
                work_fn, cells, spec.n_chips, max_tp=spec.max_tp,
                max_pp=spec.max_pp, execution=spec.execution,
                pricing_backend=self.pricing_backend, prune=self.prune,
                ranker=ranker, rank_keep_frac=rkf, certify=certify,
                device=self.device, band=self.drift_band)
            pts = price_planned(planned, backend=self.pricing_backend,
                                device=self.device)
        live = [i for i, p in zip(indices, planned) if p is not None]
        by_index = dict(zip(live, pts))
        out = []
        for i in indices:
            pt = by_index.get(i)
            if pt is None:
                out.append(Observation(index=i, cell=grid[i], feasible=False,
                                       iter_time=math.inf, utilization=0.0,
                                       point=None))
            else:
                out.append(Observation(
                    index=i, cell=grid[i],
                    feasible=bool(pt.plan.feasible),
                    iter_time=float(pt.plan.iter_time),
                    utilization=float(pt.utilization), point=pt))
        return out

    # -- internals -----------------------------------------------------------
    def _should_parallelize(self, grid_size: int) -> bool:
        if self.parallel is False:
            return False
        if self._session_pool is not None:
            # the warm session pool is already paid for — even a small
            # service batch routes through it
            return True
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

    # -- shared memo store (one per parallel sweep) --------------------------
    def _open_shared_store(self):
        """Create the sweep's cross-process memo store and attach it to
        the parent's cache too (the parent's own misses then seed the
        workers).  ``None`` when disabled — or when caching is off, which
        must stay genuinely cold.

        In warm-session mode the session's persistent store is returned
        (re-attached if something detached it) instead of creating a new
        one — the store is shared across *requests*, not per-sweep."""
        if self._session_store is not None:
            if GLOBAL_CACHE.shared is not self._session_store:
                GLOBAL_CACHE.attach_shared(self._session_store)
            return self._session_store
        if not self.shared_cache or not self.use_cache:
            return None
        try:
            backend = (self.shared_cache
                       if self.shared_cache in ("mmap", "server")
                       else choose_backend(self._start_method()))
            store = create_store(backend, mp_context=self._mp_context())
        except (RuntimeError, OSError) as exc:
            # no usable backend on this platform (no fcntl, no AF_UNIX) or
            # the store could not materialize (unwritable TMPDIR, socket
            # bind failure — an OSError escaping here would otherwise land
            # in the callers' pool-infra fallback and needlessly serialize
            # the sweep): the cache tier must never take the sweep down —
            # keep the parallel pool, just with process-private caches
            warnings.warn(f"shared memo store unavailable ({exc}); "
                          f"sweeping with private caches", RuntimeWarning,
                          stacklevel=3)
            return None
        GLOBAL_CACHE.attach_shared(store)
        return store

    def _close_shared_store(self, store) -> None:
        """Detach + tear down the sweep's store, keeping its aggregated
        cross-process stats.  Runs in ``finally`` blocks so a pool failure
        (and the serial fallback after it) never leaks a store, a server
        process, or a stale attachment.

        The session store is NOT torn down here — it outlives individual
        sweeps by design; only its running stats are snapshotted.
        :meth:`shutdown` (which clears ``_session_store`` first) owns its
        teardown."""
        if store is None:
            return
        if store is self._session_store:
            try:
                self.last_shared_stats = store.stats()
            except Exception:
                self.last_shared_stats = None
            return
        if GLOBAL_CACHE.shared is store:
            GLOBAL_CACHE.detach_shared()
        try:
            self.last_shared_stats = store.stats()
        except Exception:
            self.last_shared_stats = None
        store.close()

    def _pool_kwargs(self, store) -> dict:
        """Extra ``ProcessPoolExecutor`` kwargs wiring workers to ``store``."""
        if store is None:
            return {}
        return {"initializer": _init_worker_shared,
                "initargs": (store.handle(),)}

    def _pool(self, workers: int, store):
        """Pool acquisition: the warm session pool when one is live
        (kept open on exit; rebuilt first if a dead worker poisoned it),
        else a fresh per-sweep pool torn down on exit."""
        import concurrent.futures as cf
        import contextlib

        if self._session_pool is not None:
            if getattr(self._session_pool, "_broken", False):
                # a BrokenProcessPool is permanent for its executor —
                # rebuild on the same session store so the warm session
                # (and the daemon on top of it) survives a worker death
                self._session_pool.shutdown(wait=False, cancel_futures=True)
                self._session_pool = None
                self._session = False
                self.start()
            if self._session_pool is not None:
                return contextlib.nullcontext(self._session_pool)
        pool = cf.ProcessPoolExecutor(max_workers=workers,
                                      mp_context=self._mp_context(),
                                      **self._pool_kwargs(store))

        @contextlib.contextmanager
        def owned():
            try:
                yield pool
            finally:
                pool.shutdown(wait=True, cancel_futures=True)

        return owned()

    # -- per-point path (the baseline) ---------------------------------------
    def _sweep_perpoint(self, work_fn, spec: SweepSpec, grid):
        results = None
        if self._should_parallelize(len(grid)):
            try:
                results = self._parallel_eval(work_fn, spec, grid)
            except _pool_infra_errors() as exc:
                # pool infrastructure failed (no start method, worker died,
                # unpicklable work_fn under spawn) — the sweep itself is
                # still fine serially. work_fn errors are NOT caught: they
                # propagate with their real traceback.
                warnings.warn(f"parallel sweep unavailable ({exc!r}); "
                              f"falling back to serial", RuntimeWarning,
                              stacklevel=2)
        if results is None:
            results = self._serial_eval(work_fn, spec, grid)
        return [p for p in results if p is not None]

    def _serial_eval(self, work_fn, spec: SweepSpec, grid):
        with self._cache_mode():
            return [evaluate_design_point(work_fn, cell, spec.n_chips,
                                          max_tp=spec.max_tp,
                                          max_pp=spec.max_pp,
                                          execution=spec.execution)
                    for cell in grid]

    def _parallel_eval(self, work_fn, spec: SweepSpec, grid):
        # Submission order: group the memory variants of each
        # (chip, net, topology) so they land in one worker chunk and share
        # the memory-independent plan solve. The reduce below restores grid
        # order exactly, so submission order never affects the result.
        order = sorted(range(len(grid)),
                       key=lambda i: (grid[i][0], grid[i][2], grid[i][3],
                                      grid[i][1]))
        group = max(1, len(grid) //
                    max(1, len({(c, n, t) for c, _m, n, t in grid})))
        workers = min(self.max_workers, len(grid))
        per_worker = math.ceil(len(grid) / workers)
        # keep chunks small enough that every worker gets work
        chunk = min(max(group, 1), max(1, per_worker))
        method = self._start_method()
        store = self._open_shared_store()
        try:
            if method != "fork" or self._session_pool is not None:
                # spawn/forkserver ship full task args — requires a
                # picklable work_fn; an unpicklable one is an infra error
                # → serial fallback. A warm session pool's workers were
                # forked at start(), before this call could park anything
                # in _WORKER_CTX, so the session always ships args too.
                _require_picklable(work_fn)
                tasks = [(work_fn, grid[i], spec.n_chips, spec.max_tp,
                          spec.max_pp, spec.execution) for i in order]
                fn, payload = _eval_args, tasks
            else:
                _WORKER_CTX.update(work_fn=work_fn, grid=grid,
                                   n_chips=spec.n_chips, max_tp=spec.max_tp,
                                   max_pp=spec.max_pp,
                                   execution=spec.execution)
                fn, payload = _eval_index, order
            with self._cache_mode():
                with self._pool(workers, store) as pool:
                    mapped = pool.map(fn, payload, chunksize=chunk)
                    out: list[DesignPoint | None] = [None] * len(grid)
                    for j, point in zip(order, mapped):
                        out[j] = point
                    return out
        finally:
            _WORKER_CTX.clear()
            self._close_shared_store(store)

    # -- phased path ---------------------------------------------------------
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
        # the parent trains (or refits) the ranker ONCE per sweep and
        # ships the frozen model with the tasks — every worker of every
        # transport ranks with the identical model, so results stay
        # deterministic across fork/spawn/forkserver and worker count
        ranker, rkf = self._ranker_for_run()
        method = self._start_method()
        if method != "fork" or self._session_pool is not None:
            # non-fork transports — and the warm session pool, whose
            # workers were forked at start() before this call existed —
            # ship full task arguments instead of _WORKER_CTX
            _require_picklable(work_fn)
            payload = [(work_fn, [grid[i] for i in idxs], idxs, spec.n_chips,
                        spec.max_tp, spec.max_pp, spec.execution, ship,
                        self.prune, ranker, rkf, cert)
                       for idxs, cert in zip(groups, certify)]
            return _plan_group_args, payload, False
        _WORKER_CTX.update(work_fn=work_fn, grid=grid, n_chips=spec.n_chips,
                           max_tp=spec.max_tp, max_pp=spec.max_pp,
                           execution=spec.execution, ship_matrix=ship,
                           prune=self.prune, ranker=ranker,
                           rank_keep_frac=rkf)
        return _plan_group_index, list(zip(groups, certify)), True

    def _parallel_plan(self, work_fn, spec: SweepSpec, grid
                       ) -> list[PlannedPoint | None]:
        workers = min(self.max_workers, max(1, len(grid) // 2))
        store = self._open_shared_store()
        used_ctx = False
        try:
            fn, payload, used_ctx = self._plan_tasks(work_fn, spec, grid)
            with self._cache_mode():
                with self._pool(workers, store) as pool:
                    groups = [g for result in pool.map(fn, payload)
                              for g in result]
        finally:
            if used_ctx:
                _WORKER_CTX.clear()
            self._close_shared_store(store)
        return self._finish_plan_groups(groups, len(grid))

    def _finish_plan_groups(self, groups: list[PlannedGroup], n_cells: int
                            ) -> list[PlannedPoint | None]:
        """Reduce worker-shipped plan groups into a grid-aligned list.

        With a non-numpy backend, the shipped candidate matrices —
        PRUNED to the surviving rows when pruning ran — are
        row-concatenated and priced in ONE batched ``price_plans`` call,
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
        # serial phased path: the banded certification ran inside
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
            # learned rank stage: ``survived`` keeps its meaning
            # (dominance survivors); ``rank_survived`` is what actually
            # got priced when the rank stage ran (== survived otherwise)
            "rank": any(s.get("ranked") for s in pstats),
            "rank_survived": sum(s.get("rank_survived", s["survived"])
                                 for s in pstats),
            "rank_keep_frac": next((s["rank_keep_frac"] for s in pstats
                                    if s.get("ranked")), None),
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

    def _resolved_rank(self) -> bool:
        from ..learned.rank import resolve_rank

        return resolve_rank(self.rank)

    def _ranker_for_run(self):
        """``(ranker, keep_frac)`` for the sweep about to run, or
        ``(None, None)`` when the rank stage is off / must degrade.

        The model is fitted from the memo cache's ``candmat`` harvest
        (:func:`repro_torch.learned.model.fit_ranker`) the first time a
        ranked sweep runs and REFITTED only when
        :meth:`repro_torch.core.memo.SolveCache.diff_stats` shows the harvest
        gained entries since the last fit — warm service sessions retrain
        incrementally across requests instead of once per sweep.  When
        the in-process harvest is below the staleness guard, a persisted
        model at ``rank_model_path`` (if any) is loaded instead; with
        neither, the sweep degrades to rank-off — correctness never
        depends on the model, so degrading is always safe."""
        if not (self._resolved_rank() and self._resolved_prune()):
            return None, None
        from ..learned.model import LearnedModel, fit_ranker

        delta = GLOBAL_CACHE.diff_stats(self._rank_snapshot)
        grew = delta["by_space"].get("candmat", (0, 0, 0))[2] > 0
        if self._ranker is None or grew:
            self._rank_snapshot = GLOBAL_CACHE.stats()
            model = fit_ranker()
            if model is not None:
                self._ranker = model
                if self.rank_model_path:
                    try:
                        model.save(self.rank_model_path)
                    except OSError:
                        pass  # unwritable path never takes the sweep down
            elif self._ranker is None and self.rank_model_path:
                try:
                    self._ranker = LearnedModel.load(self.rank_model_path)
                except (OSError, ValueError):
                    pass  # absent/stale file: degrade, don't die
        if self._ranker is None:
            return None, None
        return self._ranker, self.rank_keep_frac

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
        ranker, rkf = self._ranker_for_run()
        groups: list[_RepriceGroup] = []
        enumerated = 0
        empty_groups = 0
        dom_survived = 0
        rank_survived = 0
        with self._cache_mode():
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
                rank_ctx = None
                if ranker is not None:
                    from ..learned.features import system_features

                    rank_ctx = system_features(system.chip, system.n_chips,
                                               system.topology.name)
                sel = select_candidates(cands, caps, prune=self.prune,
                                        ranker=ranker, rank_keep_frac=rkf,
                                        rank_context=rank_ctx)
                dom_survived += sel.stats["survived"]
                rank_survived += sel.stats["rank_survived"]
                matrix = (cands.pruned(max(caps), ranker=ranker,
                                       keep_frac=rkf,
                                       rank_context=rank_ctx,
                                       rank_capacities=caps).matrix
                          if prune_on else cands.matrix)
                groups.append(_RepriceGroup(matrix, caps, tuple(sel.rows),
                                            sel.survivors))
        plan_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        priced_rows = 0
        chunks = 0
        with self._cache_mode():
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
            "rank": ranker is not None,
            "rank_keep_frac": (None if ranker is None
                               else rkf if rkf is not None
                               else ranker.keep_frac),
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

    def _serial_iter(self, work_fn, spec: SweepSpec, cells, stop):
        """Lazily stream (index, cell) pairs in order."""
        ranker, rkf = self._ranker_for_run()
        with self._cache_mode():
            for j, (i, cell) in enumerate(cells):
                # one cell per planning call: pick the scalar-certify
                # sample here (the call-local "sample" cadence would
                # certify every single-group call)
                planned = plan_design_cells(
                    work_fn, [cell], spec.n_chips, max_tp=spec.max_tp,
                    max_pp=spec.max_pp, execution=spec.execution,
                    pricing_backend=self.pricing_backend,
                    prune=self.prune, ranker=ranker, rank_keep_frac=rkf,
                    certify=j % CERTIFY_EVERY == 0,
                    device=self.device, band=self.drift_band)
                pts = price_planned(planned, backend=self.pricing_backend,
                                    device=self.device)
                item = SweepItem(i, cell, pts[0] if pts else None)
                yield item
                if stop is not None and stop(item):
                    return

    def _parallel_iter(self, work_fn, spec: SweepSpec, grid, stop):
        import concurrent.futures as cf

        workers = min(self.max_workers, max(1, len(grid) // 2))
        window = max(2 * workers, workers + 1)
        store = self._open_shared_store()
        used_ctx = False
        try:
            fn, payload, used_ctx = self._plan_tasks(work_fn, spec, grid)
            with self._pool(workers, store) as pool:
                with self._cache_mode():
                    queue = iter(payload)
                    pending: set = set()
                    for task in queue:
                        pending.add(pool.submit(fn, task))
                        if len(pending) >= window:
                            break
                    try:
                        while pending:
                            done, pending = cf.wait(
                                pending, return_when=cf.FIRST_COMPLETED)
                            for fut in done:
                                for group in fut.result():
                                    for item in self._stream_group(grid,
                                                                   group):
                                        yield item
                                        if stop is not None and stop(item):
                                            return
                                for task in queue:
                                    pending.add(pool.submit(fn, task))
                                    if len(pending) >= window:
                                        break
                    finally:
                        # early stop / abandoned generator: cancel what
                        # never started (matters on the session pool,
                        # which outlives this call)
                        for f in pending:
                            f.cancel()
        finally:
            if used_ctx:
                _WORKER_CTX.clear()
            self._close_shared_store(store)

    def _stream_group(self, grid, group: PlannedGroup) -> list[SweepItem]:
        # certify the worker's candidate argmin on a non-numpy parent
        # backend (over the pruned rows, remapped through the survivor
        # map) and the sampled pruning certification, then price the
        # group's winners (one batch per group — elementwise over the
        # batch axis, so streamed values match a full sweep's bits)
        if len(group.matrix) and self._resolved_backend() != "numpy":
            priced = price_plans(group.matrix.cols,
                                 backend=self._resolved_backend(),
                                 device=self.device)
            self._verify_group_winners(priced["iter_time"],
                                       priced["per_chip_mem_bytes"], group)
        self._certify_group_prune(group)
        pairs = list(zip(group.indices, group.planned))
        live = [(i, p) for i, p in pairs if p is not None]
        pts = price_planned([p for _, p in live],
                            backend=self.pricing_backend, device=self.device)
        by_index = {i: pt for (i, _), pt in zip(live, pts)}
        return [SweepItem(i, grid[i], by_index.get(i)) for i, _ in pairs]

    def _cache_mode(self):
        if self.use_cache:
            import contextlib

            return contextlib.nullcontext()
        return caching_disabled()
