"""Budgeted search policies over the DSE design grid.

The exhaustive sweep (:meth:`repro_torch.core.dse_engine.DSEEngine.sweep`)
prices every grid cell; that stops scaling exactly where DFModel becomes
most useful — dense grids interpolating between the paper's Table V
technology points (:class:`repro_torch.search.grid.DenseGridSpec`) run to
thousands of cells and beyond.  A :class:`SearchPolicy` explores such a
grid under a fixed *evaluation budget*: the engine repeatedly asks the
policy for a batch of grid indices, plans + prices exactly that batch
through the columnar pipeline (one ``plan_design_cells`` +
``price_planned`` call per batch, so the CUDA pricing kernel sees real
batches, never single rows), and feeds the priced results back via
:meth:`SearchPolicy.tell`.

The engine-side loop lives in :meth:`repro_torch.core.dse_engine.DSEEngine.search`;
it enforces the contract strictly — every proposed index in range,
proposed at most once, never more proposals than budget — and certifies
the search winner against the exhaustive pruned sweep's true argmin
(house rule: certified or raised, never silently wrong).

Objective
---------
A cell's objective is the lexicographic key
``(not feasible, iter_time, grid index)`` — memory-feasible systems
first, fastest iteration time among them, first grid index on exact
ties.  This is precisely the key the exhaustive pipeline minimizes per
cell (``interchip.winner_rows`` + the priced feasibility bit), so a
search winner and the exhaustive winner are comparable bit-for-bit.
Undecomposable cells (the exhaustive sweep *skips* them) enter as
``(infeasible, inf)`` — they sort last and can never win against a
decomposable cell.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np

from ..core.dse import DesignPoint, GridCell


@dataclasses.dataclass(frozen=True)
class Observation:
    """One evaluated grid cell, as fed back to a policy."""

    index: int                    # grid index
    cell: GridCell
    feasible: bool                # winner fits the memory capacity
    iter_time: float              # winner iteration time (inf: undecomposable)
    utilization: float
    point: DesignPoint | None     # None for undecomposable cells

    @property
    def objective(self) -> tuple[bool, float, int]:
        """The lexicographic minimization key (see module docstring)."""
        return (not self.feasible, self.iter_time, self.index)


@dataclasses.dataclass
class SearchContext:
    """What the engine hands a policy at :meth:`SearchPolicy.reset`.

    ``budget`` is the number of *full* evaluations the engine will grant
    (already clamped to the grid size); ``cheap_bound`` is the
    low-fidelity oracle — the numpy selection prepass
    (:func:`repro_torch.core.pricing.selection_columns`) over the cell's
    candidate enumeration, whose ``iter_time`` / memory columns are
    bit-identical to full pricing, so the returned
    ``(infeasible, iter_time)`` key per index is the cell's EXACT
    objective prefix, obtained without the full pricing formula, the
    intra-chip refinement, or the efficiency terms.  ``features`` maps a
    grid index to its system-level feature vector (chip / memory /
    interconnect / topology numbers — no planning involved), the input
    space surrogate policies regress on.
    """

    n_points: int
    budget: int
    cheap_bound: Callable[[Sequence[int]], list[tuple[bool, float]]]
    features: Callable[[int], np.ndarray]


@dataclasses.dataclass
class SearchResult:
    """Outcome of one :meth:`DSEEngine.search` run."""

    policy: str                   # policy name
    budget: int                   # granted full-evaluation budget
    evals_used: int               # full evaluations actually spent
    cheap_evals: int              # low-fidelity bound evaluations
    rounds: list[dict]            # per-round progress records (with ETA)
    best_index: int               # grid index of the search winner (-1: none)
    best_point: DesignPoint | None
    best_objective: tuple[bool, float] | None  # (feasible, iter_time)
    evaluated: dict[int, Observation]
    certified: bool               # oracle comparison ran and matched
    oracle_index: int | None      # exhaustive argmin (when certified)
    seconds: float


class SearchPolicy:
    """Ask/tell interface the engine drives.

    Lifecycle: ``reset(ctx)`` once per search, then rounds of
    ``ask() -> [indices]`` / ``tell([observations])`` until the policy
    returns an empty ask or the budget is spent.  Policies must be
    deterministic given their seed: same seed → same proposal sequence →
    same winner (``tests/test_torch_search.py`` locks this in).

    Contract (enforced by the engine, violations raise): each ask may
    only propose in-range indices, never an index twice across the whole
    search, and never more total indices than ``ctx.budget``.
    """

    name = "policy"

    def reset(self, ctx: SearchContext) -> None:
        self.ctx = ctx

    def ask(self) -> list[int]:  # pragma: no cover - interface
        raise NotImplementedError

    def tell(self, observations: Sequence[Observation]) -> None:
        pass

    # shared budget bookkeeping for subclasses
    def _grant(self, want: int, asked_so_far: int) -> int:
        return max(0, min(want, self.ctx.budget - asked_so_far))


class RandomSearch(SearchPolicy):
    """Pure random exploration: a seeded permutation of the grid,
    proposed in fixed-size batches.  The baseline every adaptive policy
    must beat — and, given ``budget >= n_points``, an exhaustive sweep in
    shuffled order (which is how the smoke certification exercises it).
    """

    name = "random"

    def __init__(self, seed: int = 0, batch_size: int = 16) -> None:
        self.seed = seed
        self.batch_size = batch_size

    def reset(self, ctx: SearchContext) -> None:
        super().reset(ctx)
        rng = np.random.default_rng(self.seed)
        self._order = [int(i) for i in rng.permutation(ctx.n_points)]
        self._asked = 0

    def ask(self) -> list[int]:
        k = self._grant(self.batch_size, self._asked)
        out = self._order[self._asked:self._asked + k]
        self._asked += len(out)
        return out


class SuccessiveHalving(SearchPolicy):
    """Two-fidelity successive halving over the cheap selection bound.

    Rung 0 prices the *cheap lower-bound columns* of every grid cell
    (``ctx.cheap_bound`` → ``pricing.selection_columns`` over the
    candidate enumeration: one numpy prepass per system group, no full
    pricing formula, no intra-chip refinement).  Survivors — the top
    ``ceil(n / eta)`` cells by the bound's ``(infeasible, iter_time)``
    key — are promoted to full pricing, proposed in rank order.

    Because the selection prepass's ``iter_time`` and memory columns are
    bit-identical to full pricing (the certified property the pruning
    stage is built on), the cheap key here is not an estimate but the
    cell's exact objective prefix: further halving rungs could never
    re-rank survivors, so the classic multi-rung ladder collapses to a
    single promotion round — and the true argmin is, by construction,
    the *first* cell promoted.  That makes certification deterministic
    at any ``budget >= 1`` while spending only ``ceil(n / eta)`` full
    evaluations (≤ 20 % of exhaustive on the dense grid).
    """

    name = "halving"

    def __init__(self, eta: int = 8, batch_size: int = 32,
                 max_promoted: int | None = None) -> None:
        if eta < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        self.eta = eta
        self.batch_size = batch_size
        self.max_promoted = max_promoted

    def reset(self, ctx: SearchContext) -> None:
        super().reset(ctx)
        bounds = ctx.cheap_bound(range(ctx.n_points))
        rank = sorted(range(ctx.n_points),
                      key=lambda i: (bounds[i][0], bounds[i][1], i))
        promote = max(1, math.ceil(ctx.n_points / self.eta))
        if self.max_promoted is not None:
            promote = min(promote, self.max_promoted)
        self._queue = rank[:min(promote, ctx.budget)]
        self._asked = 0

    def ask(self) -> list[int]:
        k = self._grant(self.batch_size, self._asked)
        out = self._queue[self._asked:self._asked + k]
        self._asked += len(out)
        return out


#: The policy spellings a DSE-service query may carry (`mode="search"`).
POLICY_NAMES = ("random", "halving", "surrogate")


def make_policy(name: str, *, seed: int = 0,
                batch_size: int | None = None) -> SearchPolicy:
    """Construct a shipped policy from its wire name.

    The DSE service (:mod:`repro_torch.service`) ships policies *by name* —
    a request is plain data, never a pickled callable — and this is the
    one place those names resolve. Unknown names raise ``ValueError``
    (the daemon turns that into a structured error reply).
    """
    kwargs = {} if batch_size is None else {"batch_size": int(batch_size)}
    if name == "random":
        return RandomSearch(seed=seed, **kwargs)
    if name == "halving":
        return SuccessiveHalving(**kwargs)
    if name == "surrogate":
        from .surrogate import SurrogateSearch

        return SurrogateSearch(seed=seed, **kwargs)
    raise ValueError(f"unknown search policy {name!r}; "
                     f"available: {POLICY_NAMES}")
