"""Surrogate-guided search + the memo-store harvest that trains it.

Two regression surfaces share the ridge machinery here:

* **cell level** — :func:`cell_features` maps a grid cell to a
  system-spec feature vector (chip / memory / interconnect / topology
  numbers, no planning required), and :class:`SurrogateSearch` regresses
  observed winner iteration times on those features to re-rank the
  unevaluated cells each round.
* **plan level** — :func:`plan_feature_rows` harvests the memoised
  candidate sets (memo space ``"candmat"``, via
  :meth:`repro_torch.core.memo.SolveCache.harvest`) into
  ``(PlanVector-feature rows → selection iter_time)`` training pairs,
  and :func:`fit_plan_ridge` fits the same ridge on them.  The harvest
  merges tiers: the local in-process tier first, then shared-store
  entries other workers of the sweep computed — deduplicated by key
  with the local entry winning a collision, and shared entries that
  fail to unpickle (version skew) skipped rather than raised.  Each
  cell observation's target is exactly the minimum of its group's
  plan-level targets, so the two surfaces are consistent by
  construction.

The plan-level harvest is the training feed of the *shipped* learned
cost model: :mod:`repro_torch.learned` extends these feature rows with an
Eq. 7-shaped derived basis plus a per-group system block, calibrates a
keep-threshold, and runs as a certified third pruning stage inside
``plan_design_groups`` (see ``docs/LEARNED.md``).

Everything is deterministic: the ridge solves closed-form normal
equations (no iterative optimizer), and the only randomness —
exploration picks in :class:`SurrogateSearch` — flows from the
constructor seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np

from ..core.memo import GLOBAL_CACHE, SolveCache
from ..systems.chips import (resolve_chip, resolve_interconnect,
                             resolve_memory)
from .policy import Observation, SearchContext, SearchPolicy

#: PlanVector fields the plan-level surrogate regresses on: the inputs of
#: the iter_time expression in ``pricing._price`` (stage times, pipeline
#: shape, backward multipliers) — deliberately NOT the outputs.
PLAN_FEATURE_FIELDS = ("t_comp_stage", "t_net_stage", "t_p2p", "t_dp",
                       "n_micro", "tp", "pp", "layers_per_stage",
                       "bwd_flop_mult", "bwd_comm_mult")


def cell_features(cell: Sequence[str], n_chips: int,
                  topo_vocab: Mapping[str, int]) -> np.ndarray:
    """System-spec feature vector for one grid cell.

    Log-scaled hardware magnitudes (they span orders of magnitude
    across a dense grid) plus a one-hot over the grid's topology
    vocabulary.  Resolves scaled variant names (``"H100@x1.25"``)
    through the same pure resolvers ``dse.build_system`` uses, so
    features and evaluation always describe the same system.
    """
    chip = resolve_chip(cell[0])
    mem = resolve_memory(cell[1])
    net = resolve_interconnect(cell[2])
    base = [math.log10(chip.peak_flops),
            math.log10(chip.sram_capacity),
            float(chip.dataflow),
            math.log10(mem.bandwidth),
            math.log10(mem.capacity),
            math.log10(net.bandwidth),
            math.log10(net.latency * 1e9),
            math.log10(n_chips)]
    onehot = [0.0] * len(topo_vocab)
    onehot[topo_vocab[cell[3]]] = 1.0
    return np.asarray(base + onehot, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class RidgeModel:
    """Standardized ridge regression, fit by closed-form normal equations."""

    mean: np.ndarray              # per-feature standardization mean
    std: np.ndarray               # per-feature standardization scale
    beta: np.ndarray              # coefficients, intercept last

    @classmethod
    def fit(cls, X: np.ndarray, y: np.ndarray,
            lam: float = 1e-3) -> "RidgeModel":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        mean = X.mean(axis=0)
        std = X.std(axis=0)
        std = np.where(std > 0, std, 1.0)
        Z = np.column_stack([(X - mean) / std, np.ones(len(X))])
        A = Z.T @ Z + lam * np.eye(Z.shape[1])
        beta = np.linalg.solve(A, Z.T @ y)
        return cls(mean=mean, std=std, beta=beta)

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        Z = np.column_stack([(X - self.mean) / self.std, np.ones(len(X))])
        return Z @ self.beta


def plan_feature_rows(cache: SolveCache | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Harvest ``(plan-feature matrix, iter_time targets)`` from the
    memoised candidate sets.

    Every planned system group leaves its :class:`CandidateSet` in memo
    space ``"candmat"``; each candidate row contributes one training
    pair: its :data:`PLAN_FEATURE_FIELDS` columns and its exact
    ``selection_columns`` iteration time.  With a shared store attached
    the harvest also merges in candidate sets computed by other
    processes of the sweep — local tier first, shared entries
    deduplicated against it (see :meth:`SolveCache.harvest`).  The
    richer-featured variant powering the learned rank stage is
    :func:`repro_torch.learned.features.harvest_rows`.
    """
    cache = GLOBAL_CACHE if cache is None else cache
    xs, ys = [], []
    for _key, cands in cache.harvest("candmat"):
        if not len(cands):
            continue
        sel = cands.selection()
        cols = cands.matrix.cols
        xs.append(np.stack([np.asarray(cols[f], dtype=np.float64)
                            for f in PLAN_FEATURE_FIELDS], axis=1))
        ys.append(np.asarray(sel["iter_time"], dtype=np.float64))
    if not xs:
        return (np.zeros((0, len(PLAN_FEATURE_FIELDS))), np.zeros(0))
    return np.concatenate(xs), np.concatenate(ys)


def fit_plan_ridge(cache: SolveCache | None = None,
                   lam: float = 1e-3) -> RidgeModel | None:
    """Fit the plan-level surrogate on the harvested training set
    (``None`` when the cache holds no candidate sets yet)."""
    X, y = plan_feature_rows(cache)
    if not len(X):
        return None
    # iter_time spans orders of magnitude — regress its log
    return RidgeModel.fit(X, np.log10(np.maximum(y, 1e-30)), lam=lam)


#: Log-target penalty for memory-infeasible observations: large enough
#: that any feasible cell predicts better than any infeasible one (the
#: lexicographic objective), small enough to keep the solve conditioned.
_INFEASIBLE_PENALTY = 100.0
#: Stand-in target for undecomposable cells (iter_time = inf).
_UNDECOMPOSABLE_Y = 1e6


class SurrogateSearch(SearchPolicy):
    """Ridge-surrogate search: observe, refit, re-rank, repeat.

    Each round fits :class:`RidgeModel` on the cell features of every
    observation so far (target: log winner iteration time, plus a fixed
    penalty for memory-infeasible cells so feasibility dominates the
    ranking, mirroring the lexicographic objective) and proposes the
    unevaluated cells with the best predictions — salted with an
    ``explore`` fraction of seeded random picks so a misfit model cannot
    lock the search out of a region.  Until ``min_train`` observations
    exist the policy explores randomly (a model fit on two points is
    noise).

    ``warm_start`` accepts ``(features, target)`` arrays in the same
    cell-feature space — e.g. rows carried over from a previous search
    on an overlapping grid — which join every refit as extra training
    rows.  The plan-level counterpart (training pairs harvested from the
    shared memo store) is exposed by :func:`plan_feature_rows` /
    :func:`fit_plan_ridge`.
    """

    name = "surrogate"

    def __init__(self, seed: int = 0, batch_size: int = 16,
                 explore: float = 0.25, min_train: int = 8,
                 ridge_lambda: float = 1e-3,
                 warm_start: tuple[np.ndarray, np.ndarray] | None = None
                 ) -> None:
        if not 0.0 <= explore <= 1.0:
            raise ValueError(f"explore must be in [0, 1], got {explore}")
        self.seed = seed
        self.batch_size = batch_size
        self.explore = explore
        self.min_train = min_train
        self.ridge_lambda = ridge_lambda
        self.warm_start = warm_start

    def reset(self, ctx: SearchContext) -> None:
        super().reset(ctx)
        self._rng = np.random.default_rng(self.seed)
        self._features = np.stack([ctx.features(i)
                                   for i in range(ctx.n_points)])
        if self.warm_start is not None:
            wx = np.asarray(self.warm_start[0], dtype=np.float64)
            if wx.ndim != 2 or wx.shape[1] != self._features.shape[1]:
                raise ValueError(
                    f"warm_start features have shape {wx.shape}; expected "
                    f"(*, {self._features.shape[1]})")
        self._train_idx: list[int] = []
        self._train_y: list[float] = []
        self._proposed: set[int] = set()
        self._asked = 0

    def ask(self) -> list[int]:
        k = self._grant(self.batch_size, self._asked)
        pool = [i for i in range(self.ctx.n_points)
                if i not in self._proposed]
        k = min(k, len(pool))
        if k == 0:
            return []
        if len(self._train_y) < self.min_train:
            picked = [int(pool[j]) for j in
                      self._rng.choice(len(pool), size=k, replace=False)]
        else:
            model = self._fit()
            pred = model.predict(self._features[pool])
            order = np.lexsort((pool, pred))  # prediction, grid index
            n_explore = int(math.floor(k * self.explore))
            exploit = [int(pool[j]) for j in order[:k - n_explore]]
            rest = [int(pool[j]) for j in order[k - n_explore:]]
            explore = ([int(rest[j]) for j in
                        self._rng.choice(len(rest), size=min(n_explore,
                                                             len(rest)),
                                         replace=False)]
                       if rest and n_explore else [])
            picked = exploit + explore
        self._proposed.update(picked)
        self._asked += len(picked)
        return picked

    def tell(self, observations: Sequence[Observation]) -> None:
        for obs in observations:
            y = (math.log10(obs.iter_time)
                 if math.isfinite(obs.iter_time) and obs.iter_time > 0
                 else _UNDECOMPOSABLE_Y)
            if not obs.feasible:
                y += _INFEASIBLE_PENALTY
            self._train_idx.append(obs.index)
            self._train_y.append(float(y))

    def _fit(self) -> RidgeModel:
        X = self._features[self._train_idx]
        y = np.asarray(self._train_y)
        if self.warm_start is not None:
            X = np.concatenate([X, np.asarray(self.warm_start[0],
                                              dtype=np.float64)])
            y = np.concatenate([y, np.asarray(self.warm_start[1],
                                              dtype=np.float64)])
        return RidgeModel.fit(X, y, lam=self.ridge_lambda)
