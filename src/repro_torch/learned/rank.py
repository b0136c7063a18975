"""The rank stage: policy resolution + the winner-preserving keep rule.

Where it sits in the pipeline: enumerate → prune (feasibility +
dominance) → **rank** → price → certify.  The rank stage runs on the
dominance survivors of one candidate group and keeps

    (the learned model's top ``keep_frac`` fraction by predicted
     iteration time)  ∪  (the rows the dominance lower bound cannot
     exclude at the group's actual memory capacities)

The second set — :func:`bound_keep` — is what makes the stage
winner-preserving *by construction*: for each capacity the group will
actually be selected at, the exact winner time is already known from the
dominance filter's selection prepass (``iter_time`` there is the exact
scalar expression, not an approximation), so any row whose *lower bound*
``iter_lb`` exceeds it provably cannot be that capacity's winner.  The
rows no capacity can exclude that way — plus the no-feasible fallback
row — are kept regardless of what the model thinks.  The model's top-k
rides along as the learned keep-set whose recall the calibration in
:mod:`repro_torch.learned.model` states.  Runtime certification (sampled
scalar full-matrix scans inside ``plan_design_groups``) re-proves winner
identity on every sweep under the house certify-or-die rule.

Policy: ``rank="auto"`` means **off** (the learned stage is opt-in:
unlike the dominance filter it needs a harvest to be useful, and a cold
process has none).  The keep fraction is an argument
(``DSEEngine(rank_keep_frac=...)``); ``None`` means the model's
calibrated fraction.  Nothing here reads the environment.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .model import rank_keep_count

RANK_MODES = ("on", "off", "auto")


def resolve_rank(policy: str | bool) -> bool:
    """Normalize a ``rank=`` policy to a bool (``"auto"`` → off); anything
    but a bool or one of :data:`RANK_MODES` raises."""
    if isinstance(policy, bool):
        return policy
    if policy not in RANK_MODES:
        raise ValueError(f"unknown rank policy {policy!r}; "
                         f"expected a bool or one of {RANK_MODES}")
    return policy == "on"


def bound_keep(iter_time: np.ndarray, iter_lb: np.ndarray,
               mem: np.ndarray, capacities: Sequence[float]) -> np.ndarray:
    """The rows the dominance lower bound cannot exclude — the rank
    stage's certification safety set, evaluated per *actual* capacity.

    For capacity ``c`` the winner time ``W_c = min(iter_time[mem <= c])``
    is exact (the selection prepass computes the full scalar iteration-
    time expression), so a feasible row with ``iter_lb > W_c`` provably
    loses at ``c``: its true time is at least its lower bound.  A row is
    kept iff some capacity cannot exclude it — ``mem <= c`` and
    ``iter_lb <= W_c`` — plus the first global ``iter_time`` argmin,
    which is the selection's fallback winner when no row fits.  Every
    per-capacity lexicographic winner satisfies ``iter_lb <= iter_time =
    W_c`` at its own capacity, so dropping the complement is winner-
    preserving regardless of the model's opinion of it."""
    it = np.asarray(iter_time)
    lb = np.asarray(iter_lb)
    m = np.asarray(mem)
    keep = np.zeros(len(it), dtype=bool)
    if not len(it):
        return keep
    for cap in {float(c) for c in capacities}:
        feas = m <= cap
        if feas.any():
            keep |= feas & (lb <= it[feas].min())
    keep[int(np.argmin(it))] = True  # the no-feasible fallback winner
    return keep


def rank_keep(scores: np.ndarray, iter_time: np.ndarray,
              iter_lb: np.ndarray, mem: np.ndarray,
              capacities: Sequence[float], keep_frac: float) -> np.ndarray:
    """Boolean keep-mask of the rank stage over one group's dominance
    survivors: the model's top ``ceil(keep_frac * n)`` rows by
    ``scores`` (ascending, enumeration order breaking ties) unioned with
    the :func:`bound_keep` safety set."""
    n = len(scores)
    keep = np.zeros(n, dtype=bool)
    if n == 0:
        return keep
    order = np.lexsort((np.arange(n), np.asarray(scores)))
    keep[order[:rank_keep_count(n, keep_frac)]] = True
    keep |= bound_keep(iter_time, iter_lb, mem, capacities)
    return keep
