"""The learned cost model: ridge regressor + calibrated keep-threshold.

Training flow (the design: ``docs/LEARNED.md``):

1. :func:`~repro_torch.learned.features.harvest_rows` turns the memoised
   candidate sets into ``(feature row → selection iter_time)`` pairs,
   one per enumerated candidate, grouped by candidate set.
2. A :class:`~repro_torch.search.surrogate.RidgeModel` (closed-form normal
   equations, standardized — the same machinery the search surrogate
   uses) regresses iteration time on the features.
3. **Quantile calibration** turns the score into a keep-threshold with a
   stated recall target: for every harvested group, find the fractional
   rank ``rank/n`` of the group's true argmin under the model's
   ordering (the fraction a keep-threshold must *exceed* to capture it,
   since the stage keeps ``ceil(keep_frac · n)`` rows); the calibrated
   ``keep_frac`` is just above the ``recall_target`` quantile of those
   fractions — the smallest top-fraction that would have contained the
   true winner in at least ``recall_target`` of the harvested groups.

The calibration is a *quality* statement, not a correctness one: the
rank stage always unions the model's top-k with the exact-bound
dominance staircase (:func:`repro_torch.learned.rank.rank_keep`), so winners
are preserved even by a maximally wrong model — and certified at
runtime under the house certify-or-die rule.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
import os

import numpy as np

from ..search.surrogate import RidgeModel
from .features import FEATURE_NAMES, harvest_rows

#: On-disk format version: bumped on any schema change; ``load`` refuses
#: a mismatch rather than silently misinterpreting arrays.
FORMAT_VERSION = 1

#: Staleness guard: below this many harvested training rows (or fewer
#: than ``MIN_TRAIN_GROUPS`` candidate sets) the harvest cannot support
#: a trustworthy ranking and ``fit_ranker`` returns ``None`` — callers
#: degrade to rank-off.
MIN_TRAIN_ROWS = 64
MIN_TRAIN_GROUPS = 2

#: Default stated recall target of the calibrated keep-threshold.
DEFAULT_RECALL_TARGET = 0.95

#: Calibrated keep fractions are clipped here: never below 5% (a model
#: that aced the harvest must still keep a real top slice on unseen
#: groups), never above 1.0.
MIN_KEEP_FRAC = 0.05


@dataclasses.dataclass(frozen=True)
class LearnedModel:
    """A trained, calibrated candidate ranker (frozen; picklable — it
    ships to pool workers inside plan-phase task payloads)."""

    version: int
    feature_names: tuple[str, ...]
    ridge: RidgeModel
    n_train: int                 # harvested training rows
    n_groups: int                # harvested candidate sets
    recall_target: float         # stated target the calibration aimed at
    keep_frac: float             # calibrated top-fraction achieving it
    recall: float                # achieved harvest recall at keep_frac

    def score(self, X: np.ndarray) -> np.ndarray:
        """Predicted iteration time per feature row (lower is better —
        the rank stage keeps the smallest scores)."""
        return self.ridge.predict(X)

    @property
    def fingerprint(self) -> str:
        """Content hash — cache key for pruned views ranked by this
        exact model (weights + calibration)."""
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.ridge.beta).tobytes())
        h.update(np.ascontiguousarray(self.ridge.mean).tobytes())
        h.update(np.ascontiguousarray(self.ridge.std).tobytes())
        h.update(f"{self.version}|{self.keep_frac}|{self.n_train}".encode())
        return h.hexdigest()[:16]

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """Versioned single-file persistence (``np.savez``), written
        atomically so a crashed writer never leaves a torn model."""
        buf = io.BytesIO()
        np.savez(
            buf,
            version=np.int64(self.version),
            meta=np.frombuffer(json.dumps({
                "feature_names": list(self.feature_names),
                "n_train": self.n_train,
                "n_groups": self.n_groups,
                "recall_target": self.recall_target,
                "keep_frac": self.keep_frac,
                "recall": self.recall,
            }).encode(), dtype=np.uint8),
            mean=self.ridge.mean, std=self.ridge.std, beta=self.ridge.beta)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "LearnedModel":
        """Inverse of :meth:`save`; raises ``ValueError`` on a format
        version this code does not speak."""
        with np.load(path) as z:
            version = int(z["version"])
            if version != FORMAT_VERSION:
                raise ValueError(
                    f"learned-model format version {version} at {path!r}; "
                    f"this build reads version {FORMAT_VERSION}")
            meta = json.loads(bytes(z["meta"]).decode())
            ridge = RidgeModel(mean=z["mean"], std=z["std"], beta=z["beta"])
        return cls(version=version,
                   feature_names=tuple(meta["feature_names"]),
                   ridge=ridge, n_train=int(meta["n_train"]),
                   n_groups=int(meta["n_groups"]),
                   recall_target=float(meta["recall_target"]),
                   keep_frac=float(meta["keep_frac"]),
                   recall=float(meta["recall"]))


def _winner_rank_fracs(scores: np.ndarray, y: np.ndarray,
                       groups: list[slice]) -> np.ndarray:
    """Per harvested group: ``rank/n`` of the true argmin (first row of
    minimal target, the selection tie-break) in the model's score
    ordering — the fraction a keep-threshold must strictly exceed to
    capture the winner, because the rank stage keeps ``ceil(frac · n)``
    rows and ``ceil(frac · n) >= rank + 1  ⟺  frac > rank/n``.  A
    perfect model scores 0.0 in every group regardless of group size."""
    fracs = []
    for sl in groups:
        gy, gs = y[sl], scores[sl]
        n = len(gy)
        winner = int(np.argmin(gy))          # first minimum = tie-break row
        order = np.lexsort((np.arange(n), gs))
        rank = int(np.nonzero(order == winner)[0][0])
        fracs.append(rank / n)
    return np.asarray(fracs)


def fit_ranker(cache=None, *, recall_target: float = DEFAULT_RECALL_TARGET,
               lam: float = 1e-3, min_rows: int = MIN_TRAIN_ROWS,
               min_groups: int = MIN_TRAIN_GROUPS) -> LearnedModel | None:
    """Train + calibrate a :class:`LearnedModel` from the memo harvest.

    Returns ``None`` when the harvest fails the staleness guard (fewer
    than ``min_rows`` rows or ``min_groups`` groups) — the caller's
    signal to run rank-off rather than trust a model fit on noise.
    """
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(
            f"recall_target must be in (0, 1], got {recall_target}")
    X, y, groups = harvest_rows(cache)
    if len(X) < min_rows or len(groups) < min_groups:
        return None
    ridge = RidgeModel.fit(X, y, lam=lam)
    scores = ridge.predict(X)
    fracs = _winner_rank_fracs(scores, y, groups)
    # the recall_target quantile of winner-rank fractions, nudged to the
    # next float so the strict frac > rank/n capture condition holds at
    # the quantile row itself ("higher" interpolation keeps the
    # guarantee exact on the empirical distribution)
    keep_frac = float(np.nextafter(
        np.quantile(fracs, recall_target, method="higher"), 1.0))
    keep_frac = min(1.0, max(MIN_KEEP_FRAC, keep_frac))
    recall = float(np.mean(fracs < keep_frac))
    return LearnedModel(
        version=FORMAT_VERSION, feature_names=FEATURE_NAMES, ridge=ridge,
        n_train=int(len(X)), n_groups=len(groups),
        recall_target=recall_target, keep_frac=keep_frac, recall=recall)


def rank_keep_count(n: int, keep_frac: float) -> int:
    """Top-k size for a group of ``n`` survivors: ``ceil(frac * n)``,
    at least 1 so the model always nominates somebody."""
    return max(1, int(math.ceil(keep_frac * n)))
