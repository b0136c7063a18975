"""Learned cost model as a certified third pruning stage
(``repro_torch.learned``), the port's copy of the reference's numpy
rank stage.

The DSE pipeline's rank stage: a ridge regressor trained on ``(candidate
features → priced iteration time)`` pairs harvested from memo space
``"candmat"`` scores every dominance-survivor row, and the pipeline
prices only the model's calibrated top fraction union the rows no
pricing-free argument can exclude — winners provably identical to the
unranked pipeline and re-certified at runtime under the house
certify-or-die rule.

Public surface:

* :func:`~repro_torch.learned.model.fit_ranker` /
  :class:`~repro_torch.learned.model.LearnedModel` — training, quantile-
  calibrated keep-threshold (stated recall target), versioned
  ``save``/``load`` persistence, the harvest-size staleness guard.
* :func:`~repro_torch.learned.rank.rank_keep` /
  :func:`~repro_torch.learned.rank.bound_keep` — the winner-preserving
  keep rule applied inside
  :func:`repro_torch.core.interchip.prune_matrix`.
* :func:`~repro_torch.learned.rank.resolve_rank` — the ``rank=`` policy
  (``"auto"`` is off; no environment variable is read).
* :mod:`repro_torch.learned.features` — the feature schema
  (:data:`~repro_torch.learned.features.FEATURE_NAMES`) and the
  :func:`~repro_torch.learned.features.harvest_rows` training-set
  extraction.
"""
from .features import (DERIVED_FEATURE_NAMES, FEATURE_NAMES,
                       SYSTEM_FEATURE_NAMES, TOPOLOGY_VOCAB,
                       candidate_features, derived_features, harvest_rows,
                       system_features)
from .model import (DEFAULT_RECALL_TARGET, FORMAT_VERSION, MIN_TRAIN_GROUPS,
                    MIN_TRAIN_ROWS, LearnedModel, fit_ranker, rank_keep_count)
from .rank import RANK_MODES, bound_keep, rank_keep, resolve_rank

__all__ = [
    "DEFAULT_RECALL_TARGET",
    "DERIVED_FEATURE_NAMES",
    "FEATURE_NAMES",
    "FORMAT_VERSION",
    "LearnedModel",
    "MIN_TRAIN_GROUPS",
    "MIN_TRAIN_ROWS",
    "RANK_MODES",
    "SYSTEM_FEATURE_NAMES",
    "TOPOLOGY_VOCAB",
    "bound_keep",
    "candidate_features",
    "derived_features",
    "fit_ranker",
    "harvest_rows",
    "rank_keep",
    "rank_keep_count",
    "resolve_rank",
    "system_features",
]
