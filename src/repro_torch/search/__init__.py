"""Budgeted search policies over DSE design grids
(``repro_torch.search``), the port's copy of the reference's numpy layer.

Public surface:

* :class:`~repro_torch.search.policy.SearchPolicy` — the ask/tell
  interface :meth:`repro_torch.core.dse_engine.DSEEngine.search` drives,
  plus the three shipped policies:
  :class:`~repro_torch.search.policy.RandomSearch`,
  :class:`~repro_torch.search.policy.SuccessiveHalving` (cheap
  selection-bound rung → full-pricing promotion) and
  :class:`~repro_torch.search.surrogate.SurrogateSearch` (ridge on system
  features, refit + re-rank each round).
* :class:`~repro_torch.search.grid.DenseGridSpec` — scaled-variant grids
  far denser than the paper's 80 systems, the input of
  :meth:`~repro_torch.core.dse_engine.DSEEngine.reprice_grid` too.
* :func:`~repro_torch.search.surrogate.plan_feature_rows` /
  :func:`~repro_torch.search.surrogate.fit_plan_ridge` — the memo-store
  harvest feeding plan-level surrogates; :mod:`repro_torch.learned`
  builds the learned rank stage on the same harvest.
"""
from .grid import DenseGridSpec, ScaledWorkFn, scale_lattice, scaled_name
from .policy import (POLICY_NAMES, Observation, RandomSearch, SearchContext,
                     SearchPolicy, SearchResult, SuccessiveHalving,
                     make_policy)
from .surrogate import (PLAN_FEATURE_FIELDS, RidgeModel, SurrogateSearch,
                        cell_features, fit_plan_ridge, plan_feature_rows)

__all__ = [
    "DenseGridSpec",
    "Observation",
    "POLICY_NAMES",
    "make_policy",
    "ScaledWorkFn",
    "scale_lattice",
    "PLAN_FEATURE_FIELDS",
    "RandomSearch",
    "RidgeModel",
    "SearchContext",
    "SearchPolicy",
    "SearchResult",
    "SuccessiveHalving",
    "SurrogateSearch",
    "cell_features",
    "fit_plan_ridge",
    "plan_feature_rows",
    "scaled_name",
]
