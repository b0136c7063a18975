"""Feature schema of the learned rank stage.

One candidate row is featurized as the concatenation of

* its :data:`~repro_torch.search.surrogate.PLAN_FEATURE_FIELDS` columns — the
  inputs of the ``pricing._price`` iteration-time expression (stage
  times, pipeline shape, backward multipliers), taken straight from the
  candidate :class:`~repro_torch.core.pricing.PlanMatrix`;
* a **derived basis** (:data:`DERIVED_FEATURE_NAMES`) motivated by the
  shape of the paper's Eq. 7 pricing expression ``iter_time = (n_micro
  + pp - 1) · (t_fwd + t_bwd) + exposed_dp`` — a product-of-maxes form
  no linear map of the raw columns can rank.  The basis therefore
  carries the expression's two *components* (the pipeline term
  ``t_pipe`` and the exposed-DP term ``t_exposed``) plus log-scaled
  parts for cross-group calibration.  The basis gives the model the
  shape of the cost; the ridge still learns the weights (on this
  reproduction's pricing model they converge near the true Eq. 7
  combination — by design: a cost model that cannot recover the cost it
  was harvested from would be a poor one), and nothing downstream
  trusts them: the rank stage stays winner-preserving by construction
  even under an adversarially wrong model; and
* a per-group **system block** shared by every row of the group:
  log-scaled chip magnitudes + chip-count (the same resolvers and
  scaling :func:`repro_torch.search.surrogate.cell_features` uses) and a
  topology-family one-hot over :data:`repro_torch.systems.topology.TOPOLOGIES`.

The system block deliberately excludes the memory and network specs:
training pairs are harvested from memo space ``"candmat"`` whose keys
carry (work, chip, n_chips, topology) but not the memory variant — and
the network's effect on iteration time is already present in the
harvested ``t_net_stage`` / ``t_p2p`` / ``t_dp`` stage-time features.
Within one group the system block is constant, so it never reorders
rows of a single group; across groups it lets one model calibrate
predictions for systems it has not planned yet.
"""
from __future__ import annotations

import math
from typing import Any, Iterable

import numpy as np

from ..search.surrogate import PLAN_FEATURE_FIELDS
from ..systems.chips import ChipSpec
from ..systems.topology import TOPOLOGIES

#: Topology-family vocabulary of the one-hot block, frozen in sorted
#: order so feature indices are stable across processes and sessions.
TOPOLOGY_VOCAB: tuple[str, ...] = tuple(sorted(TOPOLOGIES))

#: Names of the per-group system-feature block, in column order.
SYSTEM_FEATURE_NAMES: tuple[str, ...] = (
    "log_peak_flops", "log_sram_capacity", "dataflow", "log_n_chips",
) + tuple(f"topo_{name}" for name in TOPOLOGY_VOCAB)

#: Eq. 7-shaped derived columns (module docstring), in column order.
DERIVED_FEATURE_NAMES: tuple[str, ...] = (
    "t_pipe",            # (n_micro + pp - 1) · (t_fwd + t_bwd)
    "t_exposed",         # max(0, t_dp - n_micro · t_comp·bfm · 0.5)
    "log_t_pipe",        # log10(t_pipe)
    "log_t_fwd",         # log10(max(t_comp, t_net, t_p2p))
    "log_t_bwd",         # log10(max(t_comp·bfm, t_net·bfm·bcm, t_p2p))
    "log_span",          # log10(n_micro + pp - 1)
    "log_t_dp",          # log10(t_dp)
    "log_dp_overlap",    # log10(n_micro · t_comp·bfm · 0.5)
)

#: Full feature-vector schema: plan columns, derived basis, system block.
FEATURE_NAMES: tuple[str, ...] = (PLAN_FEATURE_FIELDS
                                  + DERIVED_FEATURE_NAMES
                                  + SYSTEM_FEATURE_NAMES)

#: Floor inside the log features — keeps zero stage times finite without
#: disturbing the ordering of realistic (≫ 1e-30 s) times.
_LOG_FLOOR = 1e-30


def derived_features(cols: dict[str, Any] | Any) -> np.ndarray:
    """The ``(n_rows, len(DERIVED_FEATURE_NAMES))`` log-basis block for
    one candidate matrix ``cols`` mapping (see module docstring)."""
    def col(name: str) -> np.ndarray:
        return np.asarray(cols[name], dtype=np.float64)

    def log10(x: np.ndarray) -> np.ndarray:
        return np.log10(np.maximum(x, _LOG_FLOOR))

    t_comp, t_net, t_p2p = col("t_comp_stage"), col("t_net_stage"), \
        col("t_p2p")
    bfm, bcm = col("bwd_flop_mult"), col("bwd_comm_mult")
    t_fwd = np.maximum(np.maximum(t_comp, t_net), t_p2p)
    t_bwd = np.maximum(np.maximum(t_comp * bfm, t_net * (bfm * bcm)), t_p2p)
    span = col("n_micro") + col("pp") - 1.0
    overlap = col("n_micro") * (t_comp * bfm) * 0.5
    t_pipe = span * (t_fwd + t_bwd)
    t_exposed = np.maximum(0.0, col("t_dp") - overlap)
    return np.stack([
        t_pipe,
        t_exposed,
        log10(t_pipe),
        log10(t_fwd),
        log10(t_bwd),
        log10(span),
        log10(col("t_dp")),
        log10(overlap),
    ], axis=1)


def topology_family(topology_name: str) -> str | None:
    """Map a concrete topology name (``"torus2d_4x4"``, ``"fc16"``) back
    to its :data:`TOPOLOGY_VOCAB` family — the longest vocabulary entry
    prefixing it — or ``None`` for a family the vocabulary predates."""
    best = None
    for fam in TOPOLOGY_VOCAB:
        if topology_name.startswith(fam):
            if best is None or len(fam) > len(best):
                best = fam
    return best


def system_features(chip: ChipSpec, n_chips: int,
                    topology_name: str) -> np.ndarray:
    """The per-group system block (see module docstring).  An unknown
    topology family degrades to an all-zero one-hot rather than raising:
    the rank stage is winner-preserving regardless of feature quality,
    so a new family must not break planning."""
    base = [math.log10(chip.peak_flops),
            math.log10(chip.sram_capacity),
            float(chip.dataflow),
            math.log10(max(n_chips, 1))]
    onehot = [0.0] * len(TOPOLOGY_VOCAB)
    fam = topology_family(topology_name)
    if fam is not None:
        onehot[TOPOLOGY_VOCAB.index(fam)] = 1.0
    return np.asarray(base + onehot, dtype=np.float64)


def candidate_features(cols: dict[str, Any] | Any,
                       system: np.ndarray) -> np.ndarray:
    """Stack the full ``(n_rows, len(FEATURE_NAMES))`` feature matrix for
    one candidate group: :data:`PLAN_FEATURE_FIELDS` columns out of the
    matrix ``cols`` mapping, the :func:`derived_features` log basis, and
    the broadcast ``system`` block."""
    plan = np.stack([np.asarray(cols[f], dtype=np.float64)
                     for f in PLAN_FEATURE_FIELDS], axis=1)
    derived = derived_features(cols)
    sys_block = np.broadcast_to(np.asarray(system, dtype=np.float64),
                                (plan.shape[0], len(system)))
    return np.concatenate([plan, derived, sys_block], axis=1)


def harvest_rows(cache=None) -> tuple[np.ndarray, np.ndarray, list[slice]]:
    """Training-set extraction: ``(features, iter_time, groups)``.

    Walks memo space ``"candmat"`` via
    :meth:`repro_torch.core.memo.SolveCache.harvest` — the local tier first,
    then shared-store entries other workers of the sweep computed — and
    emits one training row per *enumerated* candidate: its feature
    vector (above) against the exact ``selection_columns`` iteration
    time the dominance filter already computes.  The target is *linear*
    iteration time: Eq. 7 is linear in the derived component features,
    so linear space is where the ridge can actually recover it (a log
    target would re-introduce the ``log(a + b)`` nonlinearity the basis
    exists to remove).  ``groups`` holds one row-slice per harvested
    candidate set, so calibration can ask "where did this group's true
    argmin land in the model's ranking?".
    """
    from ..core.memo import GLOBAL_CACHE

    cache = GLOBAL_CACHE if cache is None else cache
    xs: list[np.ndarray] = []
    ys: list[np.ndarray] = []
    groups: list[slice] = []
    start = 0
    for key, cands in cache.harvest("candmat"):
        n = len(cands)
        if not n or not _candmat_key_ok(key):
            continue
        _work, chip, n_chips, topology = key[0], key[1], key[2], key[3]
        sysvec = system_features(chip, int(n_chips), topology.name)
        xs.append(candidate_features(cands.matrix.cols, sysvec))
        sel = cands.selection()
        ys.append(np.asarray(sel["iter_time"], dtype=np.float64))
        groups.append(slice(start, start + n))
        start += n
    if not xs:
        return (np.zeros((0, len(FEATURE_NAMES))), np.zeros(0), [])
    return np.concatenate(xs), np.concatenate(ys), groups


def _candmat_key_ok(key: Iterable) -> bool:
    """A ``"candmat"`` key this module can featurize: the structural key
    ``candidate_matrix`` writes — ``(work, chip, n_chips, topology, …)``
    with a :class:`ChipSpec` chip and a named topology.  Foreign entries
    (version skew through a shared store) are skipped, not raised."""
    try:
        return (isinstance(key, tuple) and len(key) >= 4
                and isinstance(key[1], ChipSpec)
                and isinstance(key[3].name, str))
    except AttributeError:
        return False
