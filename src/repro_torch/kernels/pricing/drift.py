"""The drift-budget contract: certified winner selection over f32 pricing.

The f32 instantiation of the pricing kernel (the ``kernel-f32`` backend)
trades the repo's bit-identity invariant for speed; this module is what buys the invariant
back at the only place it matters — *decisions*. The contract:

* A declared relative tolerance band δ (the ``band`` argument, validated
  by :func:`drift_band`, default ``1e-5``): every f32 output is promised
  to sit within relative δ of its f64 reference value. The promise is
  enforced, not assumed — every candidate the banded selection re-prices
  yields an (f32, f64) pair, and observed drift beyond δ raises
  :class:`DriftBandError` (the certify-or-die house rule, extended to
  approximate arithmetic).
* :func:`banded_winner_rows` reproduces the serial reference scan —
  first row minimizing the lexicographic (infeasible, iter_time) key —
  *exactly*, using f32 columns for the cheap mass of candidates and
  exact f64 re-pricing (the numpy reference arithmetic, bit-identical to
  ``price_plan_scalar``) only where f32 cannot be trusted:

  1. **Feasibility is resolved exactly first.** With drift ≤ δ, a row
     with f32 mem ≤ cap·(1−δ) is certainly feasible and one with
     f32 mem > cap·(1+δ) certainly infeasible; everything between is
     re-priced exactly. This must happen *before* the pool minimum is
     taken — an optimistic superset minimum from a truly-infeasible row
     could shrink the re-pricing threshold below the true winner.
  2. **The band around the f32 argmin.** Over the now-exact feasible
     pool, every row whose f32 iter-time ≤ min·(1+δ)/(1−δ) provably
     contains every row that could be the f64 argmin (f64 ∈
     [f32/(1+δ), f32/(1−δ)] for every in-band row); those rows are
     re-priced exactly and the winner is the first-index f64 argmin —
     the same tie semantics as ``np.argmin`` / the serial scan.
  3. **Empty pool fallback.** When no row is feasible the reference
     semantics pick the global iter-time argmin; the same band logic
     runs over all rows.

``certify_banded_rows`` wraps the selection with the winner-identity
check against a reference row list — the engine's per-group
certification on the ``kernel-f32`` backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np

from ...core.pricing import DRIFT_BAND, _selection


class DriftBandError(RuntimeError):
    """Observed f32 drift exceeded the declared band — the compiled
    backend broke its numerics contract and no selection it contributed
    to can be trusted."""


def drift_band(band: float = DRIFT_BAND) -> float:
    """The declared relative drift band ``band`` as a float, validated: it
    must parse as a float in (0, 0.5); anything else raises."""
    try:
        band = float(band)
    except (TypeError, ValueError):
        raise ValueError(
            f"invalid drift band {band!r}; expected a float relative "
            f"tolerance, e.g. 1e-5") from None
    if not (0.0 < band < 0.5) or not math.isfinite(band):
        raise ValueError(f"the drift band must lie in (0, 0.5), got {band!r}")
    return band


@dataclasses.dataclass
class BandedSelection:
    """One banded selection over f32-priced candidates.

    ``rows`` index the priced arrays (local indexing — remap through a
    survivor map yourself when the arrays cover pruned rows);
    ``winner_iter``/``winner_mem`` are the winners' EXACT f64 values
    (every winner is by construction in the re-priced set), so
    downstream feasibility flags never touch f32."""

    rows: list[int]
    winner_iter: list[float]
    winner_mem: list[float]
    repriced: np.ndarray          # unique row indices exactly re-priced
    stats: dict                   # band / rows / caps / repriced /
                                  # ambiguous_mem / band_hits /
                                  # fallback_caps / max_iter_drift /
                                  # max_mem_drift


def _exact_iter_mem(cols: Mapping[str, np.ndarray], rows: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Exact f64 (iter_time, per_chip_mem_bytes) for a row subset — the
    numpy reference arithmetic (``pricing._selection``, whose two columns
    are copied op-for-op from ``_price`` and certified bit-identical to
    the scalar reference)."""
    sub = {k: np.asarray(c, dtype=np.float64)[rows]
           for k, c in cols.items()}
    out = _selection(np, sub)
    return (np.asarray(out["iter_time"], dtype=np.float64),
            np.asarray(out["per_chip_mem_bytes"], dtype=np.float64))


def banded_winner_rows(cols: Mapping[str, np.ndarray],
                       f32: Mapping[str, np.ndarray],
                       capacities: Sequence[float],
                       band: float = DRIFT_BAND) -> BandedSelection:
    """The drift-banded batched argmin: per capacity, the row the f64
    serial scan would pick, computed from f32 columns + exact re-pricing
    of the ambiguous slivers (see the module docstring for the
    soundness argument).

    ``cols`` are the candidates' INPUT columns (``PlanMatrix.cols`` — the
    exact re-pricing source); ``f32`` the compiled kernel's priced
    columns (``iter_time``, ``per_chip_mem_bytes``). Raises
    :class:`DriftBandError` when any re-priced row's observed drift
    exceeds the declared band.
    """
    delta = drift_band(band)
    it32 = np.asarray(f32["iter_time"], dtype=np.float64)
    mem32 = np.asarray(f32["per_chip_mem_bytes"], dtype=np.float64)
    n = int(it32.shape[0])
    stats = {"band": delta, "rows": n, "caps": len(capacities),
             "repriced": 0, "ambiguous_mem": 0, "band_hits": 0,
             "fallback_caps": 0, "max_iter_drift": 0.0,
             "max_mem_drift": 0.0}
    if n == 0:
        return BandedSelection([-1] * len(capacities), [], [],
                               np.empty(0, dtype=np.int64), stats)

    exact_it = np.empty(n, dtype=np.float64)
    exact_mem = np.empty(n, dtype=np.float64)
    have = np.zeros(n, dtype=bool)

    def ensure_exact(mask: np.ndarray) -> None:
        rows = np.flatnonzero(mask & ~have)
        if rows.size:
            exact_it[rows], exact_mem[rows] = _exact_iter_mem(cols, rows)
            have[rows] = True

    rows_out: list[int] = []
    winner_iter: list[float] = []
    winner_mem: list[float] = []
    for cap in capacities:
        cap = float(cap)
        definite = mem32 <= cap * (1.0 - delta)
        ambiguous = ~definite & (mem32 <= cap * (1.0 + delta))
        stats["ambiguous_mem"] += int(ambiguous.sum())
        # (1) exact feasibility first — the pool must be the true f64
        # feasible set before its minimum can bound the winner
        ensure_exact(ambiguous)
        pool = definite | (ambiguous & have & (exact_mem <= cap))
        if not pool.any():
            # reference semantics: no feasible row → global iter argmin
            pool = np.ones(n, dtype=bool)
            stats["fallback_caps"] += 1
        pool_rows = np.flatnonzero(pool)
        # (2) the band around the f32 pool minimum provably contains
        # every possible f64 argmin
        m32 = float(it32[pool_rows].min())
        thresh = m32 * (1.0 + delta) / (1.0 - delta)
        cand = pool_rows[it32[pool_rows] <= thresh]
        stats["band_hits"] += int(cand.size)
        cand_mask = np.zeros(n, dtype=bool)
        cand_mask[cand] = True
        ensure_exact(cand_mask)
        # (3) first-index f64 argmin — cand is ascending, np.argmin
        # returns the first minimum, so ties resolve exactly like the
        # serial scan
        w = int(cand[np.argmin(exact_it[cand])])
        rows_out.append(w)
        winner_iter.append(float(exact_it[w]))
        winner_mem.append(float(exact_mem[w]))

    repriced = np.flatnonzero(have)
    stats["repriced"] = int(repriced.size)
    if repriced.size:
        it_den = np.where(exact_it[repriced] != 0.0,
                          np.abs(exact_it[repriced]), 1.0)
        mem_den = np.where(exact_mem[repriced] != 0.0,
                           np.abs(exact_mem[repriced]), 1.0)
        it_drift = float(np.max(
            np.abs(it32[repriced] - exact_it[repriced]) / it_den))
        mem_drift = float(np.max(
            np.abs(mem32[repriced] - exact_mem[repriced]) / mem_den))
        stats["max_iter_drift"] = it_drift
        stats["max_mem_drift"] = mem_drift
        # in-production partial certification: every re-priced row is an
        # (f32, f64) pair — drift beyond the declared band voids every
        # bound above, so die rather than return a selection
        if it_drift > delta or mem_drift > delta:
            raise DriftBandError(
                f"compiled f32 pricing drifted beyond the declared band "
                f"{delta:g} (observed iter drift {it_drift:.3e}, mem "
                f"drift {mem_drift:.3e} over {repriced.size} re-priced "
                f"rows); the drift-budget contract is void")
    return BandedSelection(rows_out, winner_iter, winner_mem, repriced,
                           stats)


def certify_banded_rows(cols: Mapping[str, np.ndarray],
                        f32: Mapping[str, np.ndarray],
                        capacities: Sequence[float],
                        expected: Sequence[int], backend: str,
                        survivors: np.ndarray | Sequence[int] | None = None,
                        band: float = DRIFT_BAND) -> BandedSelection:
    """Certify-or-die for the compiled backend: the banded selection over
    ``f32`` must reproduce the reference winner rows exactly. ``expected``
    is in original-enumeration indexing; when the priced arrays cover
    only pruned ``survivors`` the banded rows are remapped through the
    survivor index map before comparing. Returns the selection (winners'
    exact values + drift stats) on success."""
    sel = banded_winner_rows(cols, f32, capacities, band=band)
    rows = sel.rows
    if survivors is not None:
        smap = np.asarray(survivors, dtype=np.int64)
        rows = [int(smap[r]) if r >= 0 else -1 for r in rows]
    if list(rows) != list(expected):
        raise RuntimeError(
            f"pricing backend {backend!r} selected different candidates "
            f"than the numpy reference under the drift-banded contract "
            f"({rows} != {list(expected)}); the band does not preserve "
            f"winners")
    return sel
