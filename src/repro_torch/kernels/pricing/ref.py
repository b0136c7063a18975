"""Plain PyTorch version of the pricing kernel, and the ``torch`` backend.

Both run the shared formulas of :mod:`repro_torch.core.pricing`
(``_price``, ``_roofline``) on tensors through :class:`TorchXP`, an ``xp``
namespace with numpy's ``maximum`` / ``minimum`` / ``where`` semantics, so
the formula text exists once. Every eager op is one correctly rounded IEEE
operation, so in float64 the result is bit-identical to the numpy backend.

The oracle of the kernel's certification is
:func:`repro_torch.core.pricing.price_plan_scalar`, the literal float64
transcription of the serial sweep's arithmetic, over the seeded inputs of
:func:`repro_torch.core.pricing.random_plan_vectors`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from ...core.pricing import (FIELDS, PlanVector, _price, _roofline,
                             price_plan_scalar, random_plan_vectors)

__all__ = ["FORMULAS", "TorchXP", "edge_plan_vectors", "price_rows_scalar",
           "pricing_ref", "random_plan_vectors", "random_roofline_columns",
           "torch_columns"]

#: Input columns of the roofline formula, in the kernel's column order.
ROOFLINE_FIELDS = ("hlo_flops", "hlo_bytes", "collective_bytes", "chips",
                   "model_flops", "peak_flops", "hbm_bw", "link_bw")

#: Output columns of each formula, in the kernel's row order.
PRICE_OUT = ("utilization", "cost_eff", "power_eff", "frac_compute",
             "frac_memory", "frac_network", "iter_time", "util_inter",
             "per_chip_mem_bytes", "feasible")
ROOFLINE_OUT = ("t_compute", "t_memory", "t_collective", "t_bound",
                "roofline_fraction", "useful_flop_ratio")

#: The kernel's entries: name -> (formula, input columns, output columns,
#: bool outputs). The kernel reads input column ``c`` of row ``i`` at
#: ``c * n + i`` and writes output column ``k`` at ``k * n + i``.
FORMULAS = {
    "price": (_price, FIELDS, PRICE_OUT, ("feasible",)),
    "roofline": (_roofline, ROOFLINE_FIELDS, ROOFLINE_OUT, ()),
}


class TorchXP:
    """The formulas' ``xp`` over tensors, with numpy's rules.

    ``np.maximum(a, b)`` is ``a if (a > b or isnan(a)) else b``: NaN
    propagates, and of two zeros the second operand wins, so
    ``maximum(0.0, -0.0)`` is ``-0.0``. ``torch.maximum`` returns ``0.0``
    there and rejects Python numbers, so both are written out with
    ``torch.where``. ``minimum`` is the same with ``<``. The formulas'
    Python constants are never NaN.
    """

    @staticmethod
    def maximum(a, b):
        take_a = a > b
        if isinstance(a, torch.Tensor):
            take_a = take_a | torch.isnan(a)
        return torch.where(take_a, a, b)

    @staticmethod
    def minimum(a, b):
        take_a = a < b
        if isinstance(a, torch.Tensor):
            take_a = take_a | torch.isnan(a)
        return torch.where(take_a, a, b)

    @staticmethod
    def where(cond, x, y):
        return torch.where(cond, x, y)


def torch_columns(formula, cols: Mapping[str, np.ndarray],
                  device: torch.device) -> dict[str, np.ndarray]:
    """The ``torch`` backend: ``formula`` eagerly on float64 tensors on
    ``device``; numpy columns in, numpy columns out."""
    tcols = {k: torch.as_tensor(np.asarray(c, dtype=np.float64)).to(device)
             for k, c in cols.items()}
    return {k: v.cpu().numpy() for k, v in formula(TorchXP, tcols).items()}


def pricing_ref(x: torch.Tensor, entry: str, f32: bool = False
                ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``x`` is the ``(n_in, n)``
    float64 column stack of entry ``entry`` (``"price"`` or
    ``"roofline"``); returns the ``(n_out, n)`` output stack, float64, or
    float32 with ``f32`` (the inputs rounded to float32 first, as the f32
    kernel does in registers). Bool outputs are 0.0 / 1.0."""
    formula, names, outs, _ = FORMULAS[entry]
    dtype = torch.float32 if f32 else torch.float64
    cols = {name: x[c].to(dtype) for c, name in enumerate(names)}
    out = formula(TorchXP, cols)
    return torch.stack([out[name].to(dtype) for name in outs])


def price_rows_scalar(vectors) -> list[dict[str, float]]:
    """Oracle rows for a batch (one scalar-reference dict per vector)."""
    return [price_plan_scalar(v) for v in vectors]


def random_roofline_columns(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded roofline input columns (:data:`ROOFLINE_FIELDS`), with the
    formula's zero branches (no FLOPs, no bytes, no collective traffic)
    drawn at random."""
    rng = np.random.default_rng(seed)

    def maybe_zero(col: np.ndarray) -> np.ndarray:
        return np.where(rng.random(n) < 0.15, 0.0, col)

    return {
        "hlo_flops": maybe_zero(rng.uniform(1e9, 1e18, n)),
        "hlo_bytes": maybe_zero(rng.uniform(1e6, 1e14, n)),
        "collective_bytes": maybe_zero(rng.uniform(1e3, 1e12, n)),
        "chips": 2.0 ** rng.integers(0, 11, n),
        "model_flops": rng.uniform(1e9, 1e18, n),
        "peak_flops": rng.uniform(1e13, 1e16, n),
        "hbm_bw": rng.uniform(1e10, 5e12, n),
        "link_bw": rng.uniform(1e9, 1e12, n),
    }


def edge_plan_vectors() -> tuple[list[PlanVector], list[PlanVector]]:
    """Hand-made rows on the formula's edges, as ``(finite, special)``.

    ``finite``: no DP exposure with an inference-only multiplier
    (``t_dp = 0``, ``bwd_flop_mult = 0``), an all-zero intra pass
    (``total == 0``), and an intra pass with ``t_fwd == 0`` (derate off);
    the scalar reference prices these too. ``special``: NaN and ±inf in a
    column, and signed zeros (``t_dp = -0.0``, an intra pass of ``-0.0``),
    where numpy's ``maximum`` and the scalar ``max`` part ways — held
    against the numpy formula only."""
    base = random_plan_vectors(1, seed=7)[0]

    def row(**kw) -> PlanVector:
        return dataclasses.replace(base, **kw)

    inf, nan = math.inf, math.nan
    finite = [
        row(t_dp=0.0, bwd_flop_mult=0.0),
        row(intra_comp=0.0, intra_mem=0.0, intra_net=0.0, intra_total=0.0),
        row(t_comp_stage=0.0, t_net_stage=0.0, t_p2p=0.0, t_dp=0.25,
            intra_total=0.5),
    ]
    special = [
        row(t_net_stage=nan),
        row(weight_bytes=inf),
        row(t_p2p=-inf),
        row(intra_comp=inf),
        row(mem_capacity=nan, intra_total=nan),
        row(t_dp=-0.0, bwd_flop_mult=0.0, t_net_stage=-0.0,
            intra_comp=-0.0, intra_mem=-0.0, intra_net=-0.0,
            intra_total=-0.0),
    ]
    return finite, special
