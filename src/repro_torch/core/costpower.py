"""Cost & power models (paper §VI.C, Fig 9).

Fig 9 fits silicon power vs compute throughput with a superlinear polynomial
(Y = 3e-7·X² − 4.3e-4·X + 0.04 in the paper's axis units, which are not
stated). We re-fit the same quadratic *shape* to the paper's own Table V
chips so the superlinearity conclusion is reproducible in explicit units:

    P_watts(X_tflops) = 2.4e-4·X² + 0.5·X

    H100   993 TFLOPS → 734 W   (actual 700)
    TPUv4  275        → 156     (actual 192)
    SN30   614        → 397     (actual 350)
    WSE-2  7500       → 17.2 kW (actual ~15 kW + system)

Price follows the same trend (paper: "similar, not shown"); we scale the
quadratic so H100-class silicon lands at ~$30k.
"""
from __future__ import annotations

from ..systems.system import SystemSpec

_PA, _PB = 2.4e-4, 0.5           # power fit (W per TFLOPS², W per TFLOPS)
_CA, _CB = 1.2e-2, 20.0          # price fit (USD per TFLOPS², USD per TFLOPS)


def silicon_power_w(tflops: float) -> float:
    """Superlinear power fit (Fig 9 shape, Table-V calibration)."""
    return _PA * tflops ** 2 + _PB * tflops


def silicon_price_usd(tflops: float) -> float:
    return _CA * tflops ** 2 + _CB * tflops


def cost_efficiency(util: float, system: SystemSpec) -> float:
    """Achieved FLOP/s per USD of system price."""
    return util * system.peak_flops / system.price()


def power_efficiency(util: float, system: SystemSpec) -> float:
    """Achieved FLOP/s per watt of system power."""
    return util * system.peak_flops / system.power()


def system_efficiency_terms(system: SystemSpec) -> tuple[float, float, float]:
    """(peak FLOP/s, price USD, power W) for a system — the constants the
    plan phase folds into ``pricing.PlanVector`` so the batched price phase
    computes cost/power efficiency without SystemSpec objects in hand."""
    return system.peak_flops, system.price(), system.power()
