"""Dense design grids: scaled technology variants between Table V points.

The paper's §VI.C sweep covers 80 systems; the ROADMAP targets spaces
orders of magnitude denser.  :class:`DenseGridSpec` generates such a
space by interpolating each registered technology along a performance
scale axis — ``"H100@x1.25"`` is an H100 with 1.25× the per-tile
compute at unchanged price/power, resolved by the pure name parsers in
:mod:`repro_torch.systems.chips` (no registry mutation, so a grid cell means
the same system in every pool worker under any start method).

Scaling compute/bandwidth while holding price and power fixed keeps the
scale axis *interesting*: a faster variant is better on utilization AND
cost efficiency, so the Pareto surface shifts instead of merely
stretching, and the search policies have real structure to exploit.

The default shape is 12 chips × 24 memory/interconnect combinations ×
3 topologies = 864 cells — the ≥ 10×-the-paper grid the budgeted
search policies are certified on.  :meth:`DenseGridSpec.dense` scales the same generator to the
10⁵-cell regime by densifying the memory-scale lattice (memory variants
share their group's plan phase, so cells along that axis are nearly
free), and ``workload_scales`` multiplies the space once more through
workload variants (:func:`ScaledWorkFn`) for the 10⁶-cell
``DSEEngine.reprice_grid`` regime.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.dse_engine import SweepSpec
from ..core.interchip import TrainWorkload
from ..systems.chips import _split_scaled


def scaled_name(base: str, scale: float) -> str:
    """Canonical scaled-variant name (``scale == 1`` keeps the base name)."""
    if scale == 1.0:
        return base
    name = f"{base}@x{scale:g}"
    _split_scaled(name)  # validate base/scale round-trip early
    return name


def scale_lattice(lo: float, hi: float, n: int) -> tuple[float, ...]:
    """``n`` evenly spaced scale factors in [lo, hi], rounded to 6
    decimals so every factor formats to a distinct ``@x%g`` name."""
    if n < 1:
        raise ValueError(f"lattice size must be >= 1, got {n}")
    if not (0.0 < lo <= hi):
        raise ValueError(f"need 0 < lo <= hi, got [{lo}, {hi}]")
    if n == 1:
        return (round(lo, 6),)
    step = (hi - lo) / (n - 1)
    out = tuple(round(lo + i * step, 6) for i in range(n))
    # distinctness must hold through the ``@x%g`` name format, not just
    # the float values — names are the identity a grid cell travels as
    if len({f"{v:g}" for v in out}) != n:
        raise ValueError(
            f"lattice [{lo}, {hi}] × {n} collapses at name resolution; "
            f"widen the range or shrink the lattice")
    return out


@dataclasses.dataclass(frozen=True)
class ScaledWorkFn:
    """A workload factory scaled along the global-batch axis.

    Wraps a base ``work_fn`` so the scaled variant stays picklable (pool
    workers under spawn/forkserver ship the factory itself — a lambda
    would break them). The scaled batch is rounded to a whole multiple
    of the microbatch (minimum one), and the workload name is suffixed
    ``@b<scale>`` so grid rows from different variants stay
    distinguishable.
    """

    work_fn: object                   # Callable[[SystemSpec], TrainWorkload]
    scale: float = 1.0

    def __call__(self, system) -> TrainWorkload:
        work = self.work_fn(system)
        if self.scale == 1.0:
            return work
        mb = max(1, int(work.microbatch))
        batch = mb * max(1, round(work.global_batch * self.scale / mb))
        return dataclasses.replace(
            work, global_batch=batch, name=f"{work.name}@b{self.scale:g}")


@dataclasses.dataclass(frozen=True)
class DenseGridSpec:
    """Cartesian generator of scaled-variant design grids.

    ``spec()`` materializes the grid as a plain
    :class:`~repro_torch.core.dse_engine.SweepSpec`, so every engine entry
    point (``sweep`` / ``sweep_iter`` / ``search`` / ``reprice_grid``)
    consumes it unchanged.
    """

    n_chips: int = 64
    base_chips: tuple[str, ...] = ("H100", "TPUv4", "SN30")
    chip_scales: tuple[float, ...] = (0.75, 1.0, 1.25, 1.5)
    base_memories: tuple[str, ...] = ("DDR", "HBM")
    memory_scales: tuple[float, ...] = (0.75, 1.0, 1.25)
    base_nets: tuple[str, ...] = ("PCIe", "NVLink")
    net_scales: tuple[float, ...] = (1.0, 1.5)
    topologies: tuple[str, ...] = ("torus2d", "dragonfly", "dgx2")
    max_tp: int | None = 16
    max_pp: int | None = None
    execution: str = "auto"
    #: Workload-axis variants (global-batch scale factors): the grid is
    #: swept once per variant (:meth:`work_variants`), multiplying the
    #: total cell count without touching the system axes.
    workload_scales: tuple[float, ...] = (1.0,)

    def chips(self) -> tuple[str, ...]:
        return tuple(scaled_name(c, s) for c in self.base_chips
                     for s in self.chip_scales)

    def mem_net(self) -> tuple[tuple[str, str], ...]:
        return tuple((scaled_name(m, ms), scaled_name(n, ns))
                     for m in self.base_memories for ms in self.memory_scales
                     for n in self.base_nets for ns in self.net_scales)

    def n_cells(self) -> int:
        """System-grid cells of ONE workload variant."""
        return (len(self.base_chips) * len(self.chip_scales)
                * len(self.base_memories) * len(self.memory_scales)
                * len(self.base_nets) * len(self.net_scales)
                * len(self.topologies))

    def n_total_cells(self) -> int:
        """Total cells across every workload variant — the number a
        whole-space :meth:`~repro_torch.core.dse_engine.DSEEngine.reprice_grid`
        pass over :meth:`work_variants` covers."""
        return self.n_cells() * len(self.workload_scales)

    def work_variants(self, work_fn) -> tuple[ScaledWorkFn, ...]:
        """One picklable scaled workload factory per ``workload_scales``
        entry (scale 1 included as-is, wrapped for uniformity)."""
        return tuple(ScaledWorkFn(work_fn, s) for s in self.workload_scales)

    def spec(self) -> SweepSpec:
        return SweepSpec(n_chips=self.n_chips, chips=self.chips(),
                         topologies=self.topologies,
                         mem_net=self.mem_net(), max_tp=self.max_tp,
                         max_pp=self.max_pp, execution=self.execution)

    @classmethod
    def dense(cls, target_cells: int = 100_000,
              workload_scales: tuple[float, ...] = (1.0,),
              **overrides) -> "DenseGridSpec":
        """A grid with ≥ ``target_cells`` system cells (per workload
        variant), densified along the memory-scale axis.

        The memory axis is the cheap direction: every memory variant of a
        (chip, net, topology) group shares the group's plan phase, so a
        100× denser memory lattice costs ~100× more *pricing rows* but no
        extra discrete solves — exactly the shape the chunked compiled
        backend is built for. ``workload_scales`` multiplies the space
        once more (``n_total_cells``) for the 10⁶-cell regime.
        """
        base = cls(workload_scales=tuple(workload_scales), **overrides)
        per_scale = base.n_cells() // len(base.memory_scales)
        need = max(1, math.ceil(target_cells / per_scale))
        return dataclasses.replace(
            base, memory_scales=scale_lattice(0.5, 2.0, need))
