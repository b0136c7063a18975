"""Full system specification = chips × memory × interconnect topology."""
from __future__ import annotations

import dataclasses

from .chips import ChipSpec, MemorySpec
from .topology import Topology


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """A homogeneous distributed system (paper Fig 5 left).

    ``topology.total_chips`` chips, each ``chip`` with off-chip ``memory``;
    dims of ``topology`` are assignable to parallelization strategies.
    """

    name: str
    chip: ChipSpec
    memory: MemorySpec
    topology: Topology

    @property
    def n_chips(self) -> int:
        return self.topology.total_chips

    @property
    def peak_flops(self) -> float:
        """Aggregate peak FLOP/s."""
        return self.n_chips * self.chip.peak_flops

    # --- price / power (paper §VI.C: silicon + memory + links) -------------
    def price(self) -> float:
        per_chip = (self.chip.price + self.memory.price
                    + self.topology.links_per_chip()
                    * max(d.link.price_per_link for d in self.topology.dims))
        return per_chip * self.n_chips

    def power(self) -> float:
        per_chip = (self.chip.power + self.memory.power
                    + self.topology.links_per_chip()
                    * max(d.link.power_per_link for d in self.topology.dims))
        return per_chip * self.n_chips
