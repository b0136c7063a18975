from .chips import (ChipSpec, MemorySpec, InterconnectSpec, CHIPS, MEMORIES,
                    INTERCONNECTS, TPU_V5E)
from .topology import (TopologyDim, Topology, ring, fully_connected, switch,
                       torus2d, torus3d, dgx1, dgx2, dragonfly, TOPOLOGIES,
                       make_topology)
from .system import SystemSpec

__all__ = [
    "ChipSpec", "MemorySpec", "InterconnectSpec", "CHIPS", "MEMORIES",
    "INTERCONNECTS", "TPU_V5E", "TopologyDim", "Topology", "ring",
    "fully_connected", "switch", "torus2d", "torus3d", "dgx1", "dgx2",
    "dragonfly", "TOPOLOGIES", "make_topology", "SystemSpec",
]
