"""Roofline analysis — two flavors.

1. The paper's hierarchical roofline (Fig 18): an execution point has two
   operational intensities (FLOP/byte vs DRAM and vs network) and its achieved
   throughput is the min of the compute roof and the two bandwidth roofs.

2. The deliverable's dry-run roofline: given dry-run FLOPs / bytes /
   collective bytes of a step (in the port, the op counts of
   ``repro_torch.validation.opcount``), derive the three time terms

      compute    = HLO_FLOPs / (chips × peak)
      memory     = HLO_bytes / (chips × HBM_bw)
      collective = collective_bytes / (chips × link_bw)

   against the TPU v5e constants (197 bf16 TFLOP/s, 819 GB/s, 50 GB/s/link).
"""
from __future__ import annotations

import dataclasses

GB = 1e9
TFLOPS = 1e12

# TPU v5e hardware constants (per chip) — prompt-specified
V5E_PEAK_FLOPS = 197 * TFLOPS
V5E_HBM_BW = 819 * GB
V5E_ICI_BW = 50 * GB   # per link; we price aggregate collective bytes per chip


@dataclasses.dataclass(frozen=True)
class HierPoint:
    """A point on the hierarchical roofline plot (paper Fig 18)."""

    name: str
    flops: float            # useful FLOPs of the mapping (per microbatch)
    dram_bytes: float       # DRAM traffic (per microbatch)
    net_bytes: float        # network traffic (per microbatch)
    peak_flops: float
    dram_bw: float
    net_bw: float

    @property
    def oi_mem(self) -> float:
        return self.flops / self.dram_bytes if self.dram_bytes else float("inf")

    @property
    def oi_net(self) -> float:
        return self.flops / self.net_bytes if self.net_bytes else float("inf")

    @property
    def achieved_flops(self) -> float:
        roofs = [self.peak_flops]
        if self.dram_bytes:
            roofs.append(self.oi_mem * self.dram_bw)
        if self.net_bytes:
            roofs.append(self.oi_net * self.net_bw)
        return min(roofs)

    @property
    def bound(self) -> str:
        a = self.achieved_flops
        if self.dram_bytes and abs(a - self.oi_mem * self.dram_bw) < 1e-6 * a:
            return "memory"
        if self.net_bytes and abs(a - self.oi_net * self.net_bw) < 1e-6 * a:
            return "network"
        return "compute"


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Three-term dry-run roofline for an (arch × shape × mesh) cell."""

    name: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float                  # 6·N·D (dense) / 6·N_active·D (MoE)
    peak_flops: float = V5E_PEAK_FLOPS
    hbm_bw: float = V5E_HBM_BW
    link_bw: float = V5E_ICI_BW

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.link_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs — catches remat / redundant compute."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roof attained if the dominant term were the
        only cost: model_flops / (t_bound · chips · peak)."""
        denom = self.t_bound * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "cell": self.name, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def stack_terms(terms: "list[RooflineTerms] | tuple[RooflineTerms, ...]"
                ) -> dict:
    """Stack RooflineTerms into the float64 columns consumed by
    ``repro_torch.core.pricing.batched_roofline`` (one array op prices every
    (arch × shape × mesh) cell instead of a property call per cell)."""
    import numpy as np

    cols = ("hlo_flops", "hlo_bytes", "collective_bytes", "chips",
            "model_flops", "peak_flops", "hbm_bw", "link_bw")
    return {c: np.array([getattr(t, c) for t in terms], dtype=np.float64)
            for c in cols}
