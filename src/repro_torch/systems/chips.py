"""Accelerator / memory / interconnect specifications (paper Table V + §VI.C).

All bandwidths are bytes/s, capacities bytes, throughputs FLOP/s.
Price in USD, power in watts. Price/power constants follow the paper's cited
sources; where the paper gives only relative statements we use public figures
and keep them in one place so DSE conclusions are reproducible.
"""
from __future__ import annotations

import dataclasses

GB = 1e9
MB = 1e6
TFLOPS = 1e12


@dataclasses.dataclass(frozen=True)
class MemorySpec:
    name: str
    bandwidth: float          # bytes/s per chip
    capacity: float           # bytes per chip
    price: float              # USD per chip's worth
    power: float              # W per chip's worth


@dataclasses.dataclass(frozen=True)
class InterconnectSpec:
    name: str
    bandwidth: float          # bytes/s per link (unidirectional)
    latency: float            # s per hop
    price_per_link: float     # USD
    power_per_link: float     # W


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A data-parallel accelerator chip (paper Fig 5 right).

    ``tiles × tile_flops`` is the peak FLOP/s; SRAM is the on-chip capacity
    that bounds intra-chip fusion (VMEM for TPUs). ``dataflow`` marks
    spatial-dataflow architectures (RDU/WSE) vs kernel-by-kernel (GPU/TPU) —
    the *default* execution model; DFModel can map dataflow execution onto
    either (the paper's Fig 19 sweep does exactly that).
    """

    name: str
    tiles: int                # t_lim
    tile_flops: float         # t_flop (FLOP/s per tile)
    sram_capacity: float      # s_cap bytes
    price: float              # USD (silicon only)
    power: float              # W (silicon only)
    dataflow: bool = False

    @property
    def peak_flops(self) -> float:
        return self.tiles * self.tile_flops


# --- paper Table V chips (half precision) -----------------------------------
H100 = ChipSpec("H100", tiles=132, tile_flops=993 * TFLOPS / 132,
                sram_capacity=113 * MB, price=30_000, power=700, dataflow=False)
TPU_V4 = ChipSpec("TPUv4", tiles=8, tile_flops=275 * TFLOPS / 8,
                  sram_capacity=160 * MB, price=12_000, power=192, dataflow=False)
SN30 = ChipSpec("SN30", tiles=1280, tile_flops=614 * TFLOPS / 1280,
                sram_capacity=640 * MB, price=25_000, power=350, dataflow=True)
WSE2 = ChipSpec("WSE2", tiles=850_000, tile_flops=7500 * TFLOPS / 850_000,
                sram_capacity=40 * GB, price=2_500_000, power=15_000, dataflow=True)

# §VII case-study chips
SN10 = ChipSpec("SN10", tiles=1024, tile_flops=307.2 * TFLOPS / 1024,
                sram_capacity=320 * MB, price=20_000, power=300, dataflow=True)
SN40L = ChipSpec("SN40L", tiles=1040, tile_flops=640 * TFLOPS / 1040,
                 sram_capacity=520 * MB, price=28_000, power=350, dataflow=True)

# our deployment target (roofline constants from the prompt):
# 197 bf16 TFLOP/s, 819 GB/s HBM, 50 GB/s/link ICI, 128 MiB VMEM.
TPU_V5E = ChipSpec("TPUv5e", tiles=4, tile_flops=197 * TFLOPS / 4,
                   sram_capacity=128 * 2**20, price=6_000, power=200,
                   dataflow=False)

A100 = ChipSpec("A100", tiles=108, tile_flops=312 * TFLOPS / 108,
                sram_capacity=40 * MB, price=15_000, power=400, dataflow=False)

CHIPS: dict[str, ChipSpec] = {c.name: c for c in
                              [H100, TPU_V4, SN30, WSE2, SN10, SN40L, TPU_V5E, A100]}

# --- memory technologies (paper §VI.C: DDR4 200GB/s, HBM3 3TB/s) ------------
DDR = MemorySpec("DDR", bandwidth=200 * GB, capacity=1536 * GB,
                 price=4_000, power=40)
HBM = MemorySpec("HBM", bandwidth=3000 * GB, capacity=96 * GB,
                 price=12_000, power=120)
# §VIII.C 3D memory sweep points
DDR_2D = MemorySpec("DDR2D", bandwidth=100 * GB, capacity=1536 * GB,
                    price=3_000, power=30)
HBM_25D = MemorySpec("HBM2.5D", bandwidth=1000 * GB, capacity=96 * GB,
                     price=10_000, power=100)
MEM_3D = MemorySpec("3D", bandwidth=100_000 * GB, capacity=64 * GB,
                    price=20_000, power=160)
HBM_V5E = MemorySpec("HBMv5e", bandwidth=819 * GB, capacity=16 * GB,
                     price=4_000, power=60)

MEMORIES: dict[str, MemorySpec] = {m.name: m for m in
                                   [DDR, HBM, DDR_2D, HBM_25D, MEM_3D, HBM_V5E]}

# --- interconnect technologies (paper §VI.C: PCIe4 25GB/s, NVLink4 900GB/s) --
PCIE = InterconnectSpec("PCIe", bandwidth=25 * GB, latency=500e-9,
                        price_per_link=100, power_per_link=5)
NVLINK = InterconnectSpec("NVLink", bandwidth=900 * GB, latency=150e-9,
                          price_per_link=2_000, power_per_link=30)
ICI = InterconnectSpec("ICI", bandwidth=50 * GB, latency=200e-9,
                       price_per_link=400, power_per_link=10)

INTERCONNECTS: dict[str, InterconnectSpec] = {i.name: i
                                              for i in [PCIE, NVLINK, ICI]}


# --- scaled variants ("H100@x1.25") ------------------------------------------
# Dense DSE grids (repro_torch.search.DenseGridSpec) interpolate between the
# paper's Table V technology points by scaling a registered spec's
# *performance* fields.  The variants are resolved by pure functions from
# the name alone — no registry mutation — so a grid cell naming
# "H100@x1.25" builds the same SystemSpec in every process regardless of
# pool start method (spawn workers re-import this module fresh).
#
# Scaling deliberately leaves price/power untouched: a ×1.25 chip at ×1.0
# cost is strictly better on cost efficiency, which is what creates
# genuine Pareto trade-offs across the scale axis instead of a uniform
# shift.
_SCALE_SEP = "@x"


def _split_scaled(name: str) -> tuple[str, float]:
    """``"H100@x1.25"`` → ``("H100", 1.25)``; plain names → scale 1.0."""
    base, sep, suffix = name.partition(_SCALE_SEP)
    if not sep:
        return name, 1.0
    try:
        scale = float(suffix)
    except ValueError:
        raise ValueError(f"bad scale suffix in spec name {name!r}") from None
    if not scale > 0.0:
        raise ValueError(f"scale must be positive in spec name {name!r}")
    return base, scale


def resolve_chip(name: str) -> ChipSpec:
    base, scale = _split_scaled(name)
    chip = CHIPS[base]
    if scale == 1.0:
        return chip
    return dataclasses.replace(chip, name=name,
                               tile_flops=chip.tile_flops * scale)


def resolve_memory(name: str) -> MemorySpec:
    base, scale = _split_scaled(name)
    mem = MEMORIES[base]
    if scale == 1.0:
        return mem
    return dataclasses.replace(mem, name=name,
                               bandwidth=mem.bandwidth * scale,
                               capacity=mem.capacity * scale)


def resolve_interconnect(name: str) -> InterconnectSpec:
    base, scale = _split_scaled(name)
    net = INTERCONNECTS[base]
    if scale == 1.0:
        return net
    return dataclasses.replace(net, name=name,
                               bandwidth=net.bandwidth * scale)
