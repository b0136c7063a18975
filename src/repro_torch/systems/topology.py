"""Interconnection topologies + collective communication cost models.

Paper §IV.C: a multi-dimensional topology is a hierarchical composition of
1-D topologies (ring / fully-connected / switch), following ASTRA-sim [71];
each network dimension is assigned to exactly one parallelization strategy.

Collective latencies use the bandwidth-term formulas from Thakur et al. [77]
(MPICH collectives) and BlueConnect [19] multi-dim decomposition:

  ring     all-gather / reduce-scatter: (p-1)/p · n / bw
           all-reduce: 2(p-1)/p · n / bw
           all-to-all: each chip exchanges n/p with p-1 peers over ring links →
                        (p-1)/p · n / bw (store-and-forward, bidirectional links)
  fully-connected (one direct link per peer, per-link bandwidth bw):
           all-gather: each chip sends its n/p shard on p-1 links in parallel →
                        n / (p · bw)
           all-reduce: reduce-scatter + all-gather = 2n / (p · bw)
           all-to-all: each pair exchanges n/p directly → n / (p · bw)
  switch   (non-blocking, bw per chip port): bandwidth-optimal algorithms →
           same as ring bandwidth terms (halving-doubling): all-reduce
           2(p-1)/p·n/bw; all-to-all limited by port: (p-1)/p · n / bw

Latency (alpha) terms use hops × link latency; they matter only for tiny
messages (decode serving) and are included additively.

All sizes n are *total* collective payload bytes (e.g. full gradient size for
an all-reduce); bw is per-link bytes/s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Sequence

from .chips import InterconnectSpec

DimKind = Literal["ring", "fc", "switch"]


@dataclasses.dataclass(frozen=True)
class TopologyDim:
    """One 1-D dimension of a composed topology."""

    size: int                    # chips along this dimension
    kind: DimKind
    link: InterconnectSpec

    # -- per-collective bandwidth+latency cost (seconds) ---------------------
    def _alpha(self, steps: int) -> float:
        return steps * self.link.latency

    def all_gather(self, n: float) -> float:
        p, bw = self.size, self.link.bandwidth
        if p == 1:
            return 0.0
        if self.kind == "fc":
            return n / (p * bw) + self._alpha(1)
        return (p - 1) / p * n / bw + self._alpha(p - 1)

    def reduce_scatter(self, n: float) -> float:
        return self.all_gather(n)  # bandwidth-symmetric

    def all_reduce(self, n: float) -> float:
        p = self.size
        if p == 1:
            return 0.0
        return self.reduce_scatter(n) + self.all_gather(n)

    def all_to_all(self, n: float) -> float:
        """n is the *global* tensor size; each chip holds n/p and exchanges
        (p-1)/p of its shard.

        ring:   pairwise byte·hops = n·(p-1)/p · mean_dist(p/4), balanced over
                2p directed links → n·(p-1)/(8p·bw)
        fc:     each pair exchanges n/p² on its own link → n/(p²·bw)
        switch: port-limited: each chip injects n/p·(p-1)/p → n(p-1)/(p²·bw)
        """
        p, bw = self.size, self.link.bandwidth
        if p == 1:
            return 0.0
        if self.kind == "fc":
            return n / (p * p * bw) + self._alpha(1)
        if self.kind == "switch":
            return n * (p - 1) / (p * p * bw) + self._alpha(1)
        return n * (p - 1) / (8 * p * bw) + self._alpha(p // 2)

    def broadcast(self, n: float) -> float:
        p, bw = self.size, self.link.bandwidth
        if p == 1:
            return 0.0
        if self.kind == "fc":
            return n / bw / (p - 1) + self._alpha(1)  # scatter+allgather pipelined
        return n / bw + self._alpha(p - 1)            # pipelined ring broadcast

    def p2p(self, n: float) -> float:
        return n / self.link.bandwidth + self._alpha(1)

    # links owned per chip along this dim (for price/power)
    @property
    def links_per_chip(self) -> float:
        if self.size == 1:
            return 0.0
        if self.kind == "ring":
            return 2.0
        if self.kind == "fc":
            return float(self.size - 1)
        return 1.0  # switch port


@dataclasses.dataclass(frozen=True)
class Topology:
    """A hierarchical composition of 1-D dims (innermost first)."""

    name: str
    dims: tuple[TopologyDim, ...]

    @property
    def total_chips(self) -> int:
        out = 1
        for d in self.dims:
            out *= d.size
        return out

    def links_per_chip(self) -> float:
        return sum(d.links_per_chip for d in self.dims)

    # BlueConnect-style multi-dim collective over a *subset* of dims:
    # run the per-dim collective sequentially; for all-reduce, reduce-scatter
    # inward then all-gather outward so later dims operate on shrunken shards.
    def all_reduce(self, n: float, dim_idx: Sequence[int]) -> float:
        t, shard = 0.0, n
        dims = [self.dims[i] for i in dim_idx]
        for d in dims:                       # reduce-scatter inward
            t += d.reduce_scatter(shard)
            shard /= d.size
        for d in reversed(dims):             # all-gather outward
            t += d.all_gather(shard * d.size)
            shard *= d.size
        return t

    def all_gather(self, n: float, dim_idx: Sequence[int]) -> float:
        t = 0.0
        shard = n / math.prod(self.dims[i].size for i in dim_idx)
        for i in dim_idx:
            d = self.dims[i]
            shard *= d.size
            t += d.all_gather(shard)
        return t

    def reduce_scatter(self, n: float, dim_idx: Sequence[int]) -> float:
        t, shard = 0.0, n
        for i in dim_idx:
            d = self.dims[i]
            t += d.reduce_scatter(shard)
            shard /= d.size
        return t

    def all_to_all(self, n: float, dim_idx: Sequence[int]) -> float:
        return sum(self.dims[i].all_to_all(n) for i in dim_idx)

    def broadcast(self, n: float, dim_idx: Sequence[int]) -> float:
        return sum(self.dims[i].broadcast(n) for i in dim_idx)

    def p2p(self, n: float, dim_idx: Sequence[int]) -> float:
        # point-to-point between neighbors along the first listed dim
        if not dim_idx:
            return 0.0
        return self.dims[dim_idx[0]].p2p(n)


# --- the paper's five topology families (§VI.C), parameterized by chip count -
def ring(p: int, link: InterconnectSpec) -> Topology:
    return Topology(f"ring{p}", (TopologyDim(p, "ring", link),))


def fully_connected(p: int, link: InterconnectSpec) -> Topology:
    return Topology(f"fc{p}", (TopologyDim(p, "fc", link),))


def switch(p: int, link: InterconnectSpec) -> Topology:
    return Topology(f"switch{p}", (TopologyDim(p, "switch", link),))


def _near_square(p: int) -> tuple[int, int]:
    a = int(math.isqrt(p))
    while p % a:
        a -= 1
    return a, p // a


def torus2d(p: int, link: InterconnectSpec) -> Topology:
    a, b = _near_square(p)
    return Topology(f"torus2d_{a}x{b}",
                    (TopologyDim(a, "ring", link), TopologyDim(b, "ring", link)))


def torus3d(p: int, link: InterconnectSpec) -> Topology:
    a = round(p ** (1 / 3))
    while p % a:
        a -= 1
    b, c = _near_square(p // a)
    return Topology(f"torus3d_{a}x{b}x{c}",
                    (TopologyDim(a, "ring", link), TopologyDim(b, "ring", link),
                     TopologyDim(c, "ring", link)))


def dgx1(p: int, link: InterconnectSpec, scale_out: InterconnectSpec | None = None) -> Topology:
    """8-chip NVLink hybrid-mesh node (modeled fc8), switch scale-out."""
    nodes = max(p // 8, 1)
    return Topology(f"dgx1_{nodes}x8",
                    (TopologyDim(min(p, 8), "fc", link),
                     TopologyDim(nodes, "switch", scale_out or link)))


def dgx2(p: int, link: InterconnectSpec, scale_out: InterconnectSpec | None = None) -> Topology:
    """16-chip NVSwitch node, switch scale-out."""
    nodes = max(p // 16, 1)
    return Topology(f"dgx2_{nodes}x16",
                    (TopologyDim(min(p, 16), "switch", link),
                     TopologyDim(nodes, "switch", scale_out or link)))


def dragonfly(p: int, link: InterconnectSpec) -> Topology:
    """Dragonfly [47]: fully-connected groups, fully-connected global links."""
    g = int(math.isqrt(p))
    while p % g:
        g -= 1
    return Topology(f"dragonfly_{g}x{p // g}",
                    (TopologyDim(g, "fc", link), TopologyDim(p // g, "fc", link)))


TOPOLOGIES = {
    "ring": ring,
    "torus2d": torus2d,
    "torus3d": torus3d,
    "dgx1": dgx1,
    "dgx2": dgx2,
    "dragonfly": dragonfly,
    "switch": switch,
    "fc": fully_connected,
}


def make_topology(kind: str, p: int, link: InterconnectSpec) -> Topology:
    return TOPOLOGIES[kind](p, link)
