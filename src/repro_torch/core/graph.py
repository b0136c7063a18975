"""Dataflow graph IR — the workload representation of DFModel (paper §III.B).

Vertices are compute kernels (FLOP counts + kind + sharding metadata); edges are
tensors (byte sizes). The graph is a DAG; tensors have a single producer and a
single consumer (paper §IV.C) — multi-consumer tensors are replicated by the
builders in ``repro_torch.workloads``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Sequence


class KernelKind(enum.Enum):
    """Coarse kernel taxonomy used by the utilization + sharding models."""

    GEMM = "gemm"                # dense matmul (QKV, Proj, FFN, MLP, LU-update)
    ATTENTION = "attention"      # score/softmax/AV fused region
    SOFTMAX = "softmax"
    NORM = "norm"                # layernorm / rmsnorm
    ELEMENTWISE = "elementwise"  # add, mul, activation
    EMBEDDING = "embedding"      # gather from a (possibly huge) table
    SCAN = "scan"                # recurrence (SSM / Mamba chunk scan)
    FFT = "fft"
    COMM = "comm"                # explicit communication kernel (e.g. DLRM a2a)
    ROUTER = "router"            # MoE top-k routing


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A compute vertex.

    ``flops``       total FLOP for one logical execution (unsharded).
    ``weight_bytes``parameter bytes resident for this kernel (unsharded).
    ``kind``        drives the utilization model u_c and sharding scheme set.
    ``gemm_dims``   optional (M, K, N) for GEMM-like kernels — used by the
                    sharding model to derive collective sizes (paper Fig 4).
    """

    name: str
    flops: float
    kind: KernelKind = KernelKind.GEMM
    weight_bytes: float = 0.0
    gemm_dims: tuple[int, int, int] | None = None

    def __post_init__(self) -> None:
        if self.flops < 0 or self.weight_bytes < 0:
            raise ValueError(f"kernel {self.name}: negative flops/bytes")


@dataclasses.dataclass(frozen=True)
class Tensor:
    """A directed edge ``src -> dst`` carrying ``bytes_`` bytes (unsharded)."""

    name: str
    src: str
    dst: str
    bytes_: float

    def __post_init__(self) -> None:
        if self.bytes_ < 0:
            raise ValueError(f"tensor {self.name}: negative bytes")


class DataflowGraph:
    """A DAG of kernels and tensors with a cached topological order."""

    def __init__(self, kernels: Sequence[Kernel], tensors: Sequence[Tensor],
                 name: str = "graph") -> None:
        self.name = name
        self.kernels: list[Kernel] = list(kernels)
        self.tensors: list[Tensor] = list(tensors)
        self._index = {k.name: i for i, k in enumerate(self.kernels)}
        if len(self._index) != len(self.kernels):
            raise ValueError("duplicate kernel names")
        for t in self.tensors:
            if t.src not in self._index or t.dst not in self._index:
                raise ValueError(f"tensor {t.name}: unknown endpoint {t.src}->{t.dst}")
            if t.src == t.dst:
                raise ValueError(f"tensor {t.name}: self-loop")
        self._topo = self._toposort()  # raises on cycles
        self._fingerprint: str | None = None

    # -- structure ---------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.kernels)

    @property
    def m(self) -> int:
        return len(self.tensors)

    def kernel_index(self, name: str) -> int:
        return self._index[name]

    def kernel(self, name: str) -> Kernel:
        return self.kernels[self._index[name]]

    def successors(self, name: str) -> list[str]:
        return [t.dst for t in self.tensors if t.src == name]

    def predecessors(self, name: str) -> list[str]:
        return [t.src for t in self.tensors if t.dst == name]

    def in_tensors(self, name: str) -> list[Tensor]:
        return [t for t in self.tensors if t.dst == name]

    def out_tensors(self, name: str) -> list[Tensor]:
        return [t for t in self.tensors if t.src == name]

    def _toposort(self) -> list[int]:
        indeg = [0] * self.n
        adj: list[list[int]] = [[] for _ in range(self.n)]
        for t in self.tensors:
            s, d = self._index[t.src], self._index[t.dst]
            adj[s].append(d)
            indeg[d] += 1
        queue = sorted(i for i in range(self.n) if indeg[i] == 0)
        order: list[int] = []
        import heapq

        heap = list(queue)
        heapq.heapify(heap)
        while heap:
            i = heapq.heappop(heap)
            order.append(i)
            for j in adj[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    heapq.heappush(heap, j)
        if len(order) != self.n:
            raise ValueError("dataflow graph has a cycle")
        return order

    @property
    def topo_order(self) -> list[int]:
        """Kernel indices in (deterministic, lexicographic-tiebreak) topo order."""
        return list(self._topo)

    def topo_names(self) -> list[str]:
        return [self.kernels[i].name for i in self._topo]

    def fingerprint(self) -> str:
        """Structural content digest (kernels + tensors, order-sensitive).

        Two graphs with equal fingerprints are byte-for-byte the same
        workload, so solver results computed on one are valid for the other.
        This is the graph identity used by the ``repro_torch.core.memo`` cache keys
        — unlike ``id()``, it survives rebuilding the graph object, which the
        DSE sweep does once per design point.
        """
        if self._fingerprint is None:
            import hashlib

            h = hashlib.blake2b(digest_size=16)
            for k in self.kernels:
                h.update(repr((k.name, k.flops, k.kind.value, k.weight_bytes,
                               k.gemm_dims)).encode())
            for t in self.tensors:
                h.update(repr((t.name, t.src, t.dst, t.bytes_)).encode())
            self._fingerprint = h.hexdigest()
        return self._fingerprint

    # -- aggregate quantities ------------------------------------------------
    def total_flops(self) -> float:
        return sum(k.flops for k in self.kernels)

    def total_weight_bytes(self) -> float:
        return sum(k.weight_bytes for k in self.kernels)

    def total_tensor_bytes(self) -> float:
        return sum(t.bytes_ for t in self.tensors)

    # -- transforms ----------------------------------------------------------
    def scaled(self, flop_scale: float = 1.0, bytes_scale: float = 1.0,
               name: str | None = None) -> "DataflowGraph":
        """A copy with FLOPs and tensor/weight bytes scaled (e.g. per-shard)."""
        ks = [dataclasses.replace(k, flops=k.flops * flop_scale,
                                  weight_bytes=k.weight_bytes * bytes_scale)
              for k in self.kernels]
        ts = [dataclasses.replace(t, bytes_=t.bytes_ * bytes_scale)
              for t in self.tensors]
        return DataflowGraph(ks, ts, name or self.name)

    def __repr__(self) -> str:
        return (f"DataflowGraph({self.name!r}, n={self.n}, m={self.m}, "
                f"flops={self.total_flops():.3e})")


def chain_graph(kernels: Sequence[Kernel],
                tensor_bytes: Iterable[float],
                name: str = "chain") -> DataflowGraph:
    """Convenience: a linear chain k0 -> k1 -> ... with the given edge sizes."""
    kernels = list(kernels)
    sizes = list(tensor_bytes)
    if len(sizes) != len(kernels) - 1:
        raise ValueError("need exactly n-1 edge sizes for a chain")
    tensors = [Tensor(f"t{i}", kernels[i].name, kernels[i + 1].name, b)
               for i, b in enumerate(sizes)]
    return DataflowGraph(kernels, tensors, name)
