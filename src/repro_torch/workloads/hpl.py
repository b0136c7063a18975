"""High-Performance LINPACK dataflow graph (paper §VI.C.3 — 5M² HPL).

Right-looking LU with partial pivoting: per block-column iteration —
panel factorization (tall-skinny, poorly parallel), panel broadcast,
triangular solve of the U row-block, trailing-matrix GEMM update (dominant,
2/3·N³ total). We model the steady-state iteration at 50% progress (trailing
matrix N/2 × N/2), which reproduces HPL's compute-bound character on every
system (paper Fig 14: "all system setups achieve high utilization").
"""
from __future__ import annotations

from ..core.graph import DataflowGraph, Kernel, KernelKind, Tensor
from ..core.interchip import TrainWorkload

BYTES = 8  # HPL is fp64


def hpl_iteration_graph(n: float = 5e6, nb: int = 512) -> DataflowGraph:
    m = n / 2  # steady-state trailing size
    ks = [
        Kernel("PanelLU", 2.0 * m * nb * nb, KernelKind.GEMM,
               gemm_dims=(int(m), nb, nb)),
        Kernel("PanelBcast", 0.0, KernelKind.COMM),
        Kernel("TRSM", 1.0 * nb * nb * m, KernelKind.GEMM,
               gemm_dims=(nb, nb, int(m))),
        Kernel("Update", 2.0 * m * nb * m, KernelKind.GEMM,
               gemm_dims=(int(m), nb, int(m))),
    ]
    ts = [
        Tensor("panel", "PanelLU", "PanelBcast", m * nb * BYTES),
        Tensor("panel_b", "PanelBcast", "TRSM", m * nb * BYTES),
        Tensor("urow", "TRSM", "Update", nb * m * BYTES),
    ]
    return DataflowGraph(ks, ts, f"hpl_n{int(n)}")


def hpl_workload(n: float = 5e6, nb: int = 512) -> TrainWorkload:
    g = hpl_iteration_graph(n, nb)
    return TrainWorkload(name="hpl_5m2", layer_graph=g,
                         n_layers=1, global_batch=1, microbatch=1,
                         bwd_flop_mult=0.0,        # no backward pass
                         optimizer_bytes_per_param_byte=0.0)
