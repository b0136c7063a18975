"""Per-kernel compute-utilization model u_c (paper §V.B.1, following
SCALE-sim-style empirical equations [73]).

On a systolic/MXU-style tile of ``tile_dim × tile_dim`` MACs, a GEMM of
(M, K, N) achieves utilization ≈ alignment efficiency of M and N against the
tile edge, with a pipeline-fill penalty when K is small. Non-GEMM kernels get
kind-specific ceilings (they are vector-unit / memory-bound in practice).
"""
from __future__ import annotations

from .graph import Kernel, KernelKind

TILE_DIM = 128  # MXU / systolic array edge


def _align_eff(d: int, tile: int = TILE_DIM) -> float:
    if d <= 0:
        return 1.0
    full = (d // tile) * tile
    rem = d - full
    padded = full + (tile if rem else 0)
    return d / padded


def gemm_utilization(m: int, k: int, n: int) -> float:
    eff = _align_eff(m) * _align_eff(n)
    fill = k / (k + TILE_DIM)  # pipeline fill/drain along the reduction dim
    return max(0.05, eff * fill)


_KIND_CEILING = {
    KernelKind.GEMM: 0.95,
    KernelKind.ATTENTION: 0.70,   # softmax interleave + masked work
    KernelKind.SOFTMAX: 0.15,
    KernelKind.NORM: 0.12,
    KernelKind.ELEMENTWISE: 0.10,
    KernelKind.EMBEDDING: 0.25,
    KernelKind.SCAN: 0.45,        # chunked SSD: GEMM-rich but stateful
    KernelKind.FFT: 0.50,
    KernelKind.COMM: 1.0,
    KernelKind.ROUTER: 0.10,
}


def kernel_utilization(kernel: Kernel) -> float:
    """u_c for one kernel (dimension-aware for GEMMs)."""
    ceil = _KIND_CEILING.get(kernel.kind, 0.5)
    if kernel.kind in (KernelKind.GEMM, KernelKind.ATTENTION) and kernel.gemm_dims:
        m, k, n = kernel.gemm_dims
        return max(0.05, min(ceil, gemm_utilization(m, k, n) * ceil / 0.95))
    return ceil


def kernel_utilizations(kernels) -> "np.ndarray":
    """Vectorized u_c over a kernel sequence — the form the plan phase's
    per-layer compute model consumes (one array op instead of a Python
    loop per candidate plan)."""
    import numpy as np

    return np.array([kernel_utilization(k) for k in kernels])
