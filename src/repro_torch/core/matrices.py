"""Assignment matrices A, B, D, L, H — paper §III.B Eqs. (1)-(4).

The Gurobi MIP in the paper centers on the boolean assignment matrix
``A ∈ B^{n×p}`` (kernel → partition, one-hot rows) and matrices derived from it:

  B[j,:] = A[src,:] ∧ A[dst,:]                      (intra-partition tensors, Eq. 1)
  D[j,:] = A[src,:] ⊕ A[dst,:]                      (cross-partition tensors, Eq. 2)
  L[j,:] = (A[src]U_s ⊕ A[dst]U_t) ⊕ (A[src] ∧ A[dst])   (tensor lifetime, Eq. 3)
  H[j,:] = A[src,:]                                 (source partition, Eq. 4)

We implement them vectorized in numpy; the solver evaluates candidate
assignments through these exact formulas, and the property tests assert the
identities the paper relies on (e.g. row(B)+row(D) partitions tensors, L covers
the open-closed interval between producer and consumer partitions).
"""
from __future__ import annotations

import numpy as np

from .graph import DataflowGraph


def assignment_matrix(assign: np.ndarray, p_max: int) -> np.ndarray:
    """One-hot encode a kernel→partition vector into A ∈ B^{n×p_max}."""
    assign = np.asarray(assign, dtype=np.int64)
    if assign.ndim != 1:
        raise ValueError("assign must be 1-D")
    if (assign < 0).any() or (assign >= p_max).any():
        raise ValueError("partition index out of range")
    A = np.zeros((assign.shape[0], p_max), dtype=bool)
    A[np.arange(assign.shape[0]), assign] = True
    return A


def _edge_endpoints(graph: DataflowGraph) -> tuple[np.ndarray, np.ndarray]:
    src = np.array([graph.kernel_index(t.src) for t in graph.tensors], dtype=np.int64)
    dst = np.array([graph.kernel_index(t.dst) for t in graph.tensors], dtype=np.int64)
    return src, dst


def matrix_B(graph: DataflowGraph, A: np.ndarray) -> np.ndarray:
    """Eq. 1: tensors whose producer and consumer share a partition."""
    src, dst = _edge_endpoints(graph)
    return A[src] & A[dst]


def matrix_D(graph: DataflowGraph, A: np.ndarray) -> np.ndarray:
    """Eq. 2: XOR — marks the two endpoints of cross-partition tensors."""
    src, dst = _edge_endpoints(graph)
    return A[src] ^ A[dst]


def matrix_H(graph: DataflowGraph, A: np.ndarray) -> np.ndarray:
    """Eq. 4: tensor placed where its producer lives."""
    src, _ = _edge_endpoints(graph)
    return A[src]


def upper_triangular_masks(p_max: int) -> tuple[np.ndarray, np.ndarray]:
    """U_s[i,j] = i <= j and U_t[i,j] = i < j (paper's auxiliary constants)."""
    idx = np.arange(p_max)
    U_s = idx[:, None] <= idx[None, :]
    U_t = idx[:, None] < idx[None, :]
    return U_s, U_t


def matrix_L(graph: DataflowGraph, A: np.ndarray) -> np.ndarray:
    """Eq. 3: lifetime indicator of cross-partition tensors.

    ``A[src]U_s`` is ones from the producer partition onward (inclusive),
    ``A[dst]U_t`` is ones strictly after the consumer partition; the XOR selects
    the interval [src_partition, dst_partition], and subtracting the
    intra-partition case (A[src] ∧ A[dst]) zeroes same-partition tensors.
    For backward edges (consumer scheduled before producer — possible only for
    inter-chip cyclic schedules, which our builders do not emit) the formula
    still yields a symmetric interval.
    """
    p_max = A.shape[1]
    src, dst = _edge_endpoints(graph)
    U_s, U_t = upper_triangular_masks(p_max)
    from_src = (A[src].astype(np.int64) @ U_s.astype(np.int64)) > 0
    from_dst = (A[dst].astype(np.int64) @ U_t.astype(np.int64)) > 0
    same = A[src] & A[dst]
    return (from_src ^ from_dst) ^ same


def validate_assignment(graph: DataflowGraph, A: np.ndarray) -> None:
    """Check the MIP's hard constraints: one-hot rows, precedence feasibility."""
    if A.dtype != bool:
        raise ValueError("A must be boolean")
    if A.shape[0] != graph.n:
        raise ValueError("A has wrong number of rows")
    if not (A.sum(axis=1) == 1).all():
        raise ValueError("A rows must be one-hot (A·1 = 1)")
    part = A.argmax(axis=1)
    for t in graph.tensors:
        if part[graph.kernel_index(t.src)] > part[graph.kernel_index(t.dst)]:
            raise ValueError(
                f"precedence violated: {t.src}(p{part[graph.kernel_index(t.src)]}) -> "
                f"{t.dst}(p{part[graph.kernel_index(t.dst)]})")


def partition_summaries(graph: DataflowGraph, assign: np.ndarray, p_max: int):
    """Per-partition aggregates used by both optimization passes.

    Returns dict with:
      flops[p]        Σ kernel flops in partition p            (Aᵀ f)
      sram_bytes[p]   Σ intra-partition tensor bytes           (Bᵀ b)
      dram_xfer[p]    Σ cross-partition tensor bytes touching p (Dᵀ b)
      dram_live[p]    Σ bytes of tensors live in p             (Lᵀ b)
      weight_bytes[p] Σ kernel weight bytes in p               (Aᵀ w)
    """
    A = assignment_matrix(assign, p_max)
    f = np.array([k.flops for k in graph.kernels])
    w = np.array([k.weight_bytes for k in graph.kernels])
    b = np.array([t.bytes_ for t in graph.tensors])
    B = matrix_B(graph, A)
    D = matrix_D(graph, A)
    L = matrix_L(graph, A)
    return {
        "A": A,
        "flops": A.astype(np.float64).T @ f,
        "weight_bytes": A.astype(np.float64).T @ w,
        "sram_bytes": B.astype(np.float64).T @ b,
        "dram_xfer": D.astype(np.float64).T @ b,
        "dram_live": L.astype(np.float64).T @ b,
    }
