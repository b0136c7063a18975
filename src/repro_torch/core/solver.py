"""Optimization engines replacing Gurobi (paper §III.A).

Two problem shapes recur in DFModel:

1. **min-max contiguous partition** (inter-chip PP stages, Eq. 7 objective):
   split a topologically ordered sequence of items into exactly ``p``
   contiguous groups minimizing the max group cost. Exact interval DP.

2. **min-sum contiguous partition with capacity** (intra-chip fusion, §V
   objective): split into at most ``p_max`` groups minimizing Σ group cost
   subject to per-group feasibility (SRAM). Exact interval DP.

3. **exact branch & bound over the assignment matrix A** for small graphs —
   searches the same space as the paper's MIP (one-hot rows + precedence) and
   certifies the DP answers optimal in tests. The DP restricts partitions to
   contiguous intervals of the topological order; B&B does not, so agreement
   between the two on non-trivial DAGs is evidence the restriction is lossless
   for the pipeline-ordered semantics DFModel uses.
"""
from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np

from .graph import DataflowGraph
from .matrices import assignment_matrix, matrix_B, matrix_D, matrix_L


def minmax_partition(costs: Sequence[float], p: int,
                     extra: Callable[[int, int], float] | None = None
                     ) -> tuple[list[int], float]:
    """Split ``costs`` into exactly ``p`` contiguous groups minimizing the max
    group total (+ optional ``extra(i, j)`` per group [i, j)).

    Returns (boundaries, objective) where boundaries are group start indices
    (length p, first is 0). O(n²·p).
    """
    n = len(costs)
    if p > n:
        p = n
    pref = np.concatenate([[0.0], np.cumsum(costs)])

    INF = float("inf")
    dp = np.full((p + 1, n + 1), INF)
    arg = np.full((p + 1, n + 1), -1, dtype=np.int64)
    dp[0, 0] = 0.0
    if extra is None:
        # vectorized inner minimization (hot path: PP sweeps call this for
        # hundreds of (tp, pp, dp) candidates over ~100-layer sequences)
        for k in range(1, p + 1):
            prev = dp[k - 1]
            for j in range(k, n + 1):
                lo = k - 1
                cand = np.maximum(prev[lo:j], pref[j] - pref[lo:j])
                i = int(np.argmin(cand))
                dp[k, j] = cand[i]
                arg[k, j] = lo + i
    else:
        # vectorized like the ``extra is None`` path: materialize the extra
        # term once as a dense (i, j) table — O(n²) callback invocations
        # instead of the O(n²·p) of the scalar reference — then run the same
        # numpy inner minimization. Arithmetic order matches the scalar
        # implementation exactly ((pref[j] - pref[i]) + extra), so results
        # are bit-identical (``minmax_partition_scalar`` certifies this in
        # tests/test_solver.py).
        E = np.zeros((n + 1, n + 1))
        for j in range(1, n + 1):
            for i in range(j):
                E[i, j] = extra(i, j)
        for k in range(1, p + 1):
            prev = dp[k - 1]
            for j in range(k, n + 1):
                lo = k - 1
                cand = np.maximum(prev[lo:j],
                                  (pref[j] - pref[lo:j]) + E[lo:j, j])
                i = int(np.argmin(cand))
                dp[k, j] = cand[i]
                arg[k, j] = lo + i
    bounds = []
    j = n
    for k in range(p, 0, -1):
        i = int(arg[k, j])
        bounds.append(i)
        j = i
    bounds.reverse()
    return bounds, float(dp[p, n])


def minmax_partition_scalar(costs: Sequence[float], p: int,
                            extra: Callable[[int, int], float] | None = None
                            ) -> tuple[list[int], float]:
    """Pure-Python reference implementation of :func:`minmax_partition`.

    Kept as the agreement oracle for the vectorized paths (property tests
    assert bit-identical boundaries and objectives); never used on hot paths.
    """
    n = len(costs)
    if p > n:
        p = n
    pref = np.concatenate([[0.0], np.cumsum(costs)])
    INF = float("inf")
    dp = np.full((p + 1, n + 1), INF)
    arg = np.full((p + 1, n + 1), -1, dtype=np.int64)
    dp[0, 0] = 0.0

    def group(i: int, j: int) -> float:
        g = pref[j] - pref[i]
        return g + extra(i, j) if extra is not None else g

    for k in range(1, p + 1):
        for j in range(k, n + 1):
            for i in range(k - 1, j):
                c = max(dp[k - 1, i], group(i, j))
                if c < dp[k, j]:
                    dp[k, j] = c
                    arg[k, j] = i
    bounds: list[int] = []
    j = n
    for k in range(p, 0, -1):
        i = int(arg[k, j])
        bounds.append(i)
        j = i
    bounds.reverse()
    return bounds, float(dp[p, n])


def minsum_partition(n: int, p_max: int,
                     group_cost: Callable[[int, int], float],
                     feasible: Callable[[int, int], bool]
                     ) -> tuple[list[int], float]:
    """Split [0, n) into ≤ ``p_max`` contiguous groups minimizing
    Σ group_cost(i, j) s.t. feasible(i, j) per group. O(n²·p_max).

    Returns (boundaries, objective); raises if no feasible split exists.
    """
    INF = float("inf")
    dp = np.full((p_max + 1, n + 1), INF)
    arg = np.full((p_max + 1, n + 1), -1, dtype=np.int64)
    dp[0, 0] = 0.0
    # memoize costs since group_cost may be expensive
    cost_cache: dict[tuple[int, int], float] = {}

    def gc(i: int, j: int) -> float:
        key = (i, j)
        if key not in cost_cache:
            cost_cache[key] = group_cost(i, j) if feasible(i, j) else INF
        return cost_cache[key]

    for k in range(1, p_max + 1):
        for j in range(1, n + 1):
            best = dp[k - 1, j] if k > 1 else INF  # allow fewer groups
            besti = arg[k - 1, j] if k > 1 else -2
            for i in range(j):
                if dp[k - 1, i] == INF:
                    continue
                c = dp[k - 1, i] + gc(i, j)
                if c < best:
                    best, besti = c, i
            if best < dp[k, j]:
                dp[k, j] = best
                arg[k, j] = besti
    # best over any number of groups ≤ p_max
    kbest = int(np.argmin(dp[:, n]))
    if not np.isfinite(dp[kbest, n]):
        raise ValueError("no feasible partitioning (capacity too small?)")
    bounds: list[int] = []
    j, k = n, kbest
    while j > 0:
        i = int(arg[k, j])
        if i == -2:  # came from dp[k-1, j] (unused group)
            k -= 1
            continue
        bounds.append(i)
        j, k = i, k - 1
    bounds.reverse()
    return bounds, float(dp[kbest, n])


def bounds_to_assign(bounds: list[int], n: int) -> np.ndarray:
    """Convert group start indices to a per-item partition id vector."""
    assign = np.zeros(n, dtype=np.int64)
    for g, start in enumerate(bounds):
        end = bounds[g + 1] if g + 1 < len(bounds) else n
        assign[start:end] = g
    return assign


def branch_and_bound(graph: DataflowGraph, p_max: int,
                     objective: Callable[[np.ndarray], float],
                     feasible: Callable[[np.ndarray], bool] | None = None,
                     node_limit: int = 2_000_000) -> tuple[np.ndarray, float]:
    """Exact search over all precedence-feasible assignment matrices A.

    ``objective(assign)`` maps a full partition-id vector (in graph kernel
    order) to a cost; ``feasible`` may reject assignments (capacity).
    Kernels are assigned in topological order; each kernel may go to any
    partition ≥ max(partition of its predecessors) — the monotone schedule
    constraint of a sequential/pipelined execution. Branch & bound with the
    trivial bound (objectives here are monotone in prefix assignment is NOT
    assumed — we bound only by full evaluation at leaves, pruning via the
    precedence lattice and an optional incumbent check on partial costs when
    the objective supports it).
    """
    topo = graph.topo_order
    n = graph.n
    preds: list[list[int]] = [[] for _ in range(n)]
    for t in graph.tensors:
        preds[graph.kernel_index(t.dst)].append(graph.kernel_index(t.src))

    best_assign: np.ndarray | None = None
    best_cost = float("inf")
    assign = np.zeros(n, dtype=np.int64)
    nodes = 0

    def rec(pos: int) -> None:
        nonlocal best_assign, best_cost, nodes
        nodes += 1
        if nodes > node_limit:
            raise RuntimeError("branch_and_bound node limit exceeded")
        if pos == n:
            if feasible is not None and not feasible(assign):
                return
            c = objective(assign)
            if c < best_cost:
                best_cost = c
                best_assign = assign.copy()
            return
        i = topo[pos]
        lo = max((assign[p] for p in preds[i]), default=0)
        for part in range(lo, p_max):
            assign[i] = part
            rec(pos + 1)
        assign[i] = 0

    rec(0)
    if best_assign is None:
        raise ValueError("no feasible assignment")
    return best_assign, best_cost


def enumerate_parallelism(n_chips: int,
                          max_tp: int | None = None,
                          max_pp: int | None = None
                          ) -> list[tuple[int, int, int]]:
    """All (tp, pp, dp) with tp·pp·dp == n_chips (paper's outer loop)."""
    out = []
    for tp in _divisors(n_chips):
        if max_tp and tp > max_tp:
            continue
        rest = n_chips // tp
        for pp in _divisors(rest):
            if max_pp and pp > max_pp:
                continue
            out.append((tp, pp, rest // pp))
    return out


def _divisors(x: int) -> list[int]:
    out = [d for d in range(1, int(x ** 0.5) + 1) if x % d == 0]
    return sorted(set(out + [x // d for d in out]))


def design_space_size(graph: DataflowGraph, p_max: int, n_chips: int,
                      schemes_per_kernel: int = 3) -> float:
    """Order-of-magnitude size of the joint mapping space (paper: O(10^295)).

    partitions^kernels × schemes^kernels × parallelism combos.
    """
    import math
    n = graph.n
    combos = len(enumerate_parallelism(n_chips))
    return (math.log10(p_max) * n + math.log10(schemes_per_kernel) * n
            + math.log10(max(combos, 1)))


def intra_chip_matrices_cost(graph: DataflowGraph, assign: np.ndarray,
                             p_max: int, b: np.ndarray, s_cap: float,
                             d_cap: float) -> tuple[np.ndarray, np.ndarray, bool]:
    """Evaluate SRAM/DRAM terms through the exact matrix formulation.

    Returns (sram_per_partition, dram_xfer_per_partition, feasible) using
    Bᵀb ≤ s_cap, Lᵀb ≤ d_cap (paper §V.B.2).
    """
    A = assignment_matrix(assign, p_max)
    B = matrix_B(graph, A).astype(np.float64)
    D = matrix_D(graph, A).astype(np.float64)
    L = matrix_L(graph, A).astype(np.float64)
    sram = B.T @ b
    dram = D.T @ b
    live = L.T @ b
    ok = bool((sram <= s_cap).all() and (live <= d_cap).all())
    return sram, dram, ok
