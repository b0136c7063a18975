"""Shared fixtures + hypothesis strategies.

IMPORTANT: no XLA_FLAGS here — smoke tests and benches must see the real
single CPU device; only launch/dryrun.py installs the 512 placeholder
devices (and only in its own process).

``hypothesis`` is a dev-only dependency (requirements-dev.txt). When it is
absent the property-test strategies below degrade to stubs that skip, and
the property-test modules guard themselves with
``pytest.importorskip("hypothesis")`` — collection must never fail on a
missing dev extra.
"""
from __future__ import annotations

import numpy as np
import pytest

try:
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    st = None
    HAVE_HYPOTHESIS = False

from repro.core.graph import DataflowGraph, Kernel, KernelKind, Tensor


def _build_dag(n: int, edges: set[tuple[int, int]], flops, weights,
               kinds, tensor_bytes) -> DataflowGraph:
    """Assemble the random-DAG fixture; edges only i -> j with i < j, so the
    index order is a valid topological order."""
    kernels = [Kernel(f"k{i}", flops=flops[i], kind=kinds[i],
                      weight_bytes=weights[i]) for i in range(n)]
    tensors = [Tensor(f"t{i}_{j}", f"k{i}", f"k{j}", b)
               for (i, j), b in zip(sorted(edges), tensor_bytes)]
    return DataflowGraph(kernels, tensors, "random")


if HAVE_HYPOTHESIS:
    # ----------------------- random DAG strategy -----------------------------
    @st.composite
    def dags(draw, max_kernels: int = 8, max_edges: int = 12,
             connected_chain: bool = True):
        """Random DAG with kernels k0..k{n-1}; edges only i -> j with i < j,
        so the index order is a valid topological order."""
        n = draw(st.integers(min_value=2, max_value=max_kernels))
        kinds = list(KernelKind)
        flops = [draw(st.floats(min_value=1.0, max_value=1e12))
                 for _ in range(n)]
        weights = [draw(st.floats(min_value=0.0, max_value=1e9))
                   for _ in range(n)]
        kind_choice = [draw(st.sampled_from(kinds)) for _ in range(n)]
        edges: set[tuple[int, int]] = set()
        if connected_chain:
            edges |= {(i, i + 1) for i in range(n - 1)}
        m_extra = draw(st.integers(min_value=0, max_value=max_edges))
        for _ in range(m_extra):
            i = draw(st.integers(min_value=0, max_value=n - 2))
            j = draw(st.integers(min_value=i + 1, max_value=n - 1))
            edges.add((i, j))
        tensor_bytes = [draw(st.floats(min_value=1.0, max_value=1e9))
                        for _ in sorted(edges)]
        return _build_dag(n, edges, flops, weights, kind_choice, tensor_bytes)

    @st.composite
    def dags_with_assignments(draw, max_kernels: int = 8, p_max: int = 4):
        """(graph, precedence-feasible assignment vector, p_max)."""
        g = draw(dags(max_kernels=max_kernels))
        # monotone assignment along index order keeps precedence feasible
        assign = []
        cur = 0
        for _ in range(g.n):
            cur = min(cur + draw(st.integers(min_value=0, max_value=1)),
                      p_max - 1)
            assign.append(cur)
        return g, np.array(assign, dtype=np.int64), p_max
else:
    def dags(*args, **kwargs):  # pragma: no cover - exercised without dev deps
        pytest.skip("hypothesis not installed (pip install -r "
                    "requirements-dev.txt)")

    def dags_with_assignments(*args, **kwargs):  # pragma: no cover
        pytest.skip("hypothesis not installed (pip install -r "
                    "requirements-dev.txt)")


def random_dag(rng: np.random.Generator, max_kernels: int = 8,
               max_edges: int = 12) -> DataflowGraph:
    """Seeded random DAG for the non-hypothesis fallback tests — same shape
    distribution as the ``dags()`` strategy."""
    n = int(rng.integers(2, max_kernels + 1))
    kinds = list(KernelKind)
    flops = rng.uniform(1.0, 1e12, size=n).tolist()
    weights = rng.uniform(0.0, 1e9, size=n).tolist()
    kind_choice = [kinds[int(rng.integers(len(kinds)))] for _ in range(n)]
    edges = {(i, i + 1) for i in range(n - 1)}
    for _ in range(int(rng.integers(0, max_edges + 1))):
        i = int(rng.integers(0, n - 1))
        j = int(rng.integers(i + 1, n))
        edges.add((i, j))
    tensor_bytes = rng.uniform(1.0, 1e9, size=len(edges)).tolist()
    return _build_dag(n, edges, flops, weights, kind_choice, tensor_bytes)


@pytest.fixture(scope="session")
def smoke_cfgs():
    from repro.configs import ARCH_IDS, get_config
    return {a: get_config(a, smoke=True) for a in ARCH_IDS}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")
