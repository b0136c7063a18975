"""Keyed memo cache for the expensive DSE inner solves.

The 80-system cartesian sweep of §VI.C re-solves identical subproblems at
almost every design point: the TP sharding of one workload layer graph is a
pure function of ``(graph, tp, topology structure)`` and is shared by every
memory variant of a system; the PP stage partition depends only on the
per-layer cost vector; the intra-chip pass on ``(layer_graph, chip, mem, tp,
mode)``; and the whole inter-chip plan is memory-independent except for its
final capacity check.  ``SolveCache`` memoizes all of them under structural
(content-derived) keys so that rebuilding an identical workload object — which
``sweep()`` does once per system — still hits.

Cache key contract
------------------
Keys must capture *every* input that influences the cached value, using
hashable structural identities (never ``id()``):

* graphs enter keys via :meth:`repro_torch.core.graph.DataflowGraph.fingerprint`
  (a content digest over kernels + tensors);
* chip/memory/interconnect/topology specs are frozen dataclasses and enter
  keys directly;
* derived float vectors (``h_n``/``h_m``, per-stage cost items) enter as
  tuples of the exact float values.

Under that contract a cache hit returns an object computed from bitwise-
identical inputs, so cached and uncached sweeps produce identical results.

Each process owns its own cache (workers of a forked
:class:`repro_torch.core.dse_engine.DSEEngine` pool inherit the parent's warm
entries at fork time).  The reference's cross-process shared tier is not
ported (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable, Hashable


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Hit/miss/size counters, total and per key space."""

    hits: int
    misses: int
    entries: int
    by_space: dict[str, tuple[int, int, int]]  # space -> (hits, misses, size)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class SolveCache:
    """A namespaced memo cache with hit/miss accounting.

    ``space`` partitions keys by solve family ("sharding", "minmax",
    "intra", "plan", "subdiv") so stats are attributable and clearing can
    stay global and simple. Entries are evicted wholesale once ``max_entries`` is
    exceeded (the sweep working set is far below the default bound; the
    guard only protects pathological long-running processes).
    """

    def __init__(self, max_entries: int = 1 << 16) -> None:
        self.max_entries = max_entries
        self._data: dict[tuple[str, Hashable], Any] = {}
        self._hits: Counter[str] = Counter()
        self._misses: Counter[str] = Counter()

    def get_or_compute(self, space: str, key: Hashable,
                       compute: Callable[[], Any]) -> Any:
        full = (space, key)
        if full in self._data:
            self._hits[space] += 1
            return self._data[full]
        value = compute()
        if len(self._data) >= self.max_entries:
            self._data.clear()
        self._data[full] = value
        self._misses[space] += 1
        return value

    def stats(self) -> CacheStats:
        sizes: Counter[str] = Counter(space for space, _ in self._data)
        spaces = set(self._hits) | set(self._misses) | set(sizes)
        return CacheStats(
            hits=sum(self._hits.values()),
            misses=sum(self._misses.values()),
            entries=len(self._data),
            by_space={s: (self._hits[s], self._misses[s], sizes[s])
                      for s in spaces})

    def clear(self) -> None:
        self._data.clear()
        self._hits.clear()
        self._misses.clear()


#: Process-global cache shared by the inter-chip, intra-chip and DSE layers.
GLOBAL_CACHE = SolveCache()


def cache_stats() -> CacheStats:
    return GLOBAL_CACHE.stats()


def clear_caches() -> None:
    GLOBAL_CACHE.clear()
