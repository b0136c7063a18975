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
identical inputs, so cached and uncached sweeps produce identical results —
the property ``tests/test_torch_dse.py`` locks in.

Entries stay numpy-only: a candidate set caches its priced columns as
numpy arrays per (backend, device), never as CUDA tensors, so every entry
pickles into the shared tier and a worker that unpickles one never
initialises CUDA.

Each process owns its own local cache (workers of a forked
:class:`repro_torch.core.dse_engine.DSEEngine` pool inherit the parent's warm
entries at fork time).  A *shared* tier can be layered underneath via
:meth:`SolveCache.attach_shared`: lookups then fall back local → shared,
and computed values are written through to both, so every worker of one
sweep reuses every other worker's solves (see
:mod:`repro_torch.core.memo_store` for the cross-process store backends).  The
shared tier is strictly an extra place to find the same
structurally-keyed values, so the bit-identical-results property is
unchanged — and any shared-store failure silently degrades to a miss.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pickle
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

    def space_hit_rate(self, space: str) -> float:
        """Hit rate of one key space, with the same zero-lookup guard as
        the aggregate :attr:`hit_rate`: a space with no lookups (or one
        this snapshot has never seen) reports 0.0, never a
        ``ZeroDivisionError`` — spaces holding only entries inherited at
        fork time, or registered after a ``clear()``, legitimately show
        size > 0 with zero traffic."""
        h, m, _ = self.by_space.get(space, (0, 0, 0))
        total = h + m
        return h / total if total else 0.0

    def rows(self) -> list[dict]:
        """Per-space stats as table/JSON rows."""
        out = [{"space": s, "hits": h, "misses": m, "entries": e,
                "hit_rate": self.space_hit_rate(s)}
               for s, (h, m, e) in sorted(self.by_space.items())]
        out.append({"space": "TOTAL", "hits": self.hits,
                    "misses": self.misses, "entries": self.entries,
                    "hit_rate": self.hit_rate})
        return out


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
        self.enabled = True
        self._data: dict[tuple[str, Hashable], Any] = {}
        self._hits: Counter[str] = Counter()
        self._misses: Counter[str] = Counter()
        #: Optional cross-process tier (see ``repro_torch.core.memo_store``):
        #: a client with ``get(space, key_bytes) -> bytes | None`` and
        #: ``put(space, key_bytes, value_bytes)``.
        self.shared = None

    def attach_shared(self, client) -> None:
        """Layer a cross-process store under the local dict (write-through)."""
        self.shared = client

    def detach_shared(self):
        """Remove and return the shared tier (local entries stay warm)."""
        client, self.shared = self.shared, None
        return client

    def get_or_compute(self, space: str, key: Hashable,
                       compute: Callable[[], Any]) -> Any:
        if not self.enabled:
            self._misses[space] += 1
            return compute()
        full = (space, key)
        if full in self._data:
            self._hits[space] += 1
            return self._data[full]
        blob_key = self._shared_key(full) if self.shared is not None else None
        if blob_key is not None:
            found = self._shared_get(space, blob_key)
            if found is not None:
                # found in another process's work: a hit for this sweep
                # (the store's own stats count it as a cross-process hit)
                (value,) = found
                self._hits[space] += 1
                if len(self._data) >= self.max_entries:
                    self._data.clear()
                self._data[full] = value
                return value
        value = compute()
        if len(self._data) >= self.max_entries:
            self._data.clear()
        self._data[full] = value
        self._misses[space] += 1
        if blob_key is not None:
            self._shared_put(space, blob_key, value)
        return value

    # -- shared tier (never allowed to break a solve) --
    def _shared_key(self, full: tuple[str, Hashable]) -> bytes | None:
        try:
            return pickle.dumps(full, pickle.HIGHEST_PROTOCOL)
        except Exception:
            return None  # unpicklable key: local-only entry

    def _shared_get(self, space: str,
                    blob_key: bytes) -> tuple[Any] | None:
        """The stored value in a 1-tuple (``None`` *values* are legitimate
        cache entries — e.g. failed plan solves) or ``None`` on a miss."""
        try:
            blob = self.shared.get(space, blob_key)
            if blob is None:
                return None
            found = pickle.loads(blob)
            if isinstance(found, tuple) and len(found) == 1:
                return found
            return None  # not our wrapping: treat as a miss, never raise
        except Exception:
            return None

    def _shared_put(self, space: str, blob_key: bytes, value: Any) -> None:
        try:
            self.shared.put(space, blob_key,
                            pickle.dumps((value,), pickle.HIGHEST_PROTOCOL))
        except Exception:
            pass  # unpicklable value / full stripe / dead store: local-only

    def harvest(self, space: str) -> list[tuple[Hashable, Any]]:
        """All ``(key, value)`` pairs cached under ``space``, local tier
        first, then any shared-tier entries not already seen locally.

        This is the training-set extraction hook for surrogate models
        (:mod:`repro_torch.search`): after a sweep, ``harvest("candmat")``
        yields every memoised :class:`repro_torch.core.interchip.CandidateSet`
        — including ones computed by *other* processes of the same sweep
        when a shared store is attached.  Shared entries that fail to
        unpickle (version skew, torn writes are already excluded by the
        store) are skipped, never raised — same contract as
        ``_shared_get``.  Purely observational: no stats counters move.
        """
        out = [(key, value) for (s, key), value in self._data.items()
               if s == space]
        shared_items = getattr(self.shared, "items", None)
        if shared_items is None:
            return out
        seen = {self._shared_key((space, key)) for key, _ in out}
        seen.discard(None)
        try:
            blobs = list(shared_items())
        except Exception:
            return out
        for key_blob, value_blob in blobs:
            if key_blob in seen:
                continue
            try:
                full = pickle.loads(key_blob)
                if (not isinstance(full, tuple) or len(full) != 2
                        or full[0] != space):
                    continue
                found = pickle.loads(value_blob)
                if isinstance(found, tuple) and len(found) == 1:
                    out.append((full[1], found[0]))
            except Exception:
                continue
        return out

    def stats(self) -> CacheStats:
        sizes: Counter[str] = Counter(space for space, _ in self._data)
        spaces = set(self._hits) | set(self._misses) | set(sizes)
        return CacheStats(
            hits=sum(self._hits.values()),
            misses=sum(self._misses.values()),
            entries=len(self._data),
            by_space={s: (self._hits[s], self._misses[s], sizes[s])
                      for s in spaces})

    def diff_stats(self, before: CacheStats | None) -> dict:
        """Per-space entry/traffic delta since a :meth:`stats` snapshot
        (``before=None`` ≡ an empty snapshot).  The incremental refit of
        the learned rank stage polls ``["by_space"]["candmat"]``
        growth between warm-session requests to decide when the harvest
        gained enough new candidate sets to justify refitting — the
        in-process analogue of :func:`repro_torch.core.memo_store.diff_stats`
        for the shared tier."""
        after = self.stats()
        if before is None:
            before = CacheStats(hits=0, misses=0, entries=0, by_space={})
        by_space = {}
        for space in set(after.by_space) | set(before.by_space):
            ah, am, asz = after.by_space.get(space, (0, 0, 0))
            bh, bm, bsz = before.by_space.get(space, (0, 0, 0))
            by_space[space] = (ah - bh, am - bm, asz - bsz)
        return {"hits": after.hits - before.hits,
                "misses": after.misses - before.misses,
                "entries": after.entries - before.entries,
                "by_space": by_space}

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


@contextlib.contextmanager
def caching_disabled():
    """Force every solve to run cold (the serial-baseline mode of
    ``DSEEngine(use_cache=False)``)."""
    prev = GLOBAL_CACHE.enabled
    GLOBAL_CACHE.enabled = False
    try:
        yield
    finally:
        GLOBAL_CACHE.enabled = prev
