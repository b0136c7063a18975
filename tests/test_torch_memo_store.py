"""The port's cross-process shared memo store (``repro_torch.core.memo_store``)
and the shared tier of its memo cache, held to the reference's contract.

The cases of the reference's ``tests/test_memo_store.py``, run once per
package (``repro`` and ``repro_torch``) so each still counts, for both
store backends (mmap table + socket server):

* concurrent put/get hammering from a real process pool — no torn reads,
  and exactly-once storage for racing writers of one key;
* server survival when a client process crashes mid-session, and
  graceful teardown afterwards;
* cross-process stats aggregation with exact expected counts;
* the memo-layer write-through contract (compute once across caches,
  ``None`` values shared, unpicklable keys/values degrading to
  local-only entries instead of breaking the solve).

Two port-only cases close the file: the two packages' stores speak one
on-disk and wire format, and the port's socket paths fit AF_UNIX.
"""
from __future__ import annotations

import concurrent.futures as cf
import importlib
import multiprocessing
import os
import pickle
import sys

import pytest

PACKAGES = ("repro", "repro_torch")
BACKENDS = ("mmap", "server")


@pytest.fixture(params=PACKAGES)
def pkg(request):
    """The package under test: its memo_store and memo modules."""
    return (importlib.import_module(f"{request.param}.core.memo_store"),
            importlib.import_module(f"{request.param}.core.memo"))


def _mp_ctx() -> multiprocessing.context.BaseContext:
    # fork only while neither jax nor a CUDA context could be live in this
    # process; forkserver keeps the mmap backend's coverage otherwise
    methods = multiprocessing.get_all_start_methods()
    if "fork" in methods and "jax" not in sys.modules:
        return multiprocessing.get_context("fork")
    if "forkserver" in methods:
        return multiprocessing.get_context("forkserver")
    return multiprocessing.get_context(methods[0])


def _make_store(ms, backend: str, ctx):
    if backend == "mmap":
        pytest.importorskip("fcntl")
        return ms.MmapStore()
    return ms.ServerStore(mp_context=ctx)


def _value_for(k: int, n_bytes: int) -> bytes:
    seed = b"value-%d-" % k
    return (seed * (n_bytes // len(seed) + 1))[:n_bytes]


# ---- module-level worker fns (picklable under spawn) ------------------------
def _hammer(args: tuple) -> list:
    handle, n_keys, rounds, n_bytes = args
    client = handle.connect()
    torn = []
    for r in range(rounds):
        for k in range(n_keys):
            key = b"key-%d" % k
            expect = _value_for(k, n_bytes)
            got = client.get("hammer", key)
            if got is None:
                client.put("hammer", key, expect)
            elif got != expect:
                torn.append((r, k, len(got)))
    client.flush()
    client.close()
    return torn


def _race_one_key(args: tuple) -> bytes:
    handle, worker_id = args
    client = handle.connect()
    client.put("race", b"the-key", b"from-worker-%d " % worker_id * 64)
    client.flush()
    value = client.get("race", b"the-key")
    client.close()
    return value


def _counted_ops(args: tuple) -> None:
    handle, worker_id = args
    client = handle.connect()
    own = b"own-%d" % worker_id
    assert client.get("agg", own) is None          # 1 miss
    client.put("agg", own, b"v")                   # 1 insert
    client.flush()
    assert client.get("agg", own) == b"v"          # 1 hit
    assert client.get("agg", b"common") == b"seed"  # 1 hit (parent-seeded)
    client.flush()
    client.close()


def _crash_after_put(handle) -> None:
    client = handle.connect()
    client.put("crash", b"crash-key", b"crash-value")
    client.flush()
    os._exit(1)  # die without close(): the server must shrug it off


# ------------------------------ concurrency ----------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_concurrent_hammer_no_torn_reads_exactly_once(pkg, backend):
    """4 processes × 5 rounds over 24 shared keys with 8KB values: every
    read returns the full correct value (no torn/partial entries) and
    racing writers of one key leave exactly one stored entry."""
    ms, _ = pkg
    ctx = _mp_ctx()
    store = _make_store(ms, backend, ctx)
    try:
        n_keys, n_bytes = 24, 8192
        task = (store.handle(), n_keys, 5, n_bytes)
        with cf.ProcessPoolExecutor(max_workers=4, mp_context=ctx) as pool:
            torn = [t for out in pool.map(_hammer, [task] * 4) for t in out]
        assert torn == [], f"torn/corrupt reads: {torn[:5]}"
        for k in range(n_keys):
            assert store.get("hammer", b"key-%d" % k) == \
                _value_for(k, n_bytes)
        stats = store.stats()
        assert stats["entries"] == n_keys          # exactly-once storage
        assert stats["by_space"]["hammer"]["inserts"] == n_keys
        assert stats["dropped"] == 0
    finally:
        store.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_racing_writers_one_key_single_winner(pkg, backend):
    """Workers racing distinct values into one key: a single value wins,
    every subsequent read (any process) sees that same value."""
    ms, _ = pkg
    ctx = _mp_ctx()
    store = _make_store(ms, backend, ctx)
    try:
        tasks = [(store.handle(), i) for i in range(4)]
        with cf.ProcessPoolExecutor(max_workers=4, mp_context=ctx) as pool:
            seen = list(pool.map(_race_one_key, tasks))
        winner = store.get("race", b"the-key")
        assert winner is not None
        assert winner in {b"from-worker-%d " % i * 64 for i in range(4)}
        assert set(seen) == {winner}
        assert store.stats()["entries"] == 1
    finally:
        store.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_stats_aggregate_across_processes(pkg, backend):
    """Known per-worker op counts must sum exactly in the shared stats."""
    ms, _ = pkg
    ctx = _mp_ctx()
    store = _make_store(ms, backend, ctx)
    try:
        store.put("agg", b"common", b"seed")
        store.flush()
        tasks = [(store.handle(), i) for i in range(3)]
        with cf.ProcessPoolExecutor(max_workers=3, mp_context=ctx) as pool:
            list(pool.map(_counted_ops, tasks))
        agg = store.stats()["by_space"]["agg"]
        assert agg["misses"] == 3       # one first-get per worker key
        assert agg["hits"] == 6         # own re-get + common, per worker
        assert agg["inserts"] == 4      # 3 worker keys + the parent seed
        assert agg["dropped"] == 0
    finally:
        store.close()


# ------------------------------ server lifecycle -----------------------------
def test_server_survives_client_crash_and_tears_down(pkg):
    ms, _ = pkg
    ctx = _mp_ctx()
    store = ms.ServerStore(mp_context=ctx)
    path = store.path
    try:
        proc = ctx.Process(target=_crash_after_put, args=(store.handle(),))
        proc.start()
        proc.join(timeout=30)
        assert proc.exitcode == 1
        # the server kept the crashed client's flushed write and still
        # serves other clients
        assert store.get("crash", b"crash-key") == b"crash-value"
        store.put("crash", b"after", b"ok")
        store.flush()
        assert store.get("crash", b"after") == b"ok"
    finally:
        store.close()
    assert not os.path.exists(path)  # graceful teardown removed the socket


def test_dead_server_degrades_to_misses_not_errors(pkg):
    ms, _ = pkg
    ctx = _mp_ctx()
    store = ms.ServerStore(mp_context=ctx)
    client = store.handle().connect()
    client.put("x", b"k", b"v")
    client.flush()
    store.close()  # server gone; the surviving client must not raise
    assert client.get("x", b"k") is None
    client.put("x", b"k2", b"v2")
    client.flush()
    client.close()


# ------------------------------ mmap specifics -------------------------------
def test_mmap_oversize_value_dropped_not_stored(pkg):
    ms, _ = pkg
    pytest.importorskip("fcntl")
    store = ms.MmapStore(stripe_bytes=1 << 12)
    try:
        store.put("big", b"k", b"x" * (1 << 13))  # larger than a stripe
        assert store.get("big", b"k") is None
        stats = store.stats()
        assert stats["by_space"]["big"]["dropped"] == 1
        assert stats["entries"] == 0
    finally:
        store.close()


def test_mmap_full_stripe_drops_then_keeps_serving(pkg):
    ms, _ = pkg
    pytest.importorskip("fcntl")
    store = ms.MmapStore(n_stripes=1, stripe_bytes=1 << 12)
    try:
        for i in range(40):  # ~40 × 128B entries overflow the 4KB stripe
            store.put("fill", b"fk-%d" % i, b"y" * 128)
        stats = store.stats()
        assert stats["dropped"] > 0
        assert stats["entries"] + stats["dropped"] == 40
        # entries that made it in are still intact
        assert store.get("fill", b"fk-0") == b"y" * 128
    finally:
        store.close()


def test_mmap_owner_unlinks_file_on_close(pkg):
    ms, _ = pkg
    pytest.importorskip("fcntl")
    store = ms.MmapStore()
    reader = store.handle().connect()
    store.put("t", b"k", b"v")
    assert reader.get("t", b"k") == b"v"
    reader.close()
    path = store.path
    assert os.path.exists(path)
    store.close()
    assert not os.path.exists(path)


# ------------------------------ plumbing -------------------------------------
def test_handle_pickles_and_reconnects(pkg):
    ms, _ = pkg
    pytest.importorskip("fcntl")
    store = ms.MmapStore()
    try:
        store.put("p", b"k", b"v")
        handle = pickle.loads(pickle.dumps(store.handle()))
        client = handle.connect()
        assert client.get("p", b"k") == b"v"
        client.close()
    finally:
        store.close()
    with pytest.raises(ValueError):
        ms.StoreHandle("carrier-pigeon", "/nope").connect()


def test_choose_backend_follows_transport(pkg):
    ms, _ = pkg
    pytest.importorskip("fcntl")
    assert ms.choose_backend("fork") == "mmap"
    assert ms.choose_backend("forkserver") == "mmap"
    assert ms.choose_backend("spawn") == "server"


def test_create_store_auto_and_explicit(pkg):
    ms, _ = pkg
    ctx = _mp_ctx()
    store = ms.create_store("auto", mp_context=ctx)
    try:
        assert store.backend == ms.choose_backend(ctx.get_start_method())
    finally:
        store.close()
    with pytest.raises(ValueError):
        ms.create_store("etcd")


# ------------------------------ memo layering --------------------------------
def test_write_through_computes_once_across_caches(pkg):
    """Two caches (standing in for two workers) sharing one store: the
    second cache's lookup is served from the store, including a ``None``
    value — a legitimate cached result for failed plan solves."""
    ms, memo = pkg
    pytest.importorskip("fcntl")
    store = ms.MmapStore()
    a, b = memo.SolveCache(), memo.SolveCache()
    a.attach_shared(store)
    b.attach_shared(store)
    try:
        calls = []
        key = ("plan", ("fp", 4, (1.5, 2.5)))
        va = a.get_or_compute("plan", key, lambda: calls.append("a") or None)
        vb = b.get_or_compute("plan", key,
                              lambda: calls.append("b") or "wrong")
        assert va is None and vb is None
        assert calls == ["a"], "second cache recomputed a shared solve"
        st = store.stats()
        assert st["by_space"]["plan"] == {"hits": 1, "misses": 1,
                                          "inserts": 1, "dropped": 0}
        assert b.stats().hits == 1  # a shared hit counts for the sweep too
    finally:
        a.detach_shared()
        b.detach_shared()
        store.close()


def test_unpicklable_keys_and_values_stay_local_only(pkg):
    ms, memo = pkg
    pytest.importorskip("fcntl")
    store = ms.MmapStore()
    cache = memo.SolveCache()
    cache.attach_shared(store)
    try:
        weird_key = lambda: None  # hashable, unpicklable   # noqa: E731
        assert cache.get_or_compute("s", weird_key, lambda: 7) == 7
        assert cache.get_or_compute("s", weird_key, lambda: 8) == 7
        unpicklable = cache.get_or_compute("s", "vk", lambda: (lambda: 9))
        assert unpicklable() == 9
        assert store.stats()["inserts"] == 0  # nothing crossed the boundary
    finally:
        cache.detach_shared()
        store.close()


def test_detach_returns_client_and_keeps_local_entries(pkg):
    ms, memo = pkg
    pytest.importorskip("fcntl")
    store = ms.MmapStore()
    cache = memo.SolveCache()
    cache.attach_shared(store)
    try:
        cache.get_or_compute("s", "k", lambda: 42)
        assert cache.detach_shared() is store
        assert cache.shared is None
        assert cache.get_or_compute("s", "k", lambda: 43) == 42  # local warm
    finally:
        store.close()


# ---- CacheStats per-space accounting ----------------------------------------
def test_cache_stats_space_hit_rate_guards_zero_lookups(pkg):
    """Per-space hit rates carry the same divide-by-zero guard as the
    aggregate: a space with zero lookups — entries only, e.g. inherited
    at fork time — and an unknown space both report 0.0 instead of
    raising, and ``rows()`` stays consistent with ``space_hit_rate``."""
    _, memo = pkg
    cache = memo.SolveCache()
    cache.get_or_compute("hot", "k", lambda: 1)
    cache.get_or_compute("hot", "k", lambda: 2)      # 1 hit, 1 miss
    cache.get_or_compute("coldmiss", "k", lambda: 3)  # 0 hits, 1 miss
    # a space with entries but no recorded lookups: seed the data dict the
    # way a fork-inherited cache would look after the child's stats reset
    cache._data[("inherited", "k")] = 9
    stats = cache.stats()
    assert stats.space_hit_rate("hot") == 0.5
    assert stats.space_hit_rate("coldmiss") == 0.0
    assert stats.space_hit_rate("inherited") == 0.0   # zero lookups, no raise
    assert stats.space_hit_rate("never-seen") == 0.0  # unknown space, no raise
    assert stats.by_space["inherited"] == (0, 0, 1)
    by_row = {r["space"]: r for r in stats.rows()}
    for space in ("hot", "coldmiss", "inherited"):
        assert by_row[space]["hit_rate"] == stats.space_hit_rate(space)
    assert by_row["TOTAL"]["hit_rate"] == stats.hit_rate


def test_cache_stats_empty_cache_rates_all_zero(pkg):
    _, memo = pkg
    stats = memo.SolveCache().stats()
    assert stats.hit_rate == 0.0
    assert stats.space_hit_rate("anything") == 0.0
    assert stats.rows()[-1] == {"space": "TOTAL", "hits": 0, "misses": 0,
                                "entries": 0, "hit_rate": 0.0}


# ------------------------------ port specifics -------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_store_formats_interoperate_across_packages(backend):
    """The port keeps the reference's mmap layout and wire framing: a
    client of either package reads what the other package's store holds."""
    import repro.core.memo_store as ref_ms
    import repro_torch.core.memo_store as port_ms

    ctx = _mp_ctx()
    for owner, other in ((ref_ms, port_ms), (port_ms, ref_ms)):
        store = _make_store(owner, backend, ctx)
        try:
            store.put("x", b"k", b"v")
            store.flush()
            handle = other.StoreHandle(*pickle.loads(pickle.dumps(
                (store.handle().kind, store.handle().path))))
            client = handle.connect()
            assert client.get("x", b"k") == b"v"
            client.put("x", b"k2", b"v2")
            client.flush()
            client.close()
            assert store.get("x", b"k2") == b"v2"
        finally:
            store.close()


def test_port_socket_paths_fit_af_unix():
    """AF_UNIX paths hold at most ~108 bytes: the port's store server and
    DSE daemon make theirs in a short temporary directory."""
    from repro_torch.core.memo_store import ServerStore
    from repro_torch.service import DSEService

    store = ServerStore(mp_context=_mp_ctx())
    try:
        assert len(store.path.encode()) < 100
        assert os.path.basename(os.path.dirname(store.path)).startswith(
            "dfm-memo-")
    finally:
        store.close()
    svc = DSEService(parallel=False, device="cpu")
    assert len(svc.path.encode()) < 100
