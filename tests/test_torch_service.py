"""The port's warm sessions, streaming sweeps, baselines and DSE service
daemon (``repro_torch.service``) against the JAX package's reference.

On the CPU (``device="cpu"``; the ``kernel`` backend runs its plain
version): a warm session's sweeps are bit-identical to the reference's
rows and re-entrant; ``sweep_iter`` / ``sweep_cells_iter`` with
``stop_after_feasible`` stream the reference's items; the ``phased=False``
and ``use_cache=False`` baselines and the shared memo tier give the
reference's rows; and a port ``DSEService`` answers the same queries as a
``repro`` one — rows, dedup hits, search replies and reprice reports equal,
malformed queries refused with the same codes. ``python -m
repro_torch.service --device cpu`` serves here. Reference tests that hold
for both packages run once per package. Each test starts and ends with
fresh caches in both packages.
"""
from __future__ import annotations

import importlib
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import types

import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.core.memo import GLOBAL_CACHE

PACKAGES = ("repro", "repro_torch")
SCENARIOS = ("llm", "dlrm", "hpl", "fft", "moe", "mamba2", "serving")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _pkg(name: str) -> types.SimpleNamespace:
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, core=mod("core"), memo_store=mod("core.memo_store"),
        service=mod("service"), protocol=mod("service.protocol"),
        scenarios=mod("workloads.scenarios"))


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def _port_kwargs(p, backend: str = "kernel") -> dict:
    return ({"device": "cpu", "pricing_backend": backend}
            if p.name == "repro_torch" else {})


def _engine(p, backend: str = "kernel", **kwargs):
    kwargs.setdefault("parallel", False)
    return p.core.DSEEngine(**_port_kwargs(p, backend), **kwargs)


def _service(p, **kwargs):
    kwargs.setdefault("parallel", False)
    kwargs.setdefault("batch_cells", 4)
    return p.service.DSEService(**_port_kwargs(p), **kwargs)


def _exact_row(row: dict) -> dict:
    return {k: v.hex() if isinstance(v, float) else v for k, v in row.items()}


def _exact(rows) -> list[dict]:
    return [_exact_row(r) for r in rows]


def _items(items) -> list[tuple]:
    return [(it.index, None if it.point is None else _exact_row(it.point.row()))
            for it in items]


def _sc(p, name: str = "llm"):
    return p.scenarios.get_scenario(name, smoke=True)


def _reference_rows(name: str = "llm", **kwargs) -> list[dict]:
    sc = _sc(REF, name)
    return _exact(p.row() for p in REF.core.DSEEngine(parallel=False,
                                                      **kwargs)
                  .sweep(sc.work_fn, sc.spec))


@pytest.fixture(autouse=True)
def _fresh_caches():
    ref_core.clear_caches()
    port_core.clear_caches()
    yield
    ref_core.clear_caches()
    port_core.clear_caches()


# --- warm sessions -----------------------------------------------------------
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_warm_session_sweeps_bit_identical_and_reentrant(backend):
    want = _reference_rows()
    sc = _sc(PORT)
    with _engine(PORT, backend, parallel="auto", max_workers=2,
                 shared_cache=True) as eng:
        assert eng.session_active and eng._session_pool is not None
        a = _exact(p.row() for p in eng.sweep(sc.work_fn, sc.spec))
        b = _exact(p.row() for p in eng.sweep(sc.work_fn, sc.spec))
        assert a == want and b == want
        assert eng.last_shared_stats["backend"] == "mmap"
        items = list(eng.sweep_cells_iter(sc.work_fn, sc.spec.grid()[:5],
                                          sc.spec))
        assert sorted(i.index for i in items) == list(range(5))
    assert not eng.session_active and eng._session_store is None
    assert _exact(p.row() for p in eng.sweep(sc.work_fn, sc.spec)) == want


@pytest.mark.parametrize("pkg", PACKAGES)
def test_warm_session_start_is_idempotent(pkg):
    eng = _engine(_pkg(pkg))
    try:
        assert eng.start() is eng and eng.start() is eng
        assert eng.session_active and eng._session_pool is None
    finally:
        eng.shutdown()
        eng.shutdown()
    assert not eng.session_active


# --- streaming ---------------------------------------------------------------
@pytest.mark.parametrize("stop_after", [None, 1, 4])
def test_serial_streams_match_reference(stop_after):
    """``sweep_iter`` and ``sweep_cells_iter`` (serial: grid order) yield
    the reference's items, and ``stop_after_feasible`` stops both after
    the same item."""
    def stop(p):
        return None if stop_after is None else \
            p.core.stop_after_feasible(stop_after)

    sc_ref, sc = _sc(REF), _sc(PORT)
    want = _items(_engine(REF).sweep_iter(sc_ref.work_fn, sc_ref.spec,
                                          stop=stop(REF)))
    got = _items(_engine(PORT).sweep_iter(sc.work_fn, sc.spec,
                                          stop=stop(PORT)))
    assert got == want
    cells = sc.spec.grid()[::-1][:10]
    want = _items(_engine(REF).sweep_cells_iter(sc_ref.work_fn, cells,
                                                sc_ref.spec, stop=stop(REF)))
    got = _items(_engine(PORT).sweep_cells_iter(sc.work_fn, cells, sc.spec,
                                                stop=stop(PORT)))
    assert got == want
    if stop_after is not None:
        assert sum(1 for _, row in got if row and row["feasible"]) == \
            stop_after


@pytest.mark.parametrize("ctx", ["fork", "forkserver"])
def test_parallel_stream_delivers_every_index_once(ctx):
    want = dict(_items(_engine(REF).sweep_iter(_sc(REF).work_fn,
                                               _sc(REF).spec)))
    sc = _sc(PORT)
    eng = _engine(PORT, parallel=True, max_workers=2, mp_context=ctx)
    got = _items(eng.sweep_iter(sc.work_fn, sc.spec))
    assert sorted(i for i, _ in got) == list(range(len(sc.spec.grid())))
    assert dict(got) == want
    stopped = _items(eng.sweep_iter(sc.work_fn, sc.spec,
                                    stop=PORT.core.stop_after_feasible(3)))
    assert sum(1 for _, row in stopped if row and row["feasible"]) == 3
    assert all(want[i] == row for i, row in stopped)


# --- baselines and the shared tier -------------------------------------------
@pytest.mark.parametrize("mode", ["perpoint", "uncached"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_baselines_match_reference(name, mode):
    kwargs = {"phased": "perpoint" not in mode,
              "use_cache": "uncached" not in mode}
    want = _reference_rows(name, **kwargs)
    sc = _sc(PORT, name)
    got = _exact(p.row() for p in _engine(PORT, **kwargs).sweep(sc.work_fn,
                                                                  sc.spec))
    assert got == want
    if not kwargs["use_cache"]:
        assert port_core.cache_stats().entries == 0


@pytest.mark.parametrize("shared", [True, "mmap", "server"])
def test_shared_cache_parallel_sweeps_match_reference(shared):
    want = _reference_rows()
    sc = _sc(PORT)
    for phased in (True, False):
        eng = _engine(PORT, parallel=True, max_workers=2,
                      mp_context="forkserver", shared_cache=shared,
                      phased=phased)
        assert _exact(p.row() for p in eng.sweep(sc.work_fn, sc.spec)) \
            == want
        stats = eng.last_shared_stats
        assert stats["backend"] == ("server" if shared == "server"
                                    else "mmap")
        assert stats["inserts"] > 0 and GLOBAL_CACHE.shared is None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_diff_stats_reports_request_deltas(pkg):
    diff_stats = _pkg(pkg).memo_store.diff_stats
    before = {"backend": "mmap", "hits": 2, "misses": 5, "inserts": 5,
              "dropped": 0, "entries": 5,
              "by_space": {"plan": {"hits": 2, "misses": 5, "inserts": 5,
                                    "dropped": 0}}}
    after = {"backend": "mmap", "hits": 9, "misses": 6, "inserts": 6,
             "dropped": 0, "entries": 6,
             "by_space": {"plan": {"hits": 9, "misses": 6, "inserts": 6,
                                   "dropped": 0}}}
    delta = diff_stats(before, after)
    assert delta["hits"] == 7 and delta["entries"] == 1
    assert delta["by_space"]["plan"]["hits"] == 7
    assert diff_stats(None, after) is after
    assert diff_stats(before, None) is None


# --- protocol ----------------------------------------------------------------
MALFORMED = [
    ({"op": "query", "mode": "warp"}, "bad-mode", False),
    ({"op": "query", "budget": 0}, "bad-budget", False),
    ({"op": "query", "cells": [1, 1]}, "bad-cells", False),
    ({"op": "query", "frobnicate": 1}, "bad-field", False),
    ({"op": "query", "workload_scale": -1}, "bad-scale", False),
    ({"op": "query", "scenario": "nope"}, "unknown-scenario", True),
    ({"op": "query", "cells": [10 ** 6]}, "bad-cells", True),
    ({"op": "query", "mode": "search", "policy": "psychic"},
     "unknown-policy", True),
    ({"op": "query", "dense": {"n_chips": "many", "bogus": 1}},
     "bad-dense", True),
]


@pytest.mark.parametrize("msg, code, at_resolve", MALFORMED)
def test_parse_query_refuses_as_the_reference(msg, code, at_resolve):
    errors = []
    for p in (REF, PORT):
        with pytest.raises(p.protocol.RequestError) as exc:
            q = p.protocol.parse_query(dict(msg))
            assert at_resolve
            p.protocol.resolve_query(q)
        errors.append((exc.value.code, str(exc.value)))
    assert errors[0] == errors[1] and errors[1][0] == code


# --- the daemon, held against the reference's ---------------------------------
def _two_clients(p, svc, a_cells, b_cells) -> dict:
    results: dict = {}

    def run(name, cells):
        with p.service.DSEClient(svc.path) as cli:
            results[name] = cli.sweep(scenario="llm", smoke=True,
                                      cells=cells, client=name)

    threads = [threading.Thread(target=run, args=("A", a_cells)),
               threading.Thread(target=run, args=("B", b_cells))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return results


def _reply_rows(reply) -> dict:
    return {i: None if pt is None else _exact_row(pt.row())
            for i, pt in zip(reply.indices, reply.points)}


def _winner(summary: dict) -> dict:
    w = dict(summary["winner"])
    w["iter_time"] = w["iter_time"].hex()
    w["row"] = None if w["row"] is None else _exact_row(w["row"])
    return w


@pytest.mark.parametrize("rank", ["off", "on"])
def test_daemon_answers_as_the_reference(rank):
    """Two clients with 6 overlapping cells on the 18-cell llm smoke grid,
    then a search (halving) and a reprice request: rows, dedup hits,
    search replies and reprice reports equal the reference daemon's."""
    n = len(_sc(PORT).spec.grid())
    a_cells, b_cells = list(range(0, 2 * n // 3)), list(range(n // 3, n))
    overlap = len(set(a_cells) & set(b_cells))
    assert (n, overlap) == (18, 6)
    out = {}
    for p in (REF, PORT):
        with _service(p, rank=rank) as svc:
            clients = _two_clients(p, svc, a_cells, b_cells)
            with p.service.DSEClient(svc.path) as cli:
                sched = cli.stats()["scheduler"]
                search = cli.search(scenario="llm", smoke=True,
                                    policy="halving")
                reprice = cli.reprice(scenario="llm", smoke=True)
                stats = cli.stats()
        out[p.name] = (clients, sched, search, reprice, stats)
    (rc, rs, rsearch, rrep, rstats) = out["repro"]
    (pc, ps, psearch, prep, pstats) = out["repro_torch"]
    for name in ("A", "B"):
        assert _reply_rows(pc[name]) == _reply_rows(rc[name])
        assert _winner(pc[name].summary) == _winner(rc[name].summary)
    assert ps["cells_priced"] == rs["cells_priced"] == n
    assert ps["dedup_hits"] == rs["dedup_hits"] == overlap
    assert (pc["A"].summary["dedup_hits"] + pc["B"].summary["dedup_hits"]
            == overlap)
    keys = ("mode", "policy", "budget", "evals_used", "cheap_evals",
            "certified", "oracle_index", "best_index")
    assert {k: psearch.summary[k] for k in keys} == \
        {k: rsearch.summary[k] for k in keys}
    assert psearch.summary["certified"] is True
    assert _winner(psearch.summary) == _winner(rsearch.summary)
    assert [_reply_rows(psearch)] == [_reply_rows(rsearch)]
    keys = ("cells", "groups", "empty_groups", "enumerated", "rank",
            "survived", "rank_survived", "priced_rows", "chunk_rows",
            "chunks", "winners_identical")
    assert {k: prep[k] for k in keys} == {k: rrep[k] for k in keys}
    assert prep["backend"] == "kernel"
    assert pstats["engine"]["device"] == "cpu"
    assert pstats["engine"]["rank_model"] == rstats["engine"]["rank_model"]
    assert pstats["scheduler"] == rstats["scheduler"]


def test_daemon_refuses_malformed_queries_as_the_reference():
    codes = {}
    for p in (REF, PORT):
        got = []
        with _service(p) as svc, p.service.DSEClient(svc.path) as cli:
            for fields in ({"scenario": "not-a-scenario"}, {"mode": "warp"},
                           {"budget": -3}, {"cells": [5, 5]},
                           {"policy": "psychic", "mode": "search"}):
                with pytest.raises(p.service.ServiceError) as exc:
                    list(cli.query_iter(**fields))
                got.append((exc.value.code, str(exc.value)))
            with pytest.raises(p.service.ServiceError) as exc:
                cli._roundtrip({"op": "frobnicate"})
            got.append((exc.value.code, str(exc.value)))
            assert cli.ping()["kind"] == "pong"
        codes[p.name] = got
    assert codes["repro_torch"] == codes["repro"]


@pytest.fixture(scope="module", params=PACKAGES)
def service(request):
    p = _pkg(request.param)
    with _service(p) as svc:
        yield p, svc


def test_repeat_request_served_from_memo(service):
    p, svc = service
    with p.service.DSEClient(svc.path) as cli:
        first = cli.sweep(scenario="llm", smoke=True)
        before = cli.stats()["scheduler"]["cells_priced"]
        again = cli.sweep(scenario="llm", smoke=True)
        after = cli.stats()["scheduler"]["cells_priced"]
    assert after == before
    assert again.summary["dedup_hits"] == again.summary["rows"]
    assert _exact(again.rows()) == _exact(first.rows()) == _reference_rows()


def test_client_disconnect_and_garbage_frame_leave_daemon_serving(service):
    p, svc = service
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(svc.path)
    p.memo_store.send_msg(sock, {"op": "query", "mode": "sweep",
                                 "scenario": "llm", "smoke": True,
                                 "client": "rude"})
    assert p.memo_store.recv_msg(sock) is not None
    sock.close()
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(svc.path)
    payload = b"this is not a pickle"
    sock.sendall(struct.pack("<Q", len(payload)) + payload)
    reply = p.memo_store.recv_msg(sock)
    assert reply["kind"] == "error" and reply["code"] == "bad-frame"
    sock.close()
    with p.service.DSEClient(svc.path) as cli:
        rep = cli.sweep(scenario="llm", smoke=True)
        assert rep.summary["rows"] == len(_sc(p).spec.grid())
        st = cli.stats()
        assert st["engine"]["session_active"] is True
        assert cli.ping()["kind"] == "pong"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_budget_bounds_fresh_prices_and_reports_skips(pkg):
    p = _pkg(pkg)
    n = len(_sc(p).spec.grid())
    with _service(p) as svc, p.service.DSEClient(svc.path) as cli:
        rep = cli.sweep(scenario="llm", smoke=True, budget=3)
        sched = cli.stats()["scheduler"]
    assert rep.summary["budget_used"] == 3 == sched["cells_priced"]
    assert rep.summary["skipped"] == n - 3 and rep.summary["rows"] == 3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_shutdown_op_stops_daemon(pkg):
    p = _pkg(pkg)
    svc = _service(p)
    svc.start()
    with p.service.DSEClient(svc.path) as cli:
        cli.shutdown_server()
    assert svc.wait(timeout=10)
    svc.close()
    assert not os.path.exists(svc.path)
    with pytest.raises((FileNotFoundError, ConnectionRefusedError)):
        p.service.DSEClient(svc.path, connect_timeout=0.2)


# --- the card by default -------------------------------------------------------
def test_daemon_prices_on_the_card_unless_given_a_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = PORT.service.DSEService(parallel=False, pricing_backend="kernel")
    assert svc.engine.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.start()
    assert not svc.engine.session_active and not os.path.exists(svc.path)
    svc.close()
    # numpy pricing never touches a device
    with PORT.service.DSEService(parallel=False,
                                 pricing_backend="numpy") as svc:
        with PORT.service.DSEClient(svc.path) as cli:
            assert cli.ping()["kind"] == "pong"


def test_cli_serves_with_device_cpu():
    """``python -m repro_torch.service --device cpu`` serves on the CPU:
    rank ``auto`` is off, rows are the reference's, shutdown is clean."""
    tmp = tempfile.mkdtemp(prefix="dfm-t-")
    path = os.path.join(tmp, "d.sock")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                 if x]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "--device", "cpu",
         "--workers", "1", "--socket", path, "--rank", "auto"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == \
            f"dse-service: serving on {path}"
        with PORT.service.DSEClient(path) as cli:
            st = cli.stats()
            assert st["engine"]["device"] == "cpu"
            assert st["engine"]["pricing_backend"] == "auto"
            rep = cli.sweep(scenario="llm", smoke=True, cells=[0, 1, 2])
            assert cli.stats()["engine"]["rank_model"] is False
            cli.shutdown_server()
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
        want = dict(_items(_engine(REF).sweep_cells_iter(
            _sc(REF).work_fn, _sc(REF).spec.grid()[:3], _sc(REF).spec)))
        assert _reply_rows(rep) == want
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
