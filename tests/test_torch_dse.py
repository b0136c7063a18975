"""The port's DSE engine against the JAX package's reference engine.

``repro_torch.core.DSEEngine`` on the CPU (``device="cpu"``: the kernel
backends run their plain versions) must reproduce the rows of
``repro.core.DSEEngine`` on the numpy backend bit for bit (every float
compared through ``float.hex``), on all seven smoke scenarios, for each of
the port's backends, with candidate pruning on and off; ``reprice_grid``
must report the reference's counts and certify the same winners; and one
parallel sweep must match too.
"""
from __future__ import annotations

import dataclasses
import functools

import pytest

from repro.core import DSEEngine as RefEngine
from repro.search.grid import DenseGridSpec as RefDenseGridSpec
from repro.workloads.scenarios import get_scenario as ref_scenario
from repro.workloads.scenarios import scenario_names
from repro_torch.core import DSEEngine
from repro_torch.search import DenseGridSpec
from repro_torch.workloads.scenarios import get_scenario

BACKENDS = ("numpy", "torch", "kernel", "kernel-f32")
SCENARIOS = ("llm", "dlrm", "hpl", "fft", "moe", "mamba2", "serving")
# a small dense grid: 1 chip x 2 scales x 2 memories x 2 scales x 1 net x
# 2 topologies = 16 cells in 4 name-groups
DENSE = dict(n_chips=16, base_chips=("H100",), chip_scales=(1.0, 1.25),
             base_memories=("DDR", "HBM"), memory_scales=(0.75, 1.0),
             base_nets=("PCIe",), net_scales=(1.0,),
             topologies=("torus2d", "dragonfly"))


def _exact(rows: list[dict]) -> list[dict]:
    """Rows with every float replaced by its exact hex spelling."""
    return [{k: v.hex() if isinstance(v, float) else v for k, v in r.items()}
            for r in rows]


@functools.lru_cache(maxsize=None)
def _reference_rows(name: str, prune: str) -> list[dict]:
    engine = RefEngine(parallel=False, pricing_backend="numpy", prune=prune)
    return _exact(engine.sweep_scenario(name, smoke=True).rows())


def test_port_has_the_reference_scenarios():
    assert tuple(scenario_names()) == SCENARIOS


@pytest.mark.parametrize("prune", ["on", "off"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SCENARIOS)
def test_sweep_rows_identical_to_reference(name, backend, prune):
    engine = DSEEngine(parallel=False, pricing_backend=backend, prune=prune,
                       device="cpu")
    rows = _exact(engine.sweep_scenario(name, smoke=True).rows())
    assert rows and rows == _reference_rows(name, prune)
    if backend == "kernel-f32":
        assert engine.last_drift_stats["max_iter_drift"] <= 1e-5


@pytest.mark.parametrize("backend", BACKENDS)
def test_reprice_grid_matches_reference_report(backend):
    ref_spec = RefDenseGridSpec(**DENSE).spec()
    spec = DenseGridSpec(**DENSE).spec()
    assert spec.grid() == ref_spec.grid()
    work = ref_scenario("llm", smoke=True).work_fn
    want = RefEngine(parallel=False, pricing_backend="numpy",
                     price_chunk_rows=8).reprice_grid(work, ref_spec)
    engine = DSEEngine(parallel=False, pricing_backend=backend,
                       price_chunk_rows=8, device="cpu")
    got = engine.reprice_grid(get_scenario("llm", smoke=True).work_fn, spec)
    keys = ("cells", "groups", "empty_groups", "enumerated", "survived",
            "rank_survived", "priced_rows", "chunk_rows", "chunks")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["winners_identical"] is True and got["chunks"] > 1
    assert (got["drift"] is None) == (backend != "kernel-f32")
    # the winners the grid certifies are the reference sweep's
    ref_rows = RefEngine(parallel=False, pricing_backend="numpy").sweep(
        work, ref_spec)
    rows = DSEEngine(parallel=False, pricing_backend=backend,
                     device="cpu").sweep(
        get_scenario("llm", smoke=True).work_fn, spec)
    assert _exact([p.row() for p in rows]) == _exact(
        [p.row() for p in ref_rows])


@pytest.mark.parametrize("phased", [True, False])
@pytest.mark.parametrize("name", ["llm", "hpl"])
def test_module_sweep_matches_reference(name, phased):
    # dse.sweep: the batched plan/price path and the serial scalar path
    # (one evaluate_design_point per cell) both give the reference rows
    from repro_torch.core import sweep

    sc = get_scenario(name, smoke=True)
    fields = dataclasses.asdict(sc.spec)
    points = sweep(sc.work_fn, phased=phased, pricing_backend="kernel",
                   device="cpu", **fields)
    rows = _exact([{"workload": name, **p.row()} for p in points])
    assert rows == _reference_rows(name, "on")


def test_memo_cache_serves_a_repeated_sweep():
    from repro_torch.core import cache_stats, clear_caches

    clear_caches()
    engine = DSEEngine(parallel=False, pricing_backend="numpy", device="cpu")
    cold = _exact(engine.sweep_scenario("llm", smoke=True).rows())
    first = cache_stats()
    warm = _exact(engine.sweep_scenario("llm", smoke=True).rows())
    second = cache_stats()
    assert cold == warm == _reference_rows("llm", "on")
    assert first.misses > 0 and first.entries > 0
    assert second.misses == first.misses and second.hits > first.hits
    clear_caches()
    assert cache_stats().entries == 0


def test_parallel_sweep_matches_reference():
    engine = DSEEngine(parallel=True, max_workers=2, pricing_backend="kernel",
                       device="cpu", mp_context="forkserver")
    rows = _exact(engine.sweep_scenario("llm", smoke=True).rows())
    assert rows == _reference_rows("llm", "on")
    stats = engine.last_plan_stats
    assert stats["backend"] == "kernel" and stats["verified"]
    assert stats["priced"] == stats["survived"] < stats["enumerated"]


def test_start_method_avoids_fork_once_cuda_is_initialized(monkeypatch):
    import repro_torch.core.dse_engine as dse_engine

    engine = DSEEngine(device="cpu")
    monkeypatch.setattr(dse_engine, "_cuda_initialized", lambda: False)
    assert engine._start_method() == "fork"
    monkeypatch.setattr(dse_engine, "_cuda_initialized", lambda: True)
    assert engine._start_method() == "forkserver"
    assert DSEEngine(mp_context="spawn")._start_method() == "spawn"
