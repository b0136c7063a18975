"""The port's learned rank stage against the JAX package's reference.

``repro_torch.learned`` and the rank stage of the port's pipeline
(``prune_matrix`` → ``select_candidates`` → ``plan_design_groups`` →
``DSEEngine(rank="on")``) on the CPU (``device="cpu"``: the kernel
backends run their plain versions) must reproduce ``repro``'s at zero
tolerance: the same seven smoke sweeps leave bit-identical harvests and
fit identical rankers (BENCH_dse.json's reference figures: 2352 training
rows, 84 groups, recall 0.952), every scenario keeps the same rank
survivors and rank-on rows equal rank-off rows, and the dense grid's
``reprice_grid`` ranks 8256 → 3460 → 879 rows as the reference does.
Reference tests that hold for both packages run once per package. Each
test starts and ends with fresh caches in both packages.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import types

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core

PACKAGES = ("repro", "repro_torch")
BACKENDS = ("numpy", "torch", "kernel", "kernel-f32")
SCENARIOS = ("llm", "dlrm", "hpl", "fft", "moe", "mamba2", "serving")


def _pkg(name: str) -> types.SimpleNamespace:
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, core=mod("core"), dse=mod("core.dse"),
        interchip=mod("core.interchip"), memo=mod("core.memo"),
        learned=mod("learned"), rank=mod("learned.rank"),
        surrogate=mod("search.surrogate"), search=mod("search"),
        scenarios=mod("workloads.scenarios"))


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def _engine(pkg, **kwargs):
    kwargs.setdefault("parallel", False)
    kwargs.setdefault("prune", "on")
    if pkg.name == "repro_torch":
        kwargs.setdefault("device", "cpu")
    return pkg.core.DSEEngine(**kwargs)


def _exact(rows: list[dict]) -> list[dict]:
    """Rows with every float replaced by its exact hex spelling."""
    return [{k: v.hex() if isinstance(v, float) else v for k, v in r.items()}
            for r in rows]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64)).view(
        np.uint64)


def _warm(pkg, backend: str = "numpy") -> None:
    """The seven smoke sweeps, prune on: the ``candmat`` harvest."""
    eng = _engine(pkg, pricing_backend=backend)
    for name in SCENARIOS:
        eng.sweep_scenario(name, smoke=True)


@pytest.fixture(autouse=True)
def _fresh_caches():
    ref_core.clear_caches()
    port_core.clear_caches()
    yield
    ref_core.clear_caches()
    port_core.clear_caches()


def test_port_has_the_reference_scenarios():
    assert tuple(REF.scenarios.scenario_names()) == SCENARIOS
    assert tuple(PORT.scenarios.scenario_names()) == SCENARIOS
    assert PORT.learned.FEATURE_NAMES == REF.learned.FEATURE_NAMES


# ------------------------- harvest and fitted model --------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_harvest_and_ranker_identical_to_reference(backend):
    """The harvest holds candidate-level selection columns, numpy in every
    process whatever the pricing backend, so the port's features, targets,
    groups and fitted model equal the reference's bit for bit."""
    _warm(REF)
    _warm(PORT, backend)
    rx, ry, rg = REF.learned.harvest_rows()
    px, py, pg = PORT.learned.harvest_rows()
    assert px.shape == rx.shape and len(pg) == len(rg)
    np.testing.assert_array_equal(_bits(px), _bits(rx))
    np.testing.assert_array_equal(_bits(py), _bits(ry))
    assert [(s.start, s.stop) for s in pg] == [(s.start, s.stop) for s in rg]
    want, got = REF.learned.fit_ranker(), PORT.learned.fit_ranker()
    for field in ("beta", "mean", "std"):
        np.testing.assert_array_equal(_bits(getattr(got.ridge, field)),
                                      _bits(getattr(want.ridge, field)))
    assert (got.n_train, got.n_groups, got.keep_frac, got.recall,
            got.recall_target) == (want.n_train, want.n_groups,
                                   want.keep_frac, want.recall,
                                   want.recall_target)
    assert got.fingerprint == want.fingerprint
    # the reference figures BENCH_dse.json recorded for this flow
    assert (got.n_train, got.n_groups) == (2352, 84)
    assert round(got.recall, 3) == 0.952 and got.recall >= got.recall_target


@pytest.mark.parametrize("name", SCENARIOS)
def test_rank_on_survivors_and_rows_match_reference(name):
    """Per scenario: the reference's rank survivors on every port backend,
    and rank-on rows equal to rank-off rows (and to the reference's)."""
    _warm(REF)
    _warm(PORT)
    ref_on = _engine(REF, rank="on")
    ref_rows = _exact(ref_on.sweep_scenario(name, smoke=True).rows())
    want = ref_on.last_plan_stats
    assert want["rank"] is True
    off = _exact(_engine(PORT, rank="off").sweep_scenario(
        name, smoke=True).rows())
    assert off == ref_rows
    for backend in BACKENDS:
        eng = _engine(PORT, rank="on", pricing_backend=backend)
        rows = _exact(eng.sweep_scenario(name, smoke=True).rows())
        got = eng.last_plan_stats
        assert rows == off, (name, backend)
        assert got["rank"] is True, (name, backend)
        for key in ("enumerated", "survived", "rank_survived", "priced"):
            assert got[key] == want[key], (name, backend, key)
        assert got["rank_survived"] <= got["survived"]
        assert got["rank_keep_frac"] == eng._ranker.keep_frac


@functools.lru_cache(maxsize=None)
def _reference_dense_report() -> dict:
    """The reference's rank-on ``reprice_grid`` of ``DenseGridSpec()``
    after the seven smoke sweeps, from fresh caches."""
    ref_core.clear_caches()
    _warm(REF)
    report = _engine(REF, rank="on").reprice_grid(
        REF.scenarios.get_scenario("llm", smoke=True).work_fn,
        REF.search.DenseGridSpec().spec())
    ref_core.clear_caches()
    return report


@pytest.mark.parametrize("backend", ["numpy", "kernel", "kernel-f32"])
def test_dense_reprice_grid_rank_on_matches_reference(backend):
    want = _reference_dense_report()
    _warm(PORT)
    spec = PORT.search.DenseGridSpec().spec()
    assert spec.grid() == REF.search.DenseGridSpec().spec().grid()
    eng = _engine(PORT, rank="on", pricing_backend=backend)
    got = eng.reprice_grid(
        PORT.scenarios.get_scenario("llm", smoke=True).work_fn, spec)
    keys = ("cells", "groups", "enumerated", "rank", "survived",
            "rank_survived", "priced_rows", "chunks")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert (got["cells"], got["enumerated"], got["survived"],
            got["rank_survived"]) == (864, 8256, 3460, 879)
    assert got["winners_identical"] is True and got["rank"] is True
    assert got["rank_keep_frac"] == eng._ranker.keep_frac
    assert (got["drift"] is None) == (backend != "kernel-f32")


# ------------------------- keep-rule properties ------------------------------
def _random_group(rng, n):
    iter_time = rng.uniform(0.1, 10.0, size=n)
    iter_lb = iter_time * rng.uniform(0.2, 1.0, size=n)
    mem = rng.uniform(1.0, 100.0, size=n)
    caps = rng.uniform(1.0, 120.0, size=int(rng.integers(1, 4)))
    return iter_time, iter_lb, mem, caps


@pytest.mark.parametrize("pkg", PACKAGES)
def test_keep_rules_winner_preserving_and_identical(pkg):
    """bound_keep and rank_keep (under adversarial scores) keep every
    per-capacity scalar winner, and the port's masks equal the
    reference's on the same seeded groups."""
    p = _pkg(pkg)
    rng = np.random.default_rng(1)
    for _ in range(200):
        n = int(rng.integers(1, 40))
        iter_time, iter_lb, mem, caps = _random_group(rng, n)
        frac = float(rng.uniform(0.05, 1.0))
        bound = p.rank.bound_keep(iter_time, iter_lb, mem, caps)
        keep = p.rank.rank_keep(-iter_time, iter_time, iter_lb, mem, caps,
                                frac)
        np.testing.assert_array_equal(
            bound, REF.rank.bound_keep(iter_time, iter_lb, mem, caps))
        np.testing.assert_array_equal(
            keep, REF.rank.rank_keep(-iter_time, iter_time, iter_lb, mem,
                                     caps, frac))
        winners = p.interchip.scalar_winner_rows(iter_time, mem, caps)
        assert all(r >= 0 and bound[r] and keep[r] for r in winners)
        assert keep.sum() >= p.learned.rank_keep_count(n, frac) > 0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_rank_keep_count_and_policy_parsing(pkg):
    p = _pkg(pkg)
    assert p.learned.rank_keep_count(10, 0.25) == 3
    assert p.learned.rank_keep_count(3, 0.01) == 1
    assert p.rank.resolve_rank(True) is True
    assert p.rank.resolve_rank("off") is False
    assert p.rank.resolve_rank("on") is True
    with pytest.raises(ValueError, match="rank policy"):
        p.rank.resolve_rank("banana")
    with pytest.raises(ValueError, match="rank policy"):
        _engine(p, rank="banana")
    with pytest.raises(ValueError, match="rank_keep_frac"):
        _engine(p, rank="on", rank_keep_frac=1.5)


def test_port_reads_no_rank_environment(monkeypatch):
    """The reference reads DFMODEL_RANK / DFMODEL_RANK_KEEP_FRAC; the port
    takes arguments only: the same environment changes nothing there."""
    monkeypatch.setenv("DFMODEL_RANK", "on")
    monkeypatch.setenv("DFMODEL_RANK_KEEP_FRAC", "0.25")
    assert REF.rank.resolve_rank("auto") is True
    assert PORT.rank.resolve_rank("auto") is False
    assert not hasattr(PORT.learned, "RANK_ENV_VAR")
    assert not hasattr(PORT.learned, "RANK_KEEP_ENV_VAR")
    _warm(REF)
    _warm(PORT)
    ref_eng = _engine(REF)                       # rank="auto" → env → on
    ref_eng.sweep_scenario("llm", smoke=True)
    assert ref_eng.last_plan_stats["rank"] is True
    eng = _engine(PORT)                          # rank="auto" → off
    rows = _exact(eng.sweep_scenario("llm", smoke=True).rows())
    assert eng.last_plan_stats["rank"] is False
    assert eng.last_plan_stats["rank_survived"] == \
        eng.last_plan_stats["survived"]
    eng = _engine(PORT, rank="on")               # the keep fraction too
    assert _exact(eng.sweep_scenario("llm", smoke=True).rows()) == rows
    assert eng.last_plan_stats["rank_keep_frac"] == eng._ranker.keep_frac
    assert eng._ranker.keep_frac != 0.25


# ------------------------------ persistence ----------------------------------
def _synthetic_model(p, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(50, len(p.learned.FEATURE_NAMES)))
    y = rng.uniform(1.0, 2.0, size=50)
    return p.learned.LearnedModel(
        version=p.learned.FORMAT_VERSION,
        feature_names=p.learned.FEATURE_NAMES,
        ridge=p.surrogate.RidgeModel.fit(X, y), n_train=50, n_groups=2,
        recall_target=0.95, keep_frac=0.2, recall=1.0)


@pytest.mark.parametrize("writer", PACKAGES)
@pytest.mark.parametrize("reader", PACKAGES)
def test_model_save_load_roundtrip_across_packages(tmp_path, writer, reader):
    """The versioned np.savez format is the reference's: either package
    loads what either saved, scores unchanged."""
    model = _synthetic_model(_pkg(writer))
    path = str(tmp_path / "ranker.npz")
    model.save(path)
    back = _pkg(reader).learned.LearnedModel.load(path)
    assert back.fingerprint == model.fingerprint
    assert (back.keep_frac, back.recall, back.n_train, back.n_groups) == (
        model.keep_frac, model.recall, model.n_train, model.n_groups)
    X = np.random.default_rng(7).normal(
        size=(9, len(REF.learned.FEATURE_NAMES)))
    np.testing.assert_array_equal(back.score(X), model.score(X))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_model_load_refuses_version_mismatch(tmp_path, pkg):
    p = _pkg(pkg)
    path = str(tmp_path / "ranker.npz")
    dataclasses.replace(_synthetic_model(p),
                        version=p.learned.FORMAT_VERSION + 1).save(path)
    with pytest.raises(ValueError, match="format version"):
        p.learned.LearnedModel.load(path)


def test_rank_model_path_round_trip_and_staleness_guard(tmp_path):
    """A fit is saved to ``rank_model_path``; a cold engine loads it and
    ranks exactly as the warm one did; a missing or stale file (format
    version) leaves a cold engine rank-off."""
    path = str(tmp_path / "ranker.npz")
    _warm(PORT)
    warm = _engine(PORT, rank="on", rank_model_path=path)
    rows = _exact(warm.sweep_scenario("llm", smoke=True).rows())
    survived = warm.last_plan_stats["rank_survived"]
    fingerprint = warm._ranker.fingerprint
    port_core.clear_caches()                     # a cold process
    cold = _engine(PORT, rank="on", rank_model_path=path)
    assert _exact(cold.sweep_scenario("llm", smoke=True).rows()) == rows
    assert cold.last_plan_stats["rank"] is True
    assert cold._ranker.fingerprint == fingerprint
    assert cold.last_plan_stats["rank_survived"] == survived
    for name, model in (("missing.npz", None),
                        ("stale.npz", dataclasses.replace(
                            warm._ranker,
                            version=PORT.learned.FORMAT_VERSION + 1))):
        port_core.clear_caches()
        stale = str(tmp_path / name)
        if model is not None:
            model.save(stale)
        eng = _engine(PORT, rank="on", rank_model_path=stale)
        assert _exact(eng.sweep_scenario("llm", smoke=True).rows()) == rows
        assert eng.last_plan_stats["rank"] is False and eng._ranker is None


# ---------------------------- staleness guard --------------------------------
@pytest.mark.parametrize("pkg", PACKAGES)
def test_fit_ranker_staleness_guard(pkg):
    p = _pkg(pkg)
    assert p.learned.fit_ranker(p.memo.SolveCache()) is None
    with pytest.raises(ValueError, match="recall_target"):
        p.learned.fit_ranker(p.memo.SolveCache(), recall_target=1.5)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_engine_rank_on_degrades_to_off_when_cold(pkg):
    p = _pkg(pkg)
    eng = _engine(p, rank="on")
    res = eng.sweep_scenario("fft", smoke=True)
    assert res.points
    stats = eng.last_plan_stats
    assert stats["rank"] is False
    if pkg == "repro_torch":
        assert stats["rank_keep_frac"] is None
    assert stats["rank_survived"] == stats["survived"] == stats["priced"]


# ------------------------ certification (tamper test) ------------------------
@pytest.mark.parametrize("pkg", PACKAGES)
def test_certification_catches_ranker_that_drops_winner(monkeypatch, pkg):
    """A keep rule that drops the true argmin is caught by the sampled
    scalar certification inside plan_design_groups in both packages."""
    p = _pkg(pkg)

    def evil_rank_keep(scores, iter_time, iter_lb, mem, capacities,
                       keep_frac):
        keep = np.ones(len(scores), dtype=bool)
        for row in p.interchip.scalar_winner_rows(iter_time, mem,
                                                  capacities):
            if row >= 0:
                keep[row] = False
        if not keep.any():
            keep[0] = True
        return keep

    monkeypatch.setattr(f"{pkg}.learned.rank.rank_keep", evil_rank_keep)
    sc = p.scenarios.get_scenario("fft", smoke=True)
    with pytest.raises(RuntimeError, match="not winner-preserving"):
        p.dse.plan_design_groups(
            sc.work_fn, sc.spec.grid(), sc.spec.n_chips,
            max_tp=sc.spec.max_tp, max_pp=sc.spec.max_pp,
            execution=sc.spec.execution, prune="on", certify=True,
            ranker=_synthetic_model(p), rank_keep_frac=0.5)


# ----------------------- engine acceptance, pool -----------------------------
@pytest.mark.parametrize("ctx", ["fork", "forkserver"])
def test_rank_on_parallel_sweep_matches_reference(ctx):
    """The parent fits the ranker once and ships the frozen model to the
    workers: a parallel rank-on sweep on the kernel backend ranks and
    prices exactly as the reference's serial one."""
    _warm(REF)
    _warm(PORT)
    ref_eng = _engine(REF, rank="on")
    want = _exact(ref_eng.sweep_scenario("llm", smoke=True).rows())
    eng = _engine(PORT, parallel=True, max_workers=2, mp_context=ctx,
                  pricing_backend="kernel", rank="on")
    assert _exact(eng.sweep_scenario("llm", smoke=True).rows()) == want
    stats = eng.last_plan_stats
    assert stats["rank"] is True and stats["verified"]
    assert stats["rank_survived"] == ref_eng.last_plan_stats["rank_survived"]
    assert stats["rank_survived"] < stats["survived"]
