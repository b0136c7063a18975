"""The port's budgeted search against the JAX package's reference.

``repro_torch.search`` (the three policies, the surrogate and the
memo-store harvest) and ``DSEEngine.search`` on the CPU (``device="cpu"``)
must reproduce ``repro``'s at zero tolerance: every policy on the llm
smoke grid and on every smoke scenario, and ``halving`` on the 864-cell
``DenseGridSpec()``, end certified with the same ``best_index``,
``oracle_index``, ``evals_used``, ``cheap_evals`` and the same best of
every round. Reference tests that hold for both packages run once per
package; proposal-contract violations raise as in the reference. Each test
starts and ends with fresh caches in both packages.
"""
from __future__ import annotations

import importlib
import math
import types

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core

PACKAGES = ("repro", "repro_torch")
SCENARIOS = ("llm", "dlrm", "hpl", "fft", "moe", "mamba2", "serving")
POLICIES = ("random", "halving", "surrogate")


def _pkg(name: str) -> types.SimpleNamespace:
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, core=mod("core"), memo=mod("core.memo"),
        memo_store=mod("core.memo_store"), search=mod("search"),
        surrogate=mod("search.surrogate"), chips=mod("systems.chips"),
        llm=mod("workloads.llm"), scenarios=mod("workloads.scenarios"))


REF, PORT = _pkg("repro"), _pkg("repro_torch")


# module-level so the workload builders are picklable
def _ref_tiny_work(system):
    return REF.llm.gpt_workload(REF.llm.LLAMA_68M, global_batch=64,
                                microbatch=1)


def _port_tiny_work(system):
    return PORT.llm.gpt_workload(PORT.llm.LLAMA_68M, global_batch=64,
                                 microbatch=1)


def _tiny(p):
    return _ref_tiny_work if p.name == "repro" else _port_tiny_work


def _smoke_spec(p):
    return p.core.SweepSpec(n_chips=16, chips=("H100", "SN30"),
                            topologies=("torus2d", "dgx2"),
                            mem_net=(("DDR", "PCIe"), ("HBM", "NVLink")),
                            max_tp=16)


def _engine(p, **kwargs):
    kwargs.setdefault("parallel", False)
    if p.name == "repro_torch":
        kwargs.setdefault("device", "cpu")
    return p.core.DSEEngine(**kwargs)


def _policy(p, name: str, n: int):
    """One shipped policy and its certification budget (as the reference's
    own search tests use them)."""
    s = p.search
    if name == "random":
        return s.RandomSearch(seed=0, batch_size=8), n
    if name == "halving":
        return s.SuccessiveHalving(eta=4), max(1, math.ceil(n / 4))
    return s.SurrogateSearch(seed=0, batch_size=6, min_train=6), n


def _summary(res) -> dict:
    """What must agree between the packages, floats spelled exactly."""
    rounds = [(r["round"], r["asked"], r["evals"], r["best_index"],
               r["best_iter_time"].hex(), r["best_feasible"])
              for r in res.rounds]
    return {"policy": res.policy, "budget": res.budget,
            "evals_used": res.evals_used, "cheap_evals": res.cheap_evals,
            "best_index": res.best_index, "oracle_index": res.oracle_index,
            "certified": res.certified, "order": list(res.evaluated),
            "rounds": rounds,
            "best_row": {k: v.hex() if isinstance(v, float) else v
                         for k, v in res.best_point.row().items()}}


@pytest.fixture(autouse=True)
def _fresh_caches():
    ref_core.clear_caches()
    port_core.clear_caches()
    yield
    ref_core.clear_caches()
    port_core.clear_caches()


# --- certified policies, held against the reference --------------------------
@pytest.mark.parametrize("backend", ["numpy", "kernel", "kernel-f32"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_on_llm_smoke_grid_matches_reference(policy, backend):
    sc_ref = REF.scenarios.get_scenario("llm", smoke=True)
    sc = PORT.scenarios.get_scenario("llm", smoke=True)
    n = len(sc.spec.grid())
    pol, budget = _policy(REF, policy, n)
    want = _engine(REF).search(sc_ref.work_fn, sc_ref.spec, policy=pol,
                               budget=budget)
    pol, budget = _policy(PORT, policy, n)
    got = _engine(PORT, pricing_backend=backend).search(
        sc.work_fn, sc.spec, policy=pol, budget=budget)
    assert got.certified and got.best_index == got.oracle_index
    assert _summary(got) == _summary(want)


@pytest.mark.parametrize("name", SCENARIOS)
def test_every_policy_certifies_on_every_smoke_scenario(name):
    sc_ref = REF.scenarios.get_scenario(name, smoke=True)
    sc = PORT.scenarios.get_scenario(name, smoke=True)
    n = len(sc.spec.grid())
    for policy in POLICIES:
        pol, budget = _policy(REF, policy, n)
        want = _engine(REF).search(sc_ref.work_fn, sc_ref.spec, policy=pol,
                                   budget=budget)
        pol, budget = _policy(PORT, policy, n)
        got = _engine(PORT, pricing_backend="kernel").search(
            sc.work_fn, sc.spec, policy=pol, budget=budget)
        assert got.certified and got.best_index == got.oracle_index
        assert got.evals_used <= got.budget <= n
        assert _summary(got) == _summary(want), (name, policy)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_halving_on_dense_grid_matches_reference(backend):
    """The reference's dense search case: a certified winner on the
    864-cell grid with at most a fifth of the exhaustive evaluations."""
    spec_ref = REF.search.DenseGridSpec().spec()
    spec = PORT.search.DenseGridSpec().spec()
    n = len(spec.grid())
    assert spec.grid() == spec_ref.grid() and n == 864
    want = _engine(REF).search(_ref_tiny_work, spec_ref,
                               policy=REF.search.SuccessiveHalving(eta=8),
                               budget=n // 5)
    got = _engine(PORT, pricing_backend=backend).search(
        _port_tiny_work, spec, policy=PORT.search.SuccessiveHalving(eta=8),
        budget=n // 5)
    assert got.certified and got.best_index == got.oracle_index
    assert got.evals_used / n <= 0.2 and got.cheap_evals == n
    assert _summary(got) == _summary(want)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_halving_budget_one_still_finds_argmin(pkg):
    p = _pkg(pkg)
    res = _engine(p).search(_tiny(p), _smoke_spec(p),
                            policy=p.search.SuccessiveHalving(eta=4),
                            budget=1)
    assert res.certified and res.evals_used == 1
    assert res.best_index == res.oracle_index


@pytest.mark.parametrize("pkg", PACKAGES)
def test_search_result_bookkeeping(pkg):
    p = _pkg(pkg)
    spec = _smoke_spec(p)
    n = len(spec.grid())
    seen = []
    res = _engine(p).search(_tiny(p), spec,
                            policy=p.search.RandomSearch(seed=1,
                                                         batch_size=3),
                            budget=n, progress=seen.append)
    assert res.evals_used == n == len(res.evaluated)
    assert res.rounds == seen
    assert [r["round"] for r in res.rounds] == list(
        range(1, len(res.rounds) + 1))
    assert res.rounds[-1]["evals"] == n and res.rounds[-1]["eta_s"] == 0.0
    best = res.evaluated[res.best_index]
    assert res.best_objective == (best.feasible, best.iter_time)
    assert res.best_point is best.point


def test_same_seed_same_sequence_as_reference():
    """Seeded determinism, across packages: the port's policies propose
    the reference's sequence for the same seed."""
    n = len(_smoke_spec(PORT).grid())
    for make in (lambda s, seed: s.RandomSearch(seed=seed, batch_size=4),
                 lambda s, seed: s.SurrogateSearch(seed=seed, batch_size=4,
                                                   min_train=4)):
        for seed in (5, 6):
            want = _engine(REF).search(_ref_tiny_work, _smoke_spec(REF),
                                       policy=make(REF.search, seed),
                                       budget=n, certify=False)
            got = _engine(PORT).search(_port_tiny_work, _smoke_spec(PORT),
                                       policy=make(PORT.search, seed),
                                       budget=n, certify=False)
            assert list(got.evaluated) == list(want.evaluated)
            assert got.best_index == want.best_index
            assert got.best_objective == want.best_objective


# --- exactly-once budget accounting ------------------------------------------
def _misbehaving(p, proposals):
    class Misbehaving(p.search.SearchPolicy):
        name = "misbehaving"

        def __init__(self):
            self._proposals = [list(x) for x in proposals]

        def ask(self):
            return self._proposals.pop(0) if self._proposals else []

    return Misbehaving()


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("proposals, msg", [
    ([[0, 1], [1, 2]], "more than once"),
    ([[3, 3]], "more than once"),
    ([[99]], "out-of-range"),
    ([[-1]], "out-of-range"),
    ([[0, 1, 2], [3, 4, 5]], "exceeded the evaluation budget"),
])
def test_contract_violations_raise(pkg, proposals, msg):
    p = _pkg(pkg)
    with pytest.raises(RuntimeError, match=msg) as exc:
        _engine(p).search(_tiny(p), _smoke_spec(p),
                          policy=_misbehaving(p, proposals), budget=4,
                          certify=False)
    if p.name == "repro_torch":
        with pytest.raises(RuntimeError) as ref_exc:
            _engine(REF).search(_ref_tiny_work, _smoke_spec(REF),
                                policy=_misbehaving(REF, proposals),
                                budget=4, certify=False)
        assert str(exc.value) == str(ref_exc.value)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_budget_clamped_validated_and_empty_ask(pkg):
    p = _pkg(pkg)
    spec = _smoke_spec(p)
    n = len(spec.grid())
    res = _engine(p).search(_tiny(p), spec, policy=p.search.RandomSearch(),
                            budget=10 * n, certify=False)
    assert res.budget == n and res.evals_used == n
    with pytest.raises(ValueError, match="budget"):
        _engine(p).search(_tiny(p), spec, policy=p.search.RandomSearch(),
                          budget=0)
    res = _engine(p).search(_tiny(p), spec,
                            policy=_misbehaving(p, [[0, 1]]), budget=6,
                            certify=False)
    assert res.evals_used == 2 and res.best_index in (0, 1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cheap_bound_matches_full_pricing(pkg):
    """The cheap bound is the exact objective prefix of full pricing —
    the property halving's single promotion round rests on."""
    p = _pkg(pkg)
    spec = _smoke_spec(p)
    grid = spec.grid()
    captured = {}

    class Capture(p.search.SearchPolicy):
        name = "capture"

        def reset(self, ctx):
            super().reset(ctx)
            captured["bounds"] = ctx.cheap_bound(range(ctx.n_points))

        def ask(self):
            if captured.get("asked"):
                return []
            captured["asked"] = True
            return list(range(self.ctx.n_points))

    kwargs = {"pricing_backend": "kernel"} if p.name == "repro_torch" else {}
    res = _engine(p, **kwargs).search(_tiny(p), spec, policy=Capture(),
                                      budget=len(grid))
    for i, (infeasible, lb) in enumerate(captured["bounds"]):
        obs = res.evaluated[i]
        assert infeasible == (not obs.feasible)
        if obs.point is not None:
            assert lb == obs.iter_time
    assert res.cheap_evals == len(grid)


# --- surrogate internals and the harvest -------------------------------------
@pytest.mark.parametrize("pkg", PACKAGES)
def test_ridge_and_cell_features(pkg):
    p = _pkg(pkg)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 3))
    y = X @ [2.0, -1.0, 0.5] + 3.0
    model = p.surrogate.RidgeModel.fit(X, y, lam=1e-8)
    assert np.allclose(model.predict(X), y, atol=1e-6)
    np.testing.assert_array_equal(
        model.beta, REF.surrogate.RidgeModel.fit(X, y, lam=1e-8).beta)
    vocab = {"torus2d": 0, "dgx2": 1}
    for cell in (("H100", "HBM", "NVLink", "dgx2"),
                 ("H100@x2", "HBM@x0.5", "NVLink@x1.5", "torus2d")):
        np.testing.assert_array_equal(
            p.search.cell_features(cell, 64, vocab),
            REF.search.cell_features(cell, 64, vocab))
    with pytest.raises(ValueError, match="explore"):
        p.search.SurrogateSearch(explore=1.5)
    bad = p.search.SurrogateSearch(warm_start=(np.zeros((2, 3)),
                                               np.zeros(2)))
    with pytest.raises(ValueError, match="warm_start"):
        _engine(p).search(_tiny(p), _smoke_spec(p), policy=bad, budget=4,
                          certify=False)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_harvest_local_and_shared_entries(pkg):
    p = _pkg(pkg)
    cache = p.memo.SolveCache()
    cache.get_or_compute("spacex", ("a",), lambda: 1)
    cache.get_or_compute("spacex", ("b",), lambda: 2)
    cache.get_or_compute("other", ("a",), lambda: 3)
    assert sorted(cache.harvest("spacex")) == [(("a",), 1), (("b",), 2)]
    assert cache.harvest("empty") == []
    store = p.memo_store.MmapStore()
    try:
        writer = p.memo.SolveCache()
        writer.attach_shared(store)
        writer.get_or_compute("spacex", ("k",), lambda: 42)
        reader = p.memo.SolveCache()
        reader.attach_shared(store)
        assert reader.harvest("spacex") == [(("k",), 42)]
        assert writer.harvest("spacex") == [(("k",), 42)]
    finally:
        store.close()


def test_plan_feature_rows_and_ridge_match_reference():
    assert PORT.surrogate.plan_feature_rows()[0].shape == (
        0, len(PORT.surrogate.PLAN_FEATURE_FIELDS))
    assert PORT.surrogate.fit_plan_ridge() is None
    for p in (REF, PORT):
        spec = _smoke_spec(p)
        _engine(p).search(_tiny(p), spec, policy=p.search.RandomSearch(),
                          budget=len(spec.grid()), certify=False)
    rx, ry = REF.surrogate.plan_feature_rows()
    px, py = PORT.surrogate.plan_feature_rows()
    assert len(px) == len(py) > 0
    np.testing.assert_array_equal(px, rx)
    np.testing.assert_array_equal(py, ry)
    np.testing.assert_array_equal(PORT.surrogate.fit_plan_ridge().beta,
                                  REF.surrogate.fit_plan_ridge().beta)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_make_policy_names(pkg):
    p = _pkg(pkg)
    assert p.search.POLICY_NAMES == POLICIES
    for name in POLICIES:
        assert p.search.make_policy(name, batch_size=5).name == name
    with pytest.raises(ValueError, match="unknown search policy"):
        p.search.make_policy("psychic")
