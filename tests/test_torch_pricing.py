"""The port's DSE pricing backends against the JAX package's reference.

The same seeded plan columns go through ``repro.core.pricing`` (the numpy
reference and its scalar transcription ``price_plan_scalar``) and through
the port's ``price_plans`` / ``batched_roofline`` on the CPU: the
``numpy`` and ``torch`` backends and the plain version of the ``kernel``
backend must be bit-identical (``uint64`` view; bool columns exact), and
the plain version of ``kernel-f32`` must stay within the drift band 1e-5
of the f64 reference, a ``feasible`` bit flipping only where the memory
footprint lies within the band of the capacity. The Pallas kernel runs in
interpret mode. The CUDA kernels themselves are held against these plain
versions on the card by tests/test_torch_gpu.py.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.experimental

# The reference kernel package imports ``jax.experimental.enable_x64``,
# which the installed jax no longer has (ROADMAP queue 3). Alias it at
# import time, so every test process sees the same alias.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import pricing as ref  # noqa: E402
from repro.kernels.pricing import pallas_columns  # noqa: E402
from repro_torch.core import DSEEngine  # noqa: E402
from repro_torch.core import pricing as port  # noqa: E402
from repro_torch.core.interchip import resolve_prune  # noqa: E402
from repro_torch.kernels import pricing_f32, pricing_f64  # noqa: E402
from repro_torch.kernels.pricing import (certify, certify_f32,  # noqa: E402
                                         drift_band)
from repro_torch.kernels.pricing.ops import f32_drift  # noqa: E402
from repro_torch.kernels.pricing.ref import (TorchXP,  # noqa: E402
                                             edge_plan_vectors,
                                             random_roofline_columns)

BAND = 1e-5
EXACT = ("numpy", "torch", "kernel")


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.astype(np.float64).view(np.uint64)


def _assert_identical(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)


def _vectors(seed: int):
    """Reference plan vectors: seeded random ones plus the finite edge rows
    (the port's, converted field for field)."""
    finite, _ = edge_plan_vectors()
    return (ref.random_plan_vectors(512, seed)
            + [ref.PlanVector(**dataclasses.asdict(v)) for v in finite])


def _scalar_columns(vectors) -> dict[str, np.ndarray]:
    rows = [ref.price_plan_scalar(v) for v in vectors]
    return {k: np.array([r[k] for r in rows]) for k in rows[0]}


@pytest.mark.parametrize("backend", EXACT)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_price_plans_bit_identical_to_reference(backend, seed):
    vectors = _vectors(seed)
    cols = ref.stack_plans(vectors)
    got = port.price_plans(cols, backend=backend, device="cpu")
    _assert_identical(got, _scalar_columns(vectors))
    _assert_identical(got, ref.price_plans(cols, backend="numpy"))


@pytest.mark.parametrize("backend", EXACT)
def test_special_rows_bit_identical_to_reference_numpy(backend):
    """NaN, ±inf and signed zeros: held against the numpy formula, whose
    ``maximum`` keeps -0.0 and propagates NaN (the scalar ``max`` does
    neither)."""
    _, special = edge_plan_vectors()
    cols = port.stack_plans(special)
    got = port.price_plans(cols, backend=backend, device="cpu")
    want = ref.price_plans(cols, backend="numpy")
    _assert_identical(got, want)
    assert np.isnan(got["iter_time"][0])
    assert np.signbit(got["frac_compute"][-1])


@pytest.mark.parametrize("backend", EXACT)
@pytest.mark.parametrize("seed", [0, 3])
def test_batched_roofline_bit_identical_to_reference(backend, seed):
    cols = random_roofline_columns(300, seed)
    got = port.batched_roofline(cols, backend=backend, device="cpu")
    _assert_identical(got, ref.batched_roofline(cols, backend="numpy"))


@pytest.mark.parametrize("formula", ["price", "roofline"])
def test_kernel_plain_version_matches_pallas_interpret(formula):
    if formula == "price":
        vectors = ref.random_plan_vectors(64, seed=4)
        cols = ref.stack_plans(vectors)
        got = port.price_plans(cols, backend="kernel", device="cpu")
        want = pallas_columns(ref._price, cols)
    else:
        cols = random_roofline_columns(64, seed=4)
        got = port.batched_roofline(cols, backend="kernel", device="cpu")
        want = pallas_columns(ref._roofline, cols)
    _assert_identical(got, want)


@pytest.mark.parametrize("seed", [0, 5])
def test_kernel_f32_plain_version_within_drift_band(seed):
    vectors = _vectors(seed)
    cols = ref.stack_plans(vectors)
    got = port.price_plans(cols, backend="kernel-f32", device="cpu")
    assert got["iter_time"].dtype == np.float32
    assert got["feasible"].dtype == np.bool_
    drifts = f32_drift(got, _scalar_columns(vectors), cols["mem_capacity"])
    assert drifts and max(drifts.values()) <= BAND, drifts
    report = certify_f32(n=512, seed=seed, device="cpu")
    assert report["within_band"] and report["max_drift"] <= BAND


def test_f32_drift_flags_non_finite_and_flips():
    want = {"x": np.array([1.0, np.nan, np.inf]),
            "feasible": np.array([True, True, False]),
            "per_chip_mem_bytes": np.array([10.0, 10.0, 20.0])}
    cap = np.array([10.0, 10.0, 10.0])
    good = {"x": np.array([1.0, np.nan, np.inf], np.float32),
            "feasible": np.array([True, False, False]),
            "per_chip_mem_bytes": np.array([10.0, 10.0, 20.0], np.float32)}
    drifts = f32_drift(good, want, cap)
    assert drifts["x"] == 0.0 and drifts["feasible_margin"] == 0.0
    bad = {"x": np.array([1.0, 2.0, -np.inf], np.float32),
           "feasible": np.array([True, True, True]),
           "per_chip_mem_bytes": good["per_chip_mem_bytes"]}
    drifts = f32_drift(bad, want, cap)
    assert drifts["x"] == np.inf and drifts["feasible_margin"] == 1.0


def test_certify_harness_on_the_plain_version():
    rep = certify(n=512, seed=0, device="cpu")
    assert rep["bit_identical"] and rep["outputs"] == 10


def test_numpy_maximum_minimum_rule_with_signed_zeros_and_nan():
    vals = np.array([0.0, -0.0, 1.0, -1.0, np.nan, np.inf, -np.inf])
    a, b = np.meshgrid(vals, vals)
    a, b = a.ravel(), b.ravel()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("maximum", "minimum"):
        want = getattr(np, name)(a, b)
        got = getattr(TorchXP, name)(ta, tb).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
        for scalar in (0.0, -0.0, 1.0):
            want = getattr(np, name)(scalar, b)
            got = getattr(TorchXP, name)(scalar, tb).numpy()
            np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.signbit(TorchXP.maximum(0.0, torch.tensor([-0.0])).item())
    assert not np.signbit(torch.maximum(torch.tensor(0.0),
                                        torch.tensor(-0.0)).item())


def test_backend_names_keep_the_reference_semantics():
    assert port.BACKENDS == ("numpy", "torch", "kernel", "kernel-f32")
    assert port.resolve_backend("auto") == "kernel"
    assert port.APPROX_BACKENDS == ("kernel-f32",)
    assert port.is_approx_backend("kernel-f32")
    assert not any(port.is_approx_backend(b) for b in EXACT)
    assert port.exact_backend("kernel-f32") == "numpy"
    assert [port.exact_backend(b) for b in EXACT] == list(EXACT)
    for bad in ("jax", "pallas", "pallas-compiled", "cuda"):
        with pytest.raises(ValueError, match="unknown pricing backend"):
            port.resolve_backend(bad)


def test_default_backend_runs_on_the_card(monkeypatch):
    """``auto`` is the kernel on the resolved device: without a card and
    without ``device="cpu"`` it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols = port.stack_plans(port.random_plan_vectors(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.price_plans(cols)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.price_plans(cols, backend="kernel-f32")
    port.price_plans(cols, backend="numpy")


def test_unknown_formula_has_no_kernel_entry():
    cols = port.stack_plans(port.random_plan_vectors(4))
    with pytest.raises(ValueError, match="no entry for formula"):
        port._dispatch(port._selection, cols, "kernel", "cpu")


def test_cpu_pricing_does_not_count_as_launches():
    n64, n32 = pricing_f64.launches, pricing_f32.launches
    cols = port.stack_plans(port.random_plan_vectors(8))
    port.price_plans(cols, backend="kernel", device="cpu")
    port.price_plans(cols, backend="kernel-f32", device="cpu")
    assert (pricing_f64.launches, pricing_f32.launches) == (n64, n32)


@pytest.mark.parametrize("band", ["abc", None, 0.0, 0.5, -1e-5, float("nan"),
                                  float("inf")])
def test_drift_band_validated_like_the_reference(band):
    with pytest.raises(ValueError):
        drift_band(band)
    with pytest.raises(ValueError):
        DSEEngine(drift_band=band)


def test_valid_band_prune_and_rank_arguments():
    assert drift_band("2e-5") == 2e-5 and drift_band() == BAND
    assert DSEEngine(drift_band=1e-4).drift_band == 1e-4
    assert resolve_prune("auto") and resolve_prune("on") and resolve_prune(True)
    assert not resolve_prune("off") and not resolve_prune(False)
    for rank in ("auto", "off", False):
        assert DSEEngine(rank=rank).rank == rank


@pytest.mark.parametrize("prune", ["maybe", "1", "yes", None])
def test_prune_policy_validated_like_the_reference(prune):
    with pytest.raises(ValueError, match="prune policy"):
        resolve_prune(prune)
    with pytest.raises(ValueError, match="prune policy"):
        DSEEngine(prune=prune)


def test_rank_policy_refuses_the_unported_learned_stage():
    # the learned stage is ported now: what is refused is a policy or a
    # keep fraction the reference refuses too, and an empty search budget
    with pytest.raises(ValueError, match="rank policy"):
        DSEEngine(rank="bogus")
    for rank in ("on", True):
        assert DSEEngine(rank=rank).rank == rank
    for frac in (0.0, 1.5):
        with pytest.raises(ValueError, match="rank_keep_frac"):
            DSEEngine(rank="on", rank_keep_frac=frac)
    with pytest.raises(ValueError, match="budget"):
        DSEEngine(device="cpu").search(None, policy=None, budget=0)
    with pytest.raises(ValueError, match="unknown pricing backend"):
        DSEEngine(pricing_backend="pallas")
