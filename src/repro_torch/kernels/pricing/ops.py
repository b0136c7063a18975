"""Wrappers of the pricing kernel, the kernel backends, and their
certification harnesses.

``pricing_f64`` and ``pricing_f32`` take the ``(n_in, n)`` float64 column
stack of one formula entry (:data:`.ref.FORMULAS`). A CUDA tensor goes to
the kernel in ``csrc/pricing.cu``, f64 (bit-identical to the numpy
reference) or f32 (drift-banded); a CPU tensor goes to the plain version
:func:`.ref.pricing_ref`. Each counts its kernel's launches in
``.launches``. :func:`kernel_columns` is what the ``kernel`` /
``kernel-f32`` backends of :func:`repro_torch.core.pricing.price_plans`
call: one pinned host→device copy of the stack, one launch, one
device→host copy. ``certify`` / ``certify_f32`` prove the bit-identity and
the drift band on seeded random plan vectors.
"""
from __future__ import annotations

import ctypes
from typing import Mapping

import numpy as np
import torch

from ...core.pricing import price_plans, stack_plans
from .. import _build
from .drift import DRIFT_BAND, drift_band
from .ref import FORMULAS, price_rows_scalar, pricing_ref, random_plan_vectors

_ENTRY_IDS = {"price": 0, "roofline": 1}


def _launch(x: torch.Tensor, entry: str, f32: bool) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"pricing: no kernel for device {x.device}")
    if entry not in _ENTRY_IDS:
        raise ValueError(f"pricing: unknown entry {entry!r}")
    _, names, outs, _ = FORMULAS[entry]
    if (x.dtype != torch.float64 or x.dim() != 2 or not x.is_contiguous()
            or x.shape[0] != len(names)):
        raise ValueError(f"pricing {entry}: x must be a contiguous float64 "
                         f"({len(names)}, n) column stack")
    n = x.shape[1]
    y = torch.empty((len(outs), n), device=x.device,
                    dtype=torch.float32 if f32 else torch.float64)
    fn = _build.bind("pricing", "pricing_run", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    err = fn(_build.ptr(x), _build.ptr(y), n, _ENTRY_IDS[entry], int(f32),
             _build.stream_ptr(x.device))
    _build.check("pricing", err)
    return y


def pricing_f64(x: torch.Tensor, entry: str = "price") -> torch.Tensor:
    """The f64 pricing kernel: ``x`` the ``(n_in, n)`` float64 column stack
    of ``entry`` (``"price"`` or ``"roofline"``); returns the ``(n_out, n)``
    float64 output stack, bit-identical to the numpy formula."""
    if x.device.type == "cpu":
        return pricing_ref(x, entry)
    y = _launch(x, entry, f32=False)
    pricing_f64.launches += 1
    return y


def pricing_f32(x: torch.Tensor, entry: str = "price") -> torch.Tensor:
    """The f32 pricing kernel: the same float64 inputs, rounded to float32
    in registers; returns the ``(n_out, n)`` float32 output stack, within
    the drift band of the f64 reference."""
    if x.device.type == "cpu":
        return pricing_ref(x, entry, f32=True)
    y = _launch(x, entry, f32=True)
    pricing_f32.launches += 1
    return y


pricing_f64.launches = 0
pricing_f32.launches = 0


def kernel_columns(entry: str, cols: Mapping[str, np.ndarray],
                   device: torch.device, f32: bool = False
                   ) -> dict[str, np.ndarray]:
    """The ``kernel`` (``f32=False``) and ``kernel-f32`` backends: numpy
    columns in, numpy columns out, through one launch of the kernel on
    ``device`` (its plain version on the CPU). Bool outputs come back as
    bool; float outputs as float64, or float32 with ``f32``."""
    _, names, outs, bools = FORMULAS[entry]
    n = len(cols[names[0]])
    cuda = device.type == "cuda"
    host = torch.empty((len(names), n), dtype=torch.float64, pin_memory=cuda)
    stack = host.numpy()
    for c, name in enumerate(names):
        stack[c] = cols[name]
    x = host.to(device, non_blocking=True)
    y = (pricing_f32 if f32 else pricing_f64)(x, entry)
    if cuda:
        out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        out.copy_(y, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
    else:
        out = y
    values = out.numpy()
    return {name: values[k] != 0 if name in bools else values[k]
            for k, name in enumerate(outs)}


def certify(n: int = 512, seed: int = 0, device=None) -> dict:
    """Prove row-identity of the f64 pricing kernel against the float64
    scalar reference on ``n`` seeded random plan vectors (``device``:
    ``None`` for the card, ``"cpu"`` for the plain version).

    Raises ``AssertionError`` naming the diverging columns if any output
    bit differs; returns a small report dict otherwise."""
    vectors = random_plan_vectors(n, seed)
    got = price_plans(stack_plans(vectors), backend="kernel", device=device)
    ref_rows = price_rows_scalar(vectors)
    mismatches: dict[str, int] = {}
    for key in ref_rows[0]:
        want = np.array([r[key] for r in ref_rows])
        col = got[key]
        if want.dtype == np.bool_:
            bad = int((col.astype(bool) != want).sum())
        else:
            bad = int((col.view(np.uint64) != want.view(np.uint64)).sum())
        if bad:
            mismatches[key] = bad
    if mismatches:
        raise AssertionError(
            f"pricing kernel diverged from the scalar reference (rows with "
            f"differing bits per column): {mismatches}")
    return {"rows": n, "outputs": len(ref_rows[0]), "bit_identical": True}


def certify_f32(n: int = 512, seed: int = 0, band: float = DRIFT_BAND,
                device=None) -> dict:
    """Prove the f32 pricing kernel honours the drift band ``band`` against
    the float64 scalar reference on ``n`` seeded random plan vectors.

    Every float output's relative drift must stay within the band, and
    every ``feasible`` bit may disagree only where the exact memory
    footprint itself lies within the band of the capacity (the zone the
    banded selection re-prices exactly). Raises ``AssertionError``
    otherwise; returns a drift report dict on success."""
    delta = drift_band(band)
    vectors = random_plan_vectors(n, seed)
    cols = stack_plans(vectors)
    got = price_plans(cols, backend="kernel-f32", device=device)
    ref_rows = price_rows_scalar(vectors)
    want = {key: np.array([r[key] for r in ref_rows]) for key in ref_rows[0]}
    drifts = f32_drift(got, want, cols["mem_capacity"])
    violations = {k: v for k, v in drifts.items() if v > delta}
    if violations:
        raise AssertionError(
            f"f32 pricing kernel exceeded the declared drift band {delta:g} "
            f"(worst relative drift per column): {violations}")
    return {"rows": n, "band": delta,
            "max_drift": max(drifts.values(), default=0.0),
            "drift_by_column": drifts, "within_band": True}


def f32_drift(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray],
              mem_capacity: np.ndarray) -> dict[str, float]:
    """Worst relative drift of each float column of ``got`` (f32) from
    ``want`` (f64, |want| as the denominator, 1 where want is 0), and, as
    ``feasible_margin``, the largest ``|mem - cap| / |cap|`` over the rows
    whose ``feasible`` bit flipped (absent when none flipped). A NaN or
    infinite ``want`` must be matched exactly; anything else is an infinite
    drift."""
    drifts: dict[str, float] = {}
    for key, w in want.items():
        if w.dtype == np.bool_:
            flipped = got[key].astype(bool) != w
            if flipped.any():
                cap = np.asarray(mem_capacity, dtype=np.float64)
                margin = (np.abs(want["per_chip_mem_bytes"] - cap)
                          / np.abs(cap))
                drifts["feasible_margin"] = float(margin[flipped].max())
            continue
        g = np.asarray(got[key], dtype=np.float64)
        with np.errstate(invalid="ignore"):
            err = np.abs(g - w) / np.where(w != 0.0, np.abs(w), 1.0)
        same = np.where(np.isnan(w), np.isnan(g), g == w)
        err = np.where(np.isfinite(w), err, np.where(same, 0.0, np.inf))
        err[np.isnan(err)] = np.inf
        drifts[key] = float(err.max()) if len(w) else 0.0
    return drifts
