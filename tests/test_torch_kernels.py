"""Kernels of the PyTorch port against the JAX reference.

On the CPU each port wrapper runs its plain PyTorch version; those are held
against the reference's ``ref.py`` oracles and its Pallas kernels in
interpret mode, with the reference's tolerances (tests/test_kernels.py):
bf16 2e-2, f32 2e-5, decode LSE 1e-3. Ragged lengths, which the Pallas
kernels do not take, are checked against the oracles only.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental

# The reference kernel package imports ``jax.experimental.enable_x64``,
# which the installed jax no longer has (ROADMAP queue 3). Alias it at
# import time, so every test process sees the same alias.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.rmsnorm.ops import fused_rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.kernels.rmsnorm.ref import fused_rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro_torch.kernels import (decode_attention, flash_attention,  # noqa: E402
                                 fused_rmsnorm, launches, pricing_f32,
                                 pricing_f64, reset_launches)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" else dict(rtol=2e-5, atol=2e-5)


def _both(a: np.ndarray, dt: str):
    """The same values as a jax array and a torch tensor of dtype ``dt``
    (both round f32 to bf16 to nearest even, so the bits agree)."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --------------------------------- rmsnorm -----------------------------------
@pytest.mark.parametrize("t,d,with_residual,dt", [
    (8, 128, True, "f32"), (8, 128, False, "bf16"),
    (16, 256, True, "bf16"), (5, 96, True, "f32")])
def test_rmsnorm_plain_matches_reference(t, d, with_residual, dt):
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.standard_normal((t, d), dtype=np.float32), dt)
    rj, rt = _both(rng.standard_normal((t, d), dtype=np.float32), dt)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    rj, rt = (rj, rt) if with_residual else (None, None)
    y, res = fused_rmsnorm(xt, torch.from_numpy(w), rt)
    for yj, resj in (jax_rmsnorm_ref(xj, jnp.asarray(w), rj),
                     pallas_rmsnorm(xj, jnp.asarray(w), rj, interpret=True)):
        np.testing.assert_allclose(_np(y), _np(yj), **_tol(dt))
        np.testing.assert_allclose(_np(res), _np(resj), **_tol(dt))
    assert y.dtype == xt.dtype and res.dtype == xt.dtype


# ----------------------------- decode attention ------------------------------
@pytest.mark.parametrize("b,h,hkv,s,hd,kv_len,dt,pallas", [
    (2, 4, 2, 256, 32, 200, "f32", True),
    (1, 8, 2, 512, 64, 300, "bf16", True),
    (2, 4, 4, 256, 32, 256, "bf16", True),
    (2, 4, 1, 300, 32, 257, "f32", False),     # ragged S: oracle only
    (1, 8, 2, 37, 64, 37, "bf16", False)])
def test_decode_attention_plain_matches_reference(b, h, hkv, s, hd, kv_len,
                                                  dt, pallas):
    rng = np.random.default_rng(1)
    qj, qt = _both(rng.standard_normal((b, h, hd), dtype=np.float32), dt)
    kj, kt = _both(rng.standard_normal((b, hkv, s, hd), dtype=np.float32), dt)
    vj, vt = _both(rng.standard_normal((b, hkv, s, hd), dtype=np.float32), dt)
    o, lse = decode_attention(qt, kt, vt, kv_len)
    refs = [jax_decode_ref(qj, kj, vj, kv_len, return_lse=True)]
    if pallas:
        refs.append(pallas_decode(qj, kj, vj, kv_len, interpret=True))
    for oj, lsej in refs:
        np.testing.assert_allclose(_np(o), _np(oj), **_tol(dt))
        np.testing.assert_allclose(_np(lse), _np(lsej), rtol=1e-3, atol=1e-3)
    assert o.dtype == qt.dtype and lse.dtype == torch.float32


def test_decode_attention_reads_model_cache_layout():
    """The model hands over its (B, S, Hkv, hd) cache transposed: a strided
    view, which must give the answer of the contiguous layout."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32), dtype=np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, 50, 2, 32), dtype=np.float32))
    view = cache.transpose(1, 2)
    assert not view.is_contiguous()
    o, lse = decode_attention(q, view, view, 41)
    oj, lsej = jax_decode_ref(jnp.asarray(q.numpy()),
                              jnp.asarray(view.contiguous().numpy()),
                              jnp.asarray(view.contiguous().numpy()), 41,
                              return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lsej), rtol=1e-3, atol=1e-3)


# ----------------------------- flash attention -------------------------------
@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal,dt,pallas", [
    (1, 4, 2, 128, 128, 32, True, "f32", True),
    (2, 4, 4, 256, 256, 64, False, "bf16", True),
    (1, 8, 2, 256, 256, 32, True, "bf16", True),
    (1, 4, 2, 100, 100, 32, True, "f32", False),   # ragged: oracle only
    (1, 4, 1, 70, 130, 64, False, "bf16", False),
    (2, 4, 2, 130, 70, 32, True, "f32", False)])
def test_flash_attention_plain_matches_reference(b, h, hkv, sq, sk, hd, causal,
                                                 dt, pallas):
    rng = np.random.default_rng(3)
    qj, qt = _both(rng.standard_normal((b, h, sq, hd), dtype=np.float32), dt)
    kj, kt = _both(rng.standard_normal((b, hkv, sk, hd), dtype=np.float32), dt)
    vj, vt = _both(rng.standard_normal((b, hkv, sk, hd), dtype=np.float32), dt)
    out = flash_attention(qt, kt, vt, causal=causal)
    refs = [jax_flash_ref(qj, kj, vj, causal=causal)]
    if pallas:
        refs.append(pallas_flash(qj, kj, vj, causal=causal, interpret=True))
    for oj in refs:
        np.testing.assert_allclose(_np(out), _np(oj), **_tol(dt))
    assert out.shape == (b, h, sq, hd) and out.dtype == qt.dtype


def test_cpu_tensors_do_not_count_as_launches():
    reset_launches()
    x = torch.ones(4, 32)
    fused_rmsnorm(x, torch.ones(32), x)
    flash_attention(torch.ones(1, 2, 4, 32), torch.ones(1, 1, 4, 32),
                    torch.ones(1, 1, 4, 32))
    decode_attention(torch.ones(1, 2, 32), torch.ones(1, 1, 4, 32),
                     torch.ones(1, 1, 4, 32), 3)
    pricing_f64(torch.ones(25, 4, dtype=torch.float64))
    pricing_f32(torch.ones(8, 4, dtype=torch.float64), "roofline")
    assert launches() == {"rmsnorm": 0, "decode_attention": 0,
                          "flash_attention": 0, "pricing": 0,
                          "pricing_f32": 0}


# ------------------------------ import rule ----------------------------------
_FORBIDDEN = [re.compile(r"^\s*(import|from)\s+jax\b", re.M),
              re.compile(r"^\s*import\s+repro(\.|\s|,|$)", re.M),
              re.compile(r"^\s*from\s+repro(\.|\s)", re.M),
              re.compile("DFMODEL" + "_")]


def test_port_imports_nothing_of_jax_or_the_reference():
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
             *sorted((ROOT / "src" / "repro_torch").rglob("*.cu"))]
    assert len(files) > 10
    bad = [(f.relative_to(ROOT).as_posix(), pat.pattern)
           for f in files for pat in _FORBIDDEN
           if pat.search(f.read_text())]
    assert bad == []
    code = ("import sys, repro_torch.launch.serve, repro_torch.kernels, "
            "repro_torch.models.convert, repro_torch.core, "
            "repro_torch.workloads.scenarios, repro_torch.kernels.pricing; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
