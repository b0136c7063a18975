"""The kernels' contract: the port's attention and RMSNorm kernels take what
the reference's Pallas kernels take, head dim 16 and float32 among it.

On the CPU each wrapper runs its plain version; at hd 16 and in float32
those are held against the reference's Pallas kernels in interpret mode
(and its oracles where the Pallas kernels take no ragged length), at the
reference's tolerances (tests/test_kernels.py, tests/test_flash_backward.py):
bf16 2e-2, float32 2e-5 forward and 2e-4 backward, decode LSE 1e-3. The
``supports`` tables take every configuration's (head dim, GQA group) in
bfloat16 and float32; float16 and head dims 8 and 256 stay refused, by the
checks the card runs before a launch. The launch counters tell the
instantiations apart by (dtype, head dim) (the cost model's float32 work:
tests/test_torch_kernel_cost.py). The CUDA kernels
are held against these plain versions on the card by
tests/test_torch_gpu.py and ``chip_smoke.py`` phase 3.
"""
from __future__ import annotations

import jax
import jax.experimental

# The reference kernel package imports ``jax.experimental.enable_x64``,
# which the installed jax no longer has (ROADMAP queue 3): alias it at
# import time, as tests/test_torch_kernels.py does.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention.backward import (  # noqa: E402
    flash_attention_bwd as pallas_bwd, flash_attention_fwd_lse as pallas_fwd_lse)
from repro.kernels.flash_attention.ops import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.rmsnorm.ops import fused_rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as decode_ops_fn  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.kernels import fused_rmsnorm, fused_rmsnorm_bwd  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd_lse)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops  # noqa: E402
from repro_torch.validation import CASE_NAMES, build_case, card_refusal  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
BWD_TOL = dict(rtol=2e-4, atol=2e-4)


def _both(a: np.ndarray, dt: str):
    """The same values as a jax array and a torch tensor of dtype ``dt``."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------ the tables -----------------------------------
def _attention_configs():
    return [(arch, smoke, dt) for arch in ARCH_IDS for smoke in (False, True)
            for dt in ("bf16", "f32")
            if not get_config(arch, smoke=smoke).attention_free]


@pytest.mark.parametrize("arch,smoke,dt", _attention_configs())
def test_supports_every_attention_config_in_both_dtypes(arch, smoke, dt):
    cfg = get_config(arch, smoke=smoke)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    tdt = DTYPES[dt][1]
    assert decode_ops.supports(cfg.hd, n_rep, tdt), (arch, smoke, cfg.hd, n_rep)
    assert flash_ops.supports(cfg.hd, n_rep, tdt), (arch, smoke, cfg.hd, n_rep)


@pytest.mark.parametrize("hd,dtype", [(8, torch.bfloat16), (256, torch.bfloat16),
                                      (256, torch.float32), (16, torch.float16),
                                      (128, torch.float16), (64, torch.float64)])
def test_supports_refuses_other_head_dims_and_dtypes(hd, dtype):
    assert not decode_ops.supports(hd, 1, dtype)
    assert not flash_ops.supports(hd, 1, dtype)


def _qkv(b, h, hkv, s, hd, dtype, sk=None):
    return (torch.zeros(b, h, s, hd, dtype=dtype),
            torch.zeros(b, hkv, sk or s, hd, dtype=dtype),
            torch.zeros(b, hkv, sk or s, hd, dtype=dtype))


@pytest.mark.parametrize("hd,dtype,error", [
    (16, torch.float16, TypeError), (128, torch.float16, TypeError),
    (8, torch.bfloat16, ValueError), (256, torch.float32, ValueError)])
def test_card_checks_refuse_float16_and_other_head_dims(hd, dtype, error):
    """What the card refuses before a launch: the flash and decode checks
    (shapes and dtypes first, then the device) and the RMSNorm's element
    type."""
    q, k, v = _qkv(1, 4, 2, 8, hd, dtype)
    with pytest.raises(error, match="flash_attention"):
        flash_ops._check("flash_attention", q, k, v)
    with pytest.raises(error, match="decode_attention"):
        decode_ops._check(q[:, :, 0], k, v)


def test_card_checks_pass_the_contract_and_stop_at_the_device():
    """bf16 and float32 (with the bf16 cache a float32 model keeps) at
    every head dim pass the checks and stop at the CPU device."""
    for hd in (16, 32, 64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(1, 6, 2, 8, hd, dtype)
            with pytest.raises(ValueError, match="no kernel for device"):
                flash_ops._check("flash_attention", q, k, v, q)
            with pytest.raises(ValueError, match="no kernel for device"):
                decode_ops._check(q[:, :, 0], k, v)
        q, k, v = _qkv(1, 6, 2, 8, hd, torch.float32)
        with pytest.raises(ValueError, match="no kernel for device"):
            decode_ops._check(q[:, :, 0], k.bfloat16(), v.bfloat16())
        with pytest.raises(TypeError, match="decode_attention"):
            decode_ops._check(q[:, :, 0].bfloat16(), k, v)    # bf16 q, f32 cache
    with pytest.raises(TypeError, match="flash_attention"):  # mixed dtypes
        flash_ops._check("flash_attention", q, k.bfloat16(), v)


@pytest.mark.parametrize("x,gate,error", [
    (torch.float16, None, TypeError), (torch.float64, None, TypeError),
    (torch.float32, torch.float16, TypeError), (torch.bfloat16, torch.bfloat16, TypeError),
    (torch.bfloat16, None, None), (torch.float32, None, None),
    (torch.float32, torch.bfloat16, None), (torch.float32, torch.float32, None)])
def test_rmsnorm_element_types(x, gate, error):
    xt = torch.zeros(2, 8, dtype=x)
    gt = None if gate is None else torch.zeros(2, 8, dtype=gate)
    if error is None:
        want = x if gate is None else gate
        assert rmsnorm_ops.element_dtype("fused_rmsnorm", xt, gt) == want
    else:
        with pytest.raises(error, match="fused_rmsnorm"):
            rmsnorm_ops.element_dtype("fused_rmsnorm", xt, gt)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_card_refusal_takes_every_validation_case(name):
    """The moe twin (qwen3_moe_235b's SMOKE shape, hd 16) runs on the card's
    kernels now: no case is refused."""
    assert card_refusal(build_case(name)) is None


def test_moe_twin_keeps_the_reference_head_dim():
    assert build_case("moe").twin.cfg.hd == 16


# --------------------------- plain vs Pallas ---------------------------------
@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal,dt,pallas", [
    (1, 4, 2, 128, 128, 16, True, "f32", True),
    (2, 4, 4, 128, 128, 16, False, "bf16", True),
    (1, 8, 2, 256, 256, 16, True, "bf16", True),
    (1, 6, 2, 128, 128, 16, True, "f32", True),      # group 3 (minitron SMOKE)
    (1, 4, 2, 128, 128, 128, True, "f32", True),
    (1, 4, 1, 256, 256, 64, False, "f32", True),
    (1, 4, 2, 100, 100, 16, True, "f32", False),     # ragged: oracle only
    (2, 4, 2, 130, 70, 16, True, "bf16", False)])
def test_flash_plain_matches_pallas_at_hd16_and_f32(b, h, hkv, sq, sk, hd, causal, dt,
                                                    pallas):
    rng = np.random.default_rng(5)
    qj, qt = _both(rng.standard_normal((b, h, sq, hd), dtype=np.float32), dt)
    kj, kt = _both(rng.standard_normal((b, hkv, sk, hd), dtype=np.float32), dt)
    vj, vt = _both(rng.standard_normal((b, hkv, sk, hd), dtype=np.float32), dt)
    out = flash_attention(qt, kt, vt, causal=causal)
    from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
    refs = [jax_flash_ref(qj, kj, vj, causal=causal)]
    if pallas:
        refs.append(pallas_flash(qj, kj, vj, causal=causal, interpret=True))
    for oj in refs:
        np.testing.assert_allclose(_np(out), _np(oj), **FWD_TOL[dt])
    assert out.dtype == qt.dtype


@pytest.mark.parametrize("b,h,hkv,s,hd", [(1, 4, 2, 128, 16), (1, 8, 2, 256, 16),
                                          (1, 4, 4, 128, 32), (1, 2, 1, 128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_fwd_lse_and_backward_match_pallas(b, h, hkv, s, hd, causal):
    """The float32 training attention (forward with LSE, then dQ, dK, dV)
    against the Pallas kernels in interpret mode within 2e-4, at hd 16 and
    the model's other head dims."""
    rng = np.random.default_rng(6)
    q, k, v, do = (rng.standard_normal(shape, dtype=np.float32)
                   for shape in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd),
                                 (b, h, s, hd)))
    jo, jlse = pallas_fwd_lse(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True)
    jgrads = pallas_bwd(*map(jnp.asarray, (q, k, v)), jo, jlse, jnp.asarray(do),
                        causal=causal, interpret=True)
    o, lse = flash_attention_fwd_lse(*map(torch.from_numpy, (q, k, v)), causal)
    grads = flash_attention_bwd(*map(torch.from_numpy, (q, k, v)), o, lse,
                                torch.from_numpy(do), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL["f32"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL["f32"])
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD_TOL)


@pytest.mark.parametrize("b,h,hkv,s,hd,kv_len,dt,pallas", [
    (2, 4, 2, 256, 16, 200, "f32", True),
    (1, 8, 2, 256, 16, 130, "bf16", True),
    (2, 6, 2, 256, 16, 190, "f32", True),      # group 3 (minitron SMOKE)
    (1, 8, 2, 128, 128, 77, "f32", True),
    (1, 32, 2, 128, 16, 61, "f32", True),      # group 16
    (2, 4, 1, 37, 16, 29, "bf16", False)])     # ragged S: oracle only
def test_decode_plain_matches_pallas_at_hd16_and_f32(b, h, hkv, s, hd, kv_len, dt, pallas):
    rng = np.random.default_rng(7)
    qj, qt = _both(rng.standard_normal((b, h, hd), dtype=np.float32), dt)
    kj, kt = _both(rng.standard_normal((b, hkv, s, hd), dtype=np.float32), dt)
    vj, vt = _both(rng.standard_normal((b, hkv, s, hd), dtype=np.float32), dt)
    o, lse = decode_ops_fn(qt, kt, vt, kv_len)
    refs = [jax_decode_ref(qj, kj, vj, kv_len, return_lse=True)]
    if pallas:
        refs.append(pallas_decode(qj, kj, vj, kv_len, interpret=True))
    for oj, lsej in refs:
        np.testing.assert_allclose(_np(o), _np(oj), **FWD_TOL[dt])
        np.testing.assert_allclose(_np(lse), _np(lsej), rtol=1e-3, atol=1e-3)
    assert o.dtype == qt.dtype and lse.dtype == torch.float32


def test_f32_decode_over_a_bf16_cache_matches_reference():
    """A float32 model's decode: a float32 q over its bf16 cache, read as
    float32, against the Pallas kernel given the same arrays."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 6, 16), dtype=np.float32)
    kj, kt = _both(rng.standard_normal((2, 2, 256, 16), dtype=np.float32), "bf16")
    vj, vt = _both(rng.standard_normal((2, 2, 256, 16), dtype=np.float32), "bf16")
    o, lse = decode_ops_fn(torch.from_numpy(q), kt, vt, 199)
    oj, lsej = pallas_decode(jnp.asarray(q), kj.astype(jnp.float32),
                             vj.astype(jnp.float32), 199, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), **FWD_TOL["f32"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(lsej), rtol=1e-3, atol=1e-3)
    assert o.dtype == torch.float32


@pytest.mark.parametrize("t,d,with_residual", [(8, 128, True), (5, 96, True), (16, 256, False)])
def test_f32_rmsnorm_matches_pallas(t, d, with_residual):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((t, d), dtype=np.float32)
    r = rng.standard_normal((t, d), dtype=np.float32) if with_residual else None
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    y, res = fused_rmsnorm(torch.from_numpy(x), torch.from_numpy(w),
                           None if r is None else torch.from_numpy(r))
    yj, resj = pallas_rmsnorm(jnp.asarray(x), jnp.asarray(w),
                              None if r is None else jnp.asarray(r), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **FWD_TOL["f32"])
    np.testing.assert_allclose(res.numpy(), np.asarray(resj), **FWD_TOL["f32"])
    assert y.dtype == res.dtype == torch.float32


@pytest.mark.parametrize("t,d", [(8, 128), (6, 100), (3, 1536)])
def test_f32_gated_rmsnorm_matches_reference(t, d):
    """The gated norm with a float32 gate (a float32 Mamba2 model's)
    against the reference's rmsnorm(y * silu(z), w) in float32, z a column
    slice of a wider array read through its row stride."""
    rng = np.random.default_rng(10)
    y = rng.standard_normal((t, d), dtype=np.float32)
    wide = 2 * rng.standard_normal((t, 2 * d + 40), dtype=np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    out, res = fused_rmsnorm(torch.from_numpy(y), torch.from_numpy(w),
                             gate=torch.from_numpy(wide)[:, :d])
    want = jax_layers.rmsnorm(jnp.asarray(y) * jax.nn.silu(jnp.asarray(wide[:, :d])),
                              jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD_TOL["f32"])
    assert res is None and out.dtype == torch.float32


@pytest.mark.parametrize("gated", [False, True])
def test_f32_rmsnorm_backward_matches_jax_vjp(gated):
    """The float32 norm's backward (residual form with dr, and gated with a
    float32 gate) against jax.vjp of the reference's rmsnorm, within 2e-4."""
    rng = np.random.default_rng(11)
    t, d = 6, 64
    x, r, dh, dr, z = (rng.standard_normal((t, d), dtype=np.float32) for _ in range(5))
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    T = torch.from_numpy
    if gated:
        dx, dz, dw = fused_rmsnorm_bwd(T(dh), None, T(x), T(w), None, 1e-6, T(z))

        def f(x_, w_, z_):
            return jax_layers.rmsnorm(x_ * jax.nn.silu(z_), w_)
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(z))
        jx, jw, jz = vjp(jnp.asarray(dh))
        pairs = ((dx, jx), (dz, jz), (dw, jw))
    else:
        dx, dres, dw = fused_rmsnorm_bwd(T(dh), T(dr), T(x), T(w), T(r), 1e-6)

        def f(x_, w_, r_):
            s = x_ + r_
            return jax_layers.rmsnorm(s, w_), s
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(r))
        jx, jw, jr = vjp((jnp.asarray(dh), jnp.asarray(dr)))
        pairs = ((dx, jx), (dres, jr), (dw, jw))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD_TOL)
        assert got.dtype == torch.float32


# ------------------------------ the counters ---------------------------------
def test_kind_names_dtype_and_head_dim():
    assert _build.kind(torch.bfloat16, 16) == "bf16/hd16"
    assert _build.kind(torch.float32, 128) == "f32/hd128"
    assert _build.kind(torch.float32) == "f32"


def test_launch_counters_tell_instantiations_apart(monkeypatch):
    """Eager launches count in all and by kind; launches captured into a
    counted graph add to both at each replay; a timing capture counts
    nothing."""

    def wrapper():
        pass
    wrapper.launches = 0
    capturing = False
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    _build.launched(wrapper, None, "f32/hd16")
    _build.launched(wrapper, None, "bf16/hd16")
    _build.launched(wrapper, None, "f32/hd16")
    assert wrapper.launches == 3 and wrapper.by_kind == {"f32/hd16": 2, "bf16/hd16": 1}
    capturing = True
    _build.launched(wrapper, None, "f32/hd16")            # a timing capture
    graph = _build.CountedGraph.__new__(_build.CountedGraph)
    graph.tally = {}
    graph.graph = type("Replayed", (), {"replay": lambda self: None})()
    _build._tallies.append(graph.tally)
    try:
        _build.launched(wrapper, None, "f32/hd128")
        _build.launched(wrapper, None, "f32/hd128")
    finally:
        _build._tallies.pop()
    assert wrapper.launches == 3
    graph.replay()
    graph.replay()
    assert wrapper.launches == 7
    assert wrapper.by_kind == {"f32/hd16": 2, "bf16/hd16": 1, "f32/hd128": 4}


def test_cpu_calls_count_no_instantiation():
    from repro_torch import kernels
    kernels.reset_launches()
    q = torch.zeros(1, 4, 16, 16)
    flash_attention(q, q[:, :2], q[:, :2])
    decode_ops_fn(q[:, :, 0], q[:, :2], q[:, :2], 8)
    fused_rmsnorm(torch.zeros(4, 16), torch.ones(16))
    assert kernels.launches_by_kind() == {}
    assert set(kernels.launches().values()) == {0}
