"""The port's SSM path against the JAX reference: the SSD scan, the Mamba2
layer, and the mamba2_130m SMOKE model and engine.

On the CPU the port's ``ssd_chunk`` runs its plain version; it is held
against the reference's Pallas kernel in interpret mode and its oracle
(``ssd_chunk_ref``), and against the model's ``_ssd_chunk_scan``, with the
reference's SSD tolerance (rtol = atol = 2e-4) on y and the final state.
Weights come from the reference's ``init_params`` through numpy, inputs
and tokens from numpy seeds. Model tolerances: float32 — prefill logits
and SSM state 1e-4, the bf16 conv cache within one bf16 ulp plus 1e-5 (an
f32 difference at a rounding boundary flips the last bit), decode-chain logits
1e-3, greedy tokens identical; bfloat16 — teacher-forced logits within
5e-2 of the largest logit, and no farther from the f32 logits than the
reference's own bf16 logits are (see ``BF16_TOL``). At least one case per
level has a state width P different from the state size N, so a
transposed state cannot pass by its shape.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.experimental

# The reference kernel package imports ``jax.experimental.enable_x64``,
# which the installed jax no longer has (ROADMAP queue 3). Alias it at
# import time, as tests/test_torch_kernels.py does.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs.mamba2_130m import SMOKE as JAX_SMOKE  # noqa: E402
from repro.kernels.ssd.ops import ssd_chunk as pallas_ssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_chunk_ref as jax_ssd_chunk_ref  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launches, reset_launches, ssd_chunk  # noqa: E402
from repro_torch.kernels.ssd import ssd_chunk_ref  # noqa: E402
from repro_torch.launch.serve import run_serve  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                init_params, params_from_jax_numpy, prefill)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

SMOKE = get_config("mamba2_130m", smoke=True)
SSD_TOL = dict(rtol=2e-4, atol=2e-4)
# On this config the reference's own bf16 logits lie 3.6-4.9 % of the
# largest logit from its f32 logits (measured on the CPU, both head
# widths), so two bf16 implementations may differ by as much; the port's
# bf16 logits are held to that distance from f32 as well.
BF16_TOL = 5e-2
B, STEPS = 2, 5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _within_one_bf16_ulp(got, want) -> None:
    """|got - want| at most one bf16 ulp of the larger of the two, plus the
    f32 projection's own rounding before the cast (1e-5, the tolerance of
    the f32 conv tail in ``test_ssm_layer_matches_reference``): near zero
    that rounding is worth more than one bf16 ulp."""
    got, want = _np(got), _np(want)
    lim = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7 + 1e-5
    assert bool((np.abs(got - want) <= lim).all())


def _cfgs(dtype: str, **change):
    return (dataclasses.replace(JAX_SMOKE, dtype=dtype, **change),
            dataclasses.replace(SMOKE, dtype=dtype, **change))


def _port(cfg, jparams):
    return params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")


def _ssd_inputs(rng, lead, s, p, n):
    """x, dt, B, C, dA as the reference's kernel test makes them."""
    x = rng.standard_normal((*lead, s, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((*lead, s)))).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((*lead, s, n))).astype(np.float32)
    Cm = (0.3 * rng.standard_normal((*lead, s, n))).astype(np.float32)
    return x, dt, Bm, Cm, (-0.1 * dt).astype(np.float32)


# ------------------------------- the SSD scan --------------------------------
@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (2, 256, 64, 128, 128),
    (4, 512, 64, 128, 128),
    (1, 256, 128, 128, 64),
    (3, 192, 16, 32, 64)])
def test_ssd_plain_matches_pallas_contract(bh, s, p, n, chunk):
    """The Pallas contract: x (BH, S, P), dt/dA (BH, S), B/C (BH, S, N);
    the Pallas state is (BH, N, P), the port's its transpose."""
    args = _ssd_inputs(np.random.default_rng(bh * s), (bh,), s, p, n)
    yj, hj = pallas_ssd(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    y, h = ssd_chunk(*map(_t, args))
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (bh, s, p) and tuple(h.shape) == (bh, p, n)
    np.testing.assert_allclose(_np(y), _np(yj), **SSD_TOL)
    np.testing.assert_allclose(_np(h.transpose(1, 2)), _np(hj), **SSD_TOL)


@pytest.mark.parametrize("q,p,n", [(128, 64, 128), (37, 16, 32)])
def test_ssd_chunk_ref_matches_reference_oracle(q, p, n):
    rng = np.random.default_rng(q)
    x, dt, Bm, Cm, dA = _ssd_inputs(rng, (), q, p, n)
    h_in = rng.standard_normal((n, p), dtype=np.float32)
    yj, hj = jax_ssd_chunk_ref(*map(jnp.asarray, (x, dt, Bm, Cm, dA, h_in)))
    y, h = ssd_chunk_ref(*map(_t, (x, dt, Bm, Cm, dA, h_in)))
    np.testing.assert_allclose(_np(y), _np(yj), **SSD_TOL)
    np.testing.assert_allclose(_np(h), _np(hj), **SSD_TOL)


@pytest.mark.parametrize("b,s,h,p,n", [
    (2, 96, 3, 16, 32),          # S <= 128: the reference's chunk = S
    (2, 256, 2, 32, 16),         # S % 128 == 0: chunk 128
    (1, 200, 2, 16, 32)])        # ragged: the reference only as one chunk
def test_ssd_model_layout_matches_reference_scan(b, s, h, p, n):
    """The model layout: x (B, S, H, P), B/C (B, S, N) shared by every
    head and passed with a head stride of 0; the state (B, H, P, N)."""
    rng = np.random.default_rng(s)
    xs = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((b, s, n))).astype(np.float32)
    Cm = (0.3 * rng.standard_normal((b, s, n))).astype(np.float32)
    A_log = (0.5 * rng.standard_normal(h)).astype(np.float32)
    chunk = s if s <= 128 or s % 128 else 128
    yj, hj = jl._ssd_chunk_scan(*map(jnp.asarray, (xs, dt, Bm, Cm, A_log)),
                                chunk=chunk)
    dA = _t(dt) * -torch.exp(_t(A_log))
    Bt = _t(Bm)[:, :, None].expand(b, s, h, n)
    Ct = _t(Cm)[:, :, None].expand(b, s, h, n)
    y, state = ssd_chunk(_t(xs), _t(dt), Bt, Ct, dA)
    assert tuple(state.shape) == (b, h, p, n) == hj.shape
    np.testing.assert_allclose(_np(y), _np(yj), **SSD_TOL)
    np.testing.assert_allclose(_np(state), _np(hj), **SSD_TOL)


def test_ssd_other_devices_raise():
    """Meta tensors (the dry run) take the meta route: the kernel's outputs
    as shapes, its work recorded in an op count, no launch and no plain
    scan; a CPU tensor takes the plain version; the card the kernel."""
    from repro_torch import kernels
    from repro_torch.kernels import cost
    args = [_t(a) for a in _ssd_inputs(np.random.default_rng(0), (2,), 8,
                                       4, 4)]
    kernels.reset_launches()
    with cost.counting() as tally:
        y, h = ssd_chunk(*(a.to("meta") for a in args))
    assert y.device.type == h.device.type == "meta"
    want_y, want_h = ssd_chunk(*args)
    assert y.shape == want_y.shape and h.shape == want_h.shape
    assert tally["launches"] == {"ssd_chunk": 1} and tally["bytes"] > 0
    assert kernels.launches()["ssd"] == 0


# ------------------------------- the layer -----------------------------------
def _layer_case(seed: int, s: int):
    jcfg, cfg = _cfgs("float32", ssm_head_dim=16)
    jp = jl.init_ssm(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # non-trivial A_log, D, dt_bias and norm weight, not their init values
    h = jp["A_log"].shape[0]
    jp = dict(jp, A_log=jnp.asarray(0.5 * rng.standard_normal(h), jnp.float32),
              D=jnp.asarray(1 + 0.1 * rng.standard_normal(h), jnp.float32),
              dt_bias=jnp.asarray(0.3 * rng.standard_normal(h), jnp.float32),
              norm_w=jnp.asarray(1 + 0.1 * rng.standard_normal(
                  jp["norm_w"].shape), jnp.float32))
    p = {k: _t(np.asarray(v)) for k, v in jp.items()}
    x = rng.standard_normal((B, s, jcfg.d_model), dtype=np.float32)
    return jcfg, cfg, jp, p, x


@pytest.mark.parametrize("s", [12, 128])
def test_ssm_layer_matches_reference(s):
    jcfg, cfg, jp, p, x = _layer_case(1, s)
    want, want_state, want_tail = jt._ssm_with_state(jp, jnp.asarray(x), jcfg)
    got, state, tail = L.ssm_layer(p, _t(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        _np(got), _np(jl.ssm_layer(jp, jnp.asarray(x), jcfg)),
        rtol=1e-4, atol=1e-4)
    assert tuple(state.shape) == want_state.shape
    np.testing.assert_allclose(_np(state), _np(want_state), rtol=1e-4,
                               atol=1e-4)
    # the tail is the f32 input projection, rounded in another order
    np.testing.assert_allclose(_np(tail), _np(want_tail), rtol=1e-5,
                               atol=1e-5)


def test_ssm_decode_step_matches_reference():
    jcfg, cfg, jp, p, x = _layer_case(2, 1)
    rng = np.random.default_rng(3)
    d_in, n, h, hp = L.ssm_dims(cfg)
    state = rng.standard_normal((B, h, hp, n), dtype=np.float32)
    conv = rng.standard_normal((B, cfg.ssm_conv - 1, d_in + 2 * n)
                               ).astype(np.float32)
    conv_bf16 = jnp.asarray(conv).astype(jnp.bfloat16)
    want, want_state, want_conv = jl.ssm_decode_step(
        jp, jnp.asarray(x), jnp.asarray(state), conv_bf16, jcfg)
    st, cc = _t(state.copy()), torch.from_numpy(_np(conv_bf16)).bfloat16()
    got, st2, cc2 = L.ssm_decode_step(p, _t(x), st, cc, cfg)
    assert st2 is st and cc2 is cc           # updated in place
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(st), _np(want_state), rtol=1e-4, atol=1e-4)
    _within_one_bf16_ulp(cc, want_conv)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 7), (3,)], ids=["prefill", "decode"])
def test_gated_norm_bits_match_the_unfused_chain(dt, shape):
    """The layer's gated norm, one call of the fused RMSNorm with the gate,
    gives the bits of the chain it replaces: the cast of y, F.silu(z), the
    product, then the norm (z a slice of a wider in_proj output); and it
    computes the reference's rmsnorm(y * silu(z), w) (jax's
    ``layers.rmsnorm``, y cast to the compute dtype as the layer casts it)
    at the tolerances of tests/test_torch_kernels.py: jax rounds its bf16
    SiLU otherwise, a few bf16 ulps."""
    from repro_torch.kernels import fused_rmsnorm

    rng = np.random.default_rng(5)
    d = 96
    y_np = rng.standard_normal((*shape, d), dtype=np.float32)
    wide = 2 * rng.standard_normal((*shape, 3 * d), dtype=np.float32)
    w_np = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    y, w = torch.from_numpy(y_np), torch.from_numpy(w_np)
    z = torch.from_numpy(wide).to(dt)[..., :d]
    g = y.to(dt) * torch.nn.functional.silu(z)
    want = fused_rmsnorm(g.reshape(-1, d), w)[0].view(g.shape)
    got = L._gated_norm(y, z, w)
    assert got.dtype == dt and torch.equal(got, want)
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    zj = jnp.asarray(wide).astype(jdt)[..., :d]
    ref = jl.rmsnorm(jnp.asarray(y_np).astype(jdt) * jax.nn.silu(zj), jnp.asarray(w_np))
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)


# ------------------------------- the model -----------------------------------
@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, SMOKE.vocab, (B, 256 + STEPS)).astype(np.int32)


@pytest.fixture(scope="module", params=[32, 16], ids=["P=N", "P!=N"])
def head_dim(request):
    return request.param


@pytest.fixture(scope="module")
def jax_params(head_dim):
    jcfg = dataclasses.replace(JAX_SMOKE, ssm_head_dim=head_dim)
    return jt.init_params(jcfg, jax.random.PRNGKey(0))


def test_init_params_has_reference_shapes():
    jparams = jt.init_params(JAX_SMOKE, jax.random.PRNGKey(0))
    ours = init_params(SMOKE, seed=0, device="cpu")
    assert "lm_head" not in ours and len(ours["stack"]) == SMOKE.n_blocks
    flat_ref = jax.tree_util.tree_flatten_with_path(jparams["stack"])[0]
    flat_ours = jax.tree_util.tree_flatten_with_path(ours["stack"][0])[0]
    assert len(flat_ref) == len(flat_ours) == 8     # ln1 + 7 SSM leaves
    for path, leaf in flat_ref:
        node = ours["stack"][0]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape[1:], path
        want = torch.float32 if leaf.ndim == 2 else torch.bfloat16
        assert node.dtype == want, path
    ssm = ours["stack"][0]["l0"]["ssm"]
    assert bool((ssm["A_log"] == 0).all() and (ssm["D"] == 1).all())
    cache = init_cache(SMOKE, 3, 40, device="cpu")
    ref = jt.init_cache(JAX_SMOKE, 3, 40)
    assert sorted(cache) == sorted(ref) == ["conv", "ssm"]
    for k in cache:
        assert tuple(cache[k].shape) == ref[k].shape
        assert str(cache[k].dtype).split(".")[-1] == str(ref[k].dtype)


@pytest.mark.parametrize("s", [12, 256])
def test_prefill_f32_matches_reference(jax_params, tokens, head_dim, s):
    jcfg, cfg = _cfgs("float32", ssm_head_dim=head_dim)
    params = _port(cfg, jax_params)
    prompt = tokens[:, :s]
    jlogits, jcache = jax.jit(partial(jt.prefill, jcfg))(jax_params,
                                                         jnp.asarray(prompt))
    logits, cache = prefill(cfg, params, _t(prompt).long(), max_len=s + 9)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(forward(cfg, params, _t(prompt).long())),
                               _np(logits), rtol=1e-5, atol=1e-5)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    for k in ("ssm", "conv"):
        assert tuple(cache[k].shape) == jcache[k].shape
    np.testing.assert_allclose(_np(cache["ssm"]), _np(jcache["ssm"]),
                               rtol=1e-4, atol=1e-4)
    _within_one_bf16_ulp(cache["conv"], jcache["conv"])


def _jax_decode_chain(jcfg, params, prompt, steps, feed=None):
    logits, cache = jax.jit(partial(jt.prefill, jcfg))(params, prompt)
    step = jax.jit(partial(jt.decode_step, jcfg))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    s = prompt.shape[1]
    outs, toks = [], []
    for i in range(steps):
        if feed is not None:
            tok = jnp.asarray(feed[:, i])
        toks.append(np.asarray(tok))
        lg, cache = step(params, cache, tok, jnp.int32(s + i))
        outs.append(_np(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return outs, toks


def _port_decode_chain(cfg, params, prompt, steps, feed=None):
    s = prompt.shape[1]
    logits, cache = prefill(cfg, params, prompt, max_len=s + steps + 1)
    tok = torch.argmax(logits[:, -1], -1)
    outs, toks = [], []
    for i in range(steps):
        if feed is not None:
            tok = _t(feed[:, i]).long()
        toks.append(tok.numpy())
        lg, cache = decode_step(cfg, params, cache, tok, s + i)
        outs.append(_np(lg))
        tok = torch.argmax(lg, -1)
    return outs, toks


@pytest.mark.parametrize("s", [12, 256])
def test_decode_chain_f32_matches_reference(jax_params, tokens, head_dim, s):
    jcfg, cfg = _cfgs("float32", ssm_head_dim=head_dim)
    params = _port(cfg, jax_params)
    prompt = tokens[:, :s]
    want, want_toks = _jax_decode_chain(jcfg, jax_params, jnp.asarray(prompt),
                                        STEPS)
    got, got_toks = _port_decode_chain(cfg, params, _t(prompt).long(), STEPS)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)
    assert [t.tolist() for t in got_toks] == [t.tolist() for t in want_toks]


def _scaled_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest difference over the largest logit (see test_torch_model)."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bf16_teacher_forced_logits_match_reference(jax_params, tokens,
                                                    head_dim):
    jcfg, cfg = _cfgs("bfloat16", ssm_head_dim=head_dim)
    params = _port(cfg, jax_params)
    prompt, feed = tokens[:, :128], tokens[:, 128:128 + STEPS]
    want = _np(jt.forward(jcfg, jax_params, jnp.asarray(prompt)))
    got = forward(cfg, params, _t(prompt).long())
    assert got.dtype == torch.bfloat16
    assert _scaled_err(_np(got), want) <= BF16_TOL
    # and the port in bf16 is as close to the f32 reference as the
    # reference's own bf16 path is
    exact = _np(jt.forward(dataclasses.replace(jcfg, dtype="float32"),
                           jax_params, jnp.asarray(prompt)))
    assert _scaled_err(_np(got), exact) <= 1.25 * _scaled_err(want, exact)

    want, _ = _jax_decode_chain(jcfg, jax_params, jnp.asarray(prompt), STEPS,
                                feed=feed)
    got, _ = _port_decode_chain(cfg, params, _t(prompt).long(), STEPS,
                                feed=feed)
    for w, g in zip(want, got):
        assert _scaled_err(g, w) <= BF16_TOL


@pytest.mark.parametrize("s0,s", [(128, 200), (2, 12)])
def test_ragged_prompt_matches_the_recurrence(jax_params, tokens, head_dim,
                                              s0, s):
    """Lengths the reference's model refuses: S = 200 (its chunking takes
    S <= 128 or S % 128 == 0) and a 2-token prompt, shorter than the conv
    window (its conv tail would not fill the cache). The port's chunked
    scan over S tokens must give the logits that the decode recurrence
    gives token by token after an s0-token prefill, within 2e-2 of the
    largest logit: the recurrence reads its convolution inputs from the
    bf16 conv cache, as the reference's does, where the scan convolves the
    f32 projections."""
    _, cfg = _cfgs("float32", ssm_head_dim=head_dim)
    params = _port(cfg, jax_params)
    want = _np(forward(cfg, params, _t(tokens[:, :s]).long()))
    _, cache = prefill(cfg, params, _t(tokens[:, :s0]).long(), max_len=s)
    for i in range(s0, s):
        lg, cache = decode_step(cfg, params, cache,
                                _t(tokens[:, i]).long(), i)
        assert _scaled_err(_np(lg), want[:, i]) <= 2e-2


# ------------------------------- engine and registry -------------------------
def test_greedy_generation_f32_matches_reference_engine():
    jcfg, cfg = _cfgs("float32", ssm_head_dim=16)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(1))
    params = _port(cfg, jparams)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (2, 10))
    want = JaxServeEngine(jcfg, jparams, max_batch=2, max_len=17).generate(
        jnp.asarray(prompts, jnp.int32), n_tokens=6)
    got = ServeEngine(cfg, params, max_batch=2, max_len=17,
                      device="cpu").generate(_t(prompts).long(), n_tokens=6)
    assert got.tokens == want.tokens
    assert got.ttft > 0 and got.tpot > 0 and got.tokens_per_s > 0


def test_run_serve_mamba2_on_cpu_at_smoke_size():
    reset_launches()
    res = run_serve(SMOKE, requests=2, prompt_len=8, tokens=4, seed=0,
                    device="cpu")
    assert len(res.tokens) == 4 and all(len(t) == 2 for t in res.tokens)
    assert all(0 <= x < SMOKE.vocab for t in res.tokens for x in t)
    assert set(launches().values()) == {0}       # plain versions only


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference_and_is_served(smoke):
    from repro.configs import get_config as jax_get_config
    want = jax_get_config("mamba2_130m", smoke=smoke)
    got = get_config("mamba2_130m", smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.attention_free and got.d_ff == 0
    # Jamba's hybrid blocks are served too: their SSM layers are these
    jamba = get_config("jamba_v01_52b", smoke=smoke)
    assert {jamba.layer_kind(i) for i in range(jamba.block_size)} == {"ssm", "attn"}
    assert (jamba.ssm_head_dim, jamba.ssm_expand) == (got.ssm_head_dim, got.ssm_expand)
