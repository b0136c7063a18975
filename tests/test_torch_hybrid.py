"""The port's hybrid attention/SSM blocks (Jamba-v0.1) against the JAX
reference, on the CPU (the plain versions of the kernels), and the
configs' layer patterns and cache layout (``cache_spec``) of every
architecture.

``jamba_smoke`` has blocks of two layers, an SSM layer (slot 0 of
``ssm``/``conv``) and an attention layer (slot 0 of ``k``/``v``) with a
MoE; the full config's block of eight keeps its attention layer, index 4,
in slot 0 of ``k``/``v`` and its seven SSM layers in slots 0-6 of
``ssm``/``conv``. Weights come from the reference's ``init_params``
through numpy, tokens from numpy. Tolerances: float32 logits within 1e-4
at prompt lengths the reference's scan takes (S <= 128 or S % 128 == 0);
the bf16 K/V and conv caches one bf16 ulp plus 1e-5 (near zero the f32
rounding before the cast is worth more than a bf16 ulp, as in
``tests/test_torch_ssm.py``), the f32 SSM state 1e-4; decode steps from
the reference's prefill cache held in float32 within 1e-4, and through each package's bf16 cache
greedy tokens identical. In bfloat16 the port's logits are held against
the reference's float32 ones, each sequence before its first MoE routing
difference between the two (both packages' routes recorded, as
``chip_smoke.py`` holds OLMoE before its first route difference), within
5e-2 of the largest logit: the bf16 SSM layers alone put the reference's
own bf16 logits 3.6-4.9 % of the largest logit from its f32 ones
(``tests/test_torch_ssm.py``'s ``BF16_TOL``), and on jamba_smoke up to
5.0 % before a route difference (measured on the CPU over the 8 seeds
used here); the port's bf16 is held as close to float32 as the
reference's bf16.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import transformer as jt
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import (cache_spec, decode_step, forward, init_cache,
                                init_params, params_from_jax_numpy, prefill)
from repro_torch.models import layers as L
from repro_torch.serve import ServeEngine

ARCH = "jamba_v01_52b"
B, S, STEPS = 2, 12, 4
BF16_TOL = 5e-2


def _cfgs(dtype: str = "float32"):
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype))


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_params(_cfgs()[0], jax.random.PRNGKey(0))


def _port(cfg, jparams):
    return params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _scaled_err(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tokens(vocab: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(np.int32)


def _within_one_bf16_ulp(got, want, atol: float = 0.0) -> None:
    got, want = _np(got), _np(want)
    ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
    assert bool((np.abs(got - want) <= ulp + atol).all()), \
        float(np.abs(got - want).max())


# --------------------------------- configs -----------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference_field_for_field(arch, smoke):
    """Every architecture of the reference, field for field, and the
    derived layer pattern (block size, each layer's kind, cross-attention
    and MoE) equal to the reference's."""
    got, want = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("hd", "block_size", "n_blocks", "is_enc_dec",
                 "attention_free"):
        assert getattr(got, prop) == getattr(want, prop), prop
    for i in range(got.block_size):
        for fn in ("layer_kind", "layer_is_cross", "layer_is_moe"):
            assert getattr(got, fn)(i) == getattr(want, fn)(i), (fn, i)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_spec_matches_reference(arch):
    """Every config's slots, and the cache ``init_cache`` lays out from
    them, equal the reference's."""
    for smoke in (False, True):
        got, want = cache_spec(get_config(arch, smoke)), jt.cache_spec(
            jax_get_config(arch, smoke))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = get_config(arch, smoke=True)
    ours = init_cache(cfg, 2, 8, device="cpu")
    ref = jt.init_cache(jax_get_config(arch, smoke=True), 2, 8)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in ours.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in ref.items()}


def test_full_jamba_block_keeps_its_slots():
    spec = cache_spec(get_config(ARCH))
    assert (spec.n_attn, spec.n_ssm) == (1, 7)
    assert spec.attn_slots == [-1, -1, -1, -1, 0, -1, -1, -1]
    assert spec.ssm_slots == [0, 1, 2, 3, -1, 4, 5, 6]
    assert [spec.slot(i) for i in range(8)] == [0, 1, 2, 3, 0, 4, 5, 6]


# --------------------------------- models ------------------------------------
@pytest.mark.parametrize("s", [S, 128, 256])
def test_forward_f32_matches_reference(jax_params, s):
    jcfg, cfg = _cfgs()
    toks = _tokens(cfg.vocab, s)
    want = jt.forward(jcfg, jax_params, jnp.asarray(toks))
    got = forward(cfg, _port(cfg, jax_params), torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [S, 128])
def test_prefill_and_cache_layout_match_reference(jax_params, s):
    """Prefill's logits, and its cache slot for slot against the
    reference's (which ``cache_spec`` lays out)."""
    jcfg, cfg = _cfgs()
    toks = _tokens(cfg.vocab, s, seed=1)
    jlogits, jcache = jt.prefill(jcfg, jax_params, jnp.asarray(toks))
    logits, cache = prefill(cfg, _port(cfg, jax_params),
                            torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    assert set(cache) == set(jcache) == {"k", "v", "ssm", "conv"}
    for k, t in cache.items():
        assert tuple(t.shape) == jcache[k].shape, k
        assert str(t.dtype).split(".")[-1] == str(jcache[k].dtype), k
    for blk in range(cfg.n_blocks):
        for k in ("k", "v"):
            _within_one_bf16_ulp(cache[k][blk], jcache[k][blk], atol=1e-5)
        _within_one_bf16_ulp(cache["conv"][blk], jcache["conv"][blk], atol=1e-5)
        np.testing.assert_allclose(_np(cache["ssm"][blk]),
                                   _np(jcache["ssm"][blk]), rtol=1e-4, atol=1e-4)


def _jax_chain(jcfg, params, prompt, steps, feed=None, dtype=jnp.bfloat16):
    """Reference prefill, its cache moved into a serving-length one of
    ``dtype``, then ``steps`` decode steps (greedy, or fed ``feed``).
    Returns (logits per step, tokens, prefill cache)."""
    logits, cache0 = jax.jit(partial(jt.prefill, jcfg))(params, prompt)
    cache = jt.init_cache(jcfg, prompt.shape[0], S + steps + 1, dtype=dtype)
    cache = {k: (cache[k].at[:, :, :, :S].set(cache0[k].astype(dtype))
                 if k in ("k", "v") else cache0[k].astype(cache[k].dtype))
             for k in cache}
    step = jax.jit(partial(jt.decode_step, jcfg))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    outs, toks = [], []
    for i in range(steps):
        if feed is not None:
            tok = jnp.asarray(feed[:, i])
        toks.append(np.asarray(tok).tolist())
        lg, cache = step(params, cache, tok, jnp.int32(S + i))
        outs.append(_np(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return outs, toks, cache0


def _port_chain(cfg, params, prompt, steps, feed=None, cache=None):
    logits, filled = prefill(cfg, params, torch.from_numpy(prompt).long(),
                             max_len=S + steps + 1)
    cache = filled if cache is None else cache
    tok = torch.argmax(logits[:, -1], -1)
    outs, toks = [], []
    for i in range(steps):
        if feed is not None:
            tok = torch.from_numpy(feed[:, i]).long()
        toks.append(tok.tolist())
        lg, cache = decode_step(cfg, params, cache, tok, S + i)
        outs.append(_np(lg))
        tok = torch.argmax(lg, -1)
    return outs, toks


def test_decode_f32_matches_reference(jax_params):
    """Greedy through each package's bf16 cache: identical tokens; and
    teacher-forced steps from the reference's prefill cache held in float32
    (K/V, state and conv tail round nothing): logits within 1e-4."""
    jcfg, cfg = _cfgs()
    params = _port(cfg, jax_params)
    toks = _tokens(cfg.vocab, S + STEPS, seed=2)
    prompt = toks[:, :S]
    _, want_toks, _ = _jax_chain(jcfg, jax_params, jnp.asarray(prompt), STEPS)
    _, got_toks = _port_chain(cfg, params, prompt, STEPS)
    assert got_toks == want_toks

    feed = toks[:, S:]
    want, _, cache0 = _jax_chain(jcfg, jax_params, jnp.asarray(prompt), STEPS,
                                 feed=feed, dtype=jnp.float32)
    cache = {}
    for k, v in cache0.items():
        v = torch.from_numpy(np.array(v, np.float32))
        if k in ("k", "v"):
            v = torch.cat([v, v.new_zeros(v.shape[:3] + (STEPS + 1,) + v.shape[4:])], 3)
        cache[k] = v
    got, _ = _port_chain(cfg, params, prompt, STEPS, feed=feed, cache=cache)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def _routes(fn, *args) -> tuple:
    """(result of ``fn(*args)``, the experts every MoE layer call of the
    port chose, sorted, in call order)."""
    store, route = [], L._route

    def recording(p, xt, k):
        probs, gates, idx = route(p, xt, k)
        store.append(idx.sort(-1).values.numpy())
        return probs, gates, idx

    L._route = recording
    try:
        return fn(*args), store
    finally:
        L._route = route


def _jax_routes(fn, *args) -> tuple:
    """As :func:`_routes` for the reference: its ``moe`` is wrapped to hand
    each call's top-k experts to the host (``jax.debug.callback``, in
    order, also inside its scan over blocks)."""
    store, moe = [], JL.moe

    def recording(p, x, cfg, capacity_factor=None):
        xt = x.reshape(-1, x.shape[-1])
        logits = (xt @ p["router"].astype(x.dtype)).astype(jnp.float32)
        idx = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.moe_top_k)[1]
        jax.debug.callback(lambda i: store.append(np.sort(np.asarray(i), -1)),
                           idx, ordered=True)
        return moe(p, x, cfg, capacity_factor)

    JL.moe = recording
    try:
        out = fn(*args)
        jax.effects_barrier()
        return out, store
    finally:
        JL.moe = moe


def _held(a: list, b: list, shape) -> list[int]:
    """Per sequence, the first position that some MoE layer routes to other
    experts in the two runs' routes ``a`` and ``b`` (its length if none): a
    token routed otherwise changes its own logits and, through attention,
    every later position's, while earlier positions are computed alike."""
    same = np.ones(shape, bool)
    for ra, rb in zip(a, b, strict=True):
        same &= (ra.reshape(*shape, -1) == rb.reshape(*shape, -1)).all(-1)
    return [int(np.argmin(row)) if not row.all() else row.size for row in same]


def test_bf16_logits_match_reference(jax_params):
    """The port's bf16 forward and teacher-forced decode logits against the
    reference's float32 ones, within BF16_TOL of the largest logit at every
    position before the sequence's first route difference between the two,
    over 8 seeds of tokens (at least a third of all positions held); and
    the port's bf16 forward as close to float32 as the reference's own bf16
    forward is (the largest over the seeds, at most 1.25 times)."""
    jcfg, cfg = _cfgs("bfloat16")
    jexact = dataclasses.replace(jcfg, dtype="float32")
    params = _port(cfg, jax_params)
    held = total = 0
    worst = {"port": 0.0, "reference": 0.0}
    for seed in range(1, 9):
        tokens = _tokens(cfg.vocab, S + STEPS, seed=10 + seed)
        exact, xroutes = _jax_routes(jt.forward, jexact, jax_params,
                                     jnp.asarray(tokens))
        want, jroutes = _jax_routes(jt.forward, jcfg, jax_params,
                                    jnp.asarray(tokens))
        got, routes = _routes(forward, cfg, params,
                              torch.from_numpy(tokens).long())
        assert got.dtype == torch.bfloat16
        exact, want, got = _np(exact), _np(want), _np(got)
        clean = _held(routes, xroutes, tokens.shape)
        held, total = held + sum(clean), total + tokens.size
        for name, out, c in (("port", got, clean),
                             ("reference", want,
                              _held(jroutes, xroutes, tokens.shape))):
            for b, n in enumerate(c):
                if n:
                    worst[name] = max(worst[name],
                                      _scaled_err(out[b, :n], exact[b, :n]))
        feed = tokens[:, S:]
        want, _, _ = _jax_chain(jexact, jax_params, jnp.asarray(tokens[:, :S]),
                                STEPS, feed)
        got, _ = _port_chain(cfg, params, tokens[:, :S], STEPS, feed)
        for i, (w, g) in enumerate(zip(want, got)):
            for b, n in enumerate(clean):
                if S + i < n:
                    assert _scaled_err(g[b], w[b]) <= BF16_TOL, (seed, b, i)
    assert worst["port"] <= BF16_TOL, worst
    assert worst["port"] <= 1.25 * worst["reference"], worst
    assert held >= total / 3, (held, total)


def test_engine_greedy_tokens_match_reference(jax_params):
    """The serving engines, reference and port, greedy from the same
    prompts and weights (f32): identical tokens."""
    jcfg, cfg = _cfgs()
    params = _port(cfg, jax_params)
    prompt = _tokens(cfg.vocab, S, seed=3)
    want = JaxServeEngine(jcfg, jax_params, max_batch=B, max_len=S + 6).generate(
        jnp.asarray(prompt), n_tokens=5).tokens
    got = ServeEngine(cfg, params, max_batch=B, max_len=S + 6, device="cpu").generate(
        torch.from_numpy(prompt).long(), n_tokens=5).tokens
    assert [list(map(int, t)) for t in got] == [list(map(int, t)) for t in want]


def test_init_params_has_the_hybrid_tree(jax_params):
    """The port's own init gives the reference's tree: an SSM layer and an
    attention layer per block, each with its MLP or MoE."""
    _, cfg = _cfgs()
    ours = init_params(cfg, seed=0, device="cpu")
    assert len(ours["stack"]) == cfg.n_blocks
    for i in range(cfg.block_size):
        lp, jl = ours["stack"][0][f"l{i}"], jax_params["stack"][f"l{i}"]
        assert set(lp) == set(jl)
        for k in lp:
            for n, t in lp[k].items():
                assert tuple(t.shape) == jl[k][n].shape[1:], (i, k, n)
