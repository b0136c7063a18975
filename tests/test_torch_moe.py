"""The port's MoE layers and the OLMoE-1B-7B config against the JAX
reference, on the CPU (the plain versions of the kernels).

Weights come from the reference's initialisers and cross over through
numpy (``params_from_jax_numpy`` for whole models); inputs are seeded in
numpy. Tolerances: the layers in float32 within 2e-5 (``moe`` at capacity
factors that drop tokens, ``moe_dense``, ``moe_aux_loss``); the olmoe_smoke
model in float32 as ``tests/test_torch_model.py`` holds mistral (prefill
logits 1e-4, the bf16 K/V cache one bf16 ulp relative or 1e-6, decode
chain 1e-3, greedy tokens identical), and in bfloat16 within 2e-2 of the
largest logit (the reference's bf16 kernel tolerance on the scale of the
logits) before a routing near-tie (:data:`NEAR_TIE`).
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
from repro_torch.models import (decode_step, forward, init_params,
                                params_from_jax_numpy, prefill)
from repro_torch.models import layers as L
from repro_torch.serve import ServeEngine

B, S, STEPS = 2, 12, 4
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(dtype: str = "float32", **change):
    jcfg = dataclasses.replace(jax_get_config("olmoe_1b_7b", smoke=True),
                               dtype=dtype, **change)
    cfg = dataclasses.replace(get_config("olmoe_1b_7b", smoke=True),
                              dtype=dtype, **change)
    return jcfg, cfg


@pytest.fixture(scope="module")
def moe_params():
    jcfg, _ = _cfgs()
    jp = JL.init_moe(jax.random.PRNGKey(0), jcfg)
    return jp, {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}


@pytest.fixture(scope="module")
def x():
    _, cfg = _cfgs()
    return np.random.default_rng(0).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("cf, drops", [(8.0, False), (1.0, True), (0.5, True)])
def test_moe_matches_reference(moe_params, x, cf, drops):
    jcfg, cfg = _cfgs()
    jp, tp = moe_params
    want = np.asarray(JL.moe(jp, jnp.asarray(x), jcfg, capacity_factor=cf))
    got = L.moe(tp, torch.from_numpy(x), cfg, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)
    *_, keep, cap = L.moe_dispatch(tp, torch.from_numpy(x).reshape(-1, cfg.d_model),
                                   cfg, cf)
    assert bool((~keep).any()) == drops
    assert cap == int(max(1, np.ceil(48 * cfg.moe_top_k / cfg.moe_experts * cf)))


def test_moe_capacity_factor_from_config(moe_params, x):
    """Without an argument the capacity factor is the config's."""
    jcfg, cfg = _cfgs(moe_capacity_factor=0.75)
    jp, tp = moe_params
    want = np.asarray(JL.moe(jp, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(L.moe(tp, torch.from_numpy(x), cfg).numpy(),
                               want, **LAYER_TOL)


def test_moe_dense_and_aux_loss_match_reference(moe_params, x):
    jcfg, cfg = _cfgs()
    jp, tp = moe_params
    want = np.asarray(JL.moe_dense(jp, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(L.moe_dense(tp, torch.from_numpy(x), cfg).numpy(),
                               want, **LAYER_TOL)
    want = float(JL.moe_aux_loss(jp, jnp.asarray(x), jcfg))
    got = float(L.moe_aux_loss(tp, torch.from_numpy(x), cfg))
    assert got == pytest.approx(want, rel=2e-5, abs=2e-5)


def test_moe_gelu_experts_match_reference(x):
    """A non-gated expert FFN (GELU, tanh form) through both layers."""
    jcfg, cfg = _cfgs(gated=False)
    jp = JL.init_moe(jax.random.PRNGKey(1), jcfg)
    assert "wg" not in jp
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    for jfn, fn in ((partial(JL.moe, capacity_factor=1.0),
                     partial(L.moe, capacity_factor=1.0)),
                    (JL.moe_dense, L.moe_dense)):
        want = np.asarray(jfn(jp, jnp.asarray(x), jcfg))
        np.testing.assert_allclose(fn(tp, torch.from_numpy(x), cfg).numpy(),
                                   want, **LAYER_TOL)


def test_moe_shard_map_dispatch_without_mesh_matches_reference(moe_params, x):
    """Without a mesh, moe_dispatch="shard_map" does not raise: it is the
    scatter dispatch, as the reference's ``moe`` falls back to it, drops
    included."""
    jcfg, cfg = _cfgs(moe_dispatch="shard_map")
    jp, tp = moe_params
    for cf in (None, 1.0):
        want = np.asarray(JL.moe(jp, jnp.asarray(x), jcfg, capacity_factor=cf))
        got = L.moe(tp, torch.from_numpy(x), cfg, capacity_factor=cf)
        np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


# ------------------------------ the model -------------------------------------
@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    return jt.init_params(jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tokens():
    _, cfg = _cfgs()
    return np.random.default_rng(1).integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)


def _port(cfg, jparams):
    return params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")


def _scaled_err(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_olmoe_config_matches_reference_and_is_ported():
    for smoke in (False, True):
        got, want = get_config("olmoe_1b_7b", smoke), jax_get_config("olmoe_1b_7b", smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert {"olmoe_1b_7b", "qwen3_moe_235b"} <= set(ARCH_IDS)
    assert "jamba_v01_52b" in ARCH_IDS
    full = get_config("olmoe_1b_7b")
    assert (full.n_layers, full.d_model, full.hd, full.moe_experts,
            full.moe_top_k, full.d_ff, full.vocab) == (16, 2048, 128, 64, 8, 1024, 50_304)


def test_convert_carries_moe_leaves(jax_params):
    """router, wi, wg, wo (expert axis leading) cross over per block."""
    _, cfg = _cfgs()
    params = _port(cfg, jax_params)
    assert len(params["stack"]) == cfg.n_blocks
    for b in range(cfg.n_blocks):
        moe = params["stack"][b]["l0"]["moe"]
        assert set(moe) == {"router", "wi", "wg", "wo"}
        assert "mlp" not in params["stack"][b]["l0"]
        for k, t in moe.items():
            want = np.asarray(jax_params["stack"]["l0"]["moe"][k][b])
            assert tuple(t.shape) == want.shape and t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), want)
    assert tuple(params["stack"][0]["l0"]["moe"]["wi"].shape) == (
        cfg.moe_experts, cfg.d_model, cfg.d_ff)
    ours = init_params(cfg, seed=0, device="cpu")
    for k, t in ours["stack"][0]["l0"]["moe"].items():
        assert t.shape == params["stack"][0]["l0"]["moe"][k].shape


@pytest.mark.parametrize("cf", [None, 1.0])
def test_forward_and_prefill_f32_match_reference(jax_params, tokens, cf):
    """cf 1.0 drops tokens at prefill (the smoke config's own 8.0 drops
    none)."""
    change = {} if cf is None else {"moe_capacity_factor": cf}
    jcfg, cfg = _cfgs(**change)
    params = _port(cfg, jax_params)
    prompt = tokens[:, :S]
    want = jt.forward(jcfg, jax_params, jnp.asarray(tokens))
    got = forward(cfg, params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    jlogits, jcache = jt.prefill(jcfg, jax_params, jnp.asarray(prompt))
    logits, cache = prefill(cfg, params, torch.from_numpy(prompt).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32),
                                   rtol=2 ** -7, atol=1e-6)


def _jax_chain(jcfg, params, prompt, steps, feed=None):
    logits, cache0 = jax.jit(partial(jt.prefill, jcfg))(params, prompt)
    cache = jt.init_cache(jcfg, prompt.shape[0], S + steps + 1)
    cache = {k: cache[k].at[:, :, :, :S].set(cache0[k]) for k in cache}
    step = jax.jit(partial(jt.decode_step, jcfg))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    outs, toks = [], []
    for i in range(steps):
        if feed is not None:
            tok = jnp.asarray(feed[:, i])
        toks.append(np.asarray(tok).tolist())
        lg, cache = step(params, cache, tok, jnp.int32(S + i))
        outs.append(np.asarray(lg, np.float32))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return outs, toks


def _port_chain(cfg, params, prompt, steps, feed=None):
    logits, cache = prefill(cfg, params, torch.from_numpy(prompt).long(),
                            max_len=S + steps + 1)
    tok = torch.argmax(logits[:, -1], -1)
    outs, toks = [], []
    for i in range(steps):
        if feed is not None:
            tok = torch.from_numpy(feed[:, i]).long()
        toks.append(tok.tolist())
        lg, cache = decode_step(cfg, params, cache, tok, S + i)
        outs.append(lg.float().numpy())
        tok = torch.argmax(lg, -1)
    return outs, toks


def test_decode_chain_f32_matches_reference(jax_params, tokens):
    """decode_step runs moe_dense (dropless), as the reference's."""
    jcfg, cfg = _cfgs()
    params = _port(cfg, jax_params)
    want, want_toks = _jax_chain(jcfg, jax_params, jnp.asarray(tokens[:, :S]), STEPS)
    got, got_toks = _port_chain(cfg, params, tokens[:, :S], STEPS)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)
    assert got_toks == want_toks


#: A (token, layer) whose k-th and (k+1)-th router log-probabilities lie
#: within this of each other is a near-tie: bf16 rounds the hidden state in
#: other places in the two frameworks (the fused norm rounds once), and the
#: bf16 router logits tie exactly now and then, so such a token may go to
#: another expert in each, both valid routes (the reference's own bf16 and
#: f32 paths part there too). 2^-6 is 4 bf16 ulps of a unit logit;
#: measured flips sat at gaps of 0 and 2^-8.
NEAR_TIE = 2.0 ** -6


def _first_near_tie(cfg, params, tokens) -> list[int]:
    """Per sequence, the first position that is a near-tie in some layer
    of the port's forward over ``tokens`` (its length if none): a position
    routed otherwise changes its own logits and, through attention, every
    later one, while earlier positions are untouched (causal)."""
    gaps, route = [], L._route

    def recording(p, xt, k):
        probs, gates, idx = route(p, xt, k)
        top = torch.topk(probs, k + 1, dim=-1).values.log()
        gaps.append((top[:, k - 1] - top[:, k]).reshape(tokens.shape))
        return probs, gates, idx

    L._route = recording
    try:
        forward(cfg, params, torch.from_numpy(tokens).long())
    finally:
        L._route = route
    tie = torch.stack(gaps).amin(0) < NEAR_TIE                  # (B, S)
    return [int(t.nonzero()[0]) if t.any() else tokens.shape[1] for t in tie]


def test_bf16_logits_match_reference(jax_params):
    """bf16 forward and teacher-forced decode logits within 2e-2 of the
    largest logit, at every position before the sequence's first near-tie
    (:data:`NEAR_TIE`), over 8 seeds of tokens; at least a third of all
    positions are held."""
    jcfg, cfg = _cfgs("bfloat16")
    params = _port(cfg, jax_params)
    held = total = 0
    for seed in range(1, 9):
        tokens = np.random.default_rng(seed).integers(
            0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
        clean = _first_near_tie(cfg, params, tokens)
        held, total = held + sum(clean), total + tokens.size
        want = np.asarray(jt.forward(jcfg, jax_params, jnp.asarray(tokens)),
                          np.float32)
        got = forward(cfg, params, torch.from_numpy(tokens).long())
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        for b, n in enumerate(clean):
            if n:
                assert _scaled_err(got[b, :n], want[b, :n]) <= 2e-2, (seed, b)
        feed = tokens[:, S:]
        want, _ = _jax_chain(jcfg, jax_params, jnp.asarray(tokens[:, :S]),
                             STEPS, feed)
        got, _ = _port_chain(cfg, params, tokens[:, :S], STEPS, feed)
        for i, (w, g) in enumerate(zip(want, got)):
            for b, n in enumerate(clean):
                if S + i < n:
                    assert _scaled_err(g[b], w[b]) <= 2e-2, (seed, b, i)
    assert held >= total / 3, (held, total)


def test_routing_ties_go_to_the_lower_expert():
    """Equal router probabilities pick the lower expert index, as
    jax.lax.top_k does."""
    _, cfg = _cfgs()
    router = torch.zeros(cfg.d_model, cfg.moe_experts)
    router[:, 5] = router[:, 2] = 1.0 / cfg.d_model
    xt = torch.ones(3, cfg.d_model)
    _, gates, idx = L._route({"router": router}, xt, cfg.moe_top_k)
    assert idx.tolist() == [[2, 5]] * 3
    want = jax.lax.top_k(jnp.asarray(torch.softmax(xt @ router, -1).numpy()),
                         cfg.moe_top_k)[1]
    assert idx.tolist() == np.asarray(want).tolist()


def test_engine_greedy_tokens_match_reference(jax_params, tokens):
    """The serving engines, reference and port, greedy from the same
    prompts and weights (f32): identical tokens."""
    jcfg, cfg = _cfgs()
    params = _port(cfg, jax_params)
    prompt = tokens[:, :S]
    want = JaxServeEngine(jcfg, jax_params, max_batch=B, max_len=S + 6).generate(
        jnp.asarray(prompt), n_tokens=5).tokens
    got = ServeEngine(cfg, params, max_batch=B, max_len=S + 6, device="cpu").generate(
        torch.from_numpy(prompt).long(), n_tokens=5).tokens
    assert [list(map(int, t)) for t in got] == [list(map(int, t)) for t in want]


def test_dispatch_rank_is_the_one_hot_cumsum(moe_params):
    """The dispatch's rank (a stable sort by expert) equals the reference's
    formula, the cumsum down the (T k, E) one-hot, at every pair."""
    _, cfg = _cfgs()
    xt = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (200, cfg.d_model)).astype(np.float32))
    _, idx, rank, keep, cap = L.moe_dispatch(moe_params[1], xt, cfg, 0.7)
    flat = torch.nn.functional.one_hot(idx, cfg.moe_experts).reshape(-1, cfg.moe_experts)
    want = ((torch.cumsum(flat, 0) - 1) * flat).sum(-1).reshape(idx.shape)
    assert torch.equal(rank, want)
    assert torch.equal(keep, want < cap) and bool((~keep).any())
