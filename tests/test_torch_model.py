"""The port's model against the JAX reference on the SMOKE configs of
mistral_nemo_12b (RMSNorm) and command_r_35b (LayerNorm, GQA group 4), and
command_r_35b's full-size leaves against the reference's, as shapes only.

Weights come from the reference's ``init_params`` and cross over through
numpy (``params_from_jax_numpy``); tokens come from numpy. Tolerances:
float32 — prefill logits 1e-4, K/V cache one bf16 ulp (rtol 2**-7: the cache
is bf16 even here, and an f32 difference at a rounding boundary flips the
last bit), decode-chain logits 1e-3, greedy tokens identical; bfloat16 —
teacher-forced logits within 2e-2 of the largest logit (the reference's bf16
kernel tolerance, on the scale of the logits: see ``_scaled_err``).
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
from repro.configs.mistral_nemo_12b import SMOKE as JAX_SMOKE
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_params,
                                params_from_jax_numpy, prefill)

SMOKE = get_config("mistral_nemo_12b", smoke=True)
B, S, STEPS = 2, 12, 5
#: the dense decoders whose SMOKE configs the comparisons below run
ARCHS = ("mistral_nemo_12b", "command_r_35b")


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_params(JAX_SMOKE, jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(the reference's SMOKE config, the port's, the reference's weights,
    tokens from numpy) of one of ARCHS."""
    jcfg = jax_get_config(request.param, smoke=True)
    cfg = get_config(request.param, smoke=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    return jcfg, cfg, jt.init_params(jcfg, jax.random.PRNGKey(0)), tokens


def _cfgs(case, dtype: str):
    return (dataclasses.replace(case[0], dtype=dtype),
            dataclasses.replace(case[1], dtype=dtype))


def _port(cfg, jparams):
    return params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jax_decode_chain(jcfg, params, prompt, steps, feed=None):
    """Reference prefill, cache moved into a serving-length one as the
    reference engine does, then ``steps`` decode steps (greedy, or fed the
    tokens ``feed``). Returns (logits per step, tokens)."""
    logits, cache0 = jax.jit(partial(jt.prefill, jcfg))(params, prompt)
    cache = jt.init_cache(jcfg, prompt.shape[0], S + steps + 1)
    cache = {k: cache[k].at[:, :, :, :S].set(cache0[k]) for k in cache}
    step = jax.jit(partial(jt.decode_step, jcfg))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    outs, toks = [], []
    for i in range(steps):
        if feed is not None:
            tok = jnp.asarray(feed[:, i])
        toks.append(np.asarray(tok))
        lg, cache = step(params, cache, tok, jnp.int32(S + i))
        outs.append(_np(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return outs, toks


def _port_decode_chain(cfg, params, prompt, steps, feed=None):
    logits, cache = prefill(cfg, params, prompt, max_len=S + steps + 1)
    tok = torch.argmax(logits[:, -1], -1)
    outs, toks = [], []
    for i in range(steps):
        if feed is not None:
            tok = torch.from_numpy(feed[:, i]).long()
        toks.append(tok.numpy())
        lg, cache = decode_step(cfg, params, cache, tok, S + i)
        outs.append(_np(lg))
        tok = torch.argmax(lg, -1)
    return outs, toks


def test_init_params_has_reference_shapes(jax_params):
    ours = init_params(SMOKE, seed=0, device="cpu")
    assert len(ours["stack"]) == SMOKE.n_blocks
    for k in ("embed", "lm_head"):
        assert tuple(ours[k].shape) == jax_params[k].shape
    assert ours["final_norm"]["w"].dtype == torch.float32
    flat_ref = jax.tree_util.tree_flatten_with_path(jax_params["stack"])[0]
    assert len(flat_ref) == 9
    for path, leaf in flat_ref:
        node = ours["stack"][0]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape[1:], path
    assert bool((ours["final_norm"]["w"] == 1).all())


def test_forward_and_prefill_f32_match_reference(case):
    jcfg, cfg = _cfgs(case, "float32")
    jax_params, tokens = case[2:]
    params = _port(cfg, jax_params)
    prompt = tokens[:, :S]
    want = _np(jt.forward(jcfg, jax_params, jnp.asarray(prompt)))
    got = forward(cfg, params, torch.from_numpy(prompt).long())
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)

    jlogits, jcache = jax.jit(partial(jt.prefill, jcfg))(jax_params,
                                                         jnp.asarray(prompt))
    logits, cache = prefill(cfg, params, torch.from_numpy(prompt).long())
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        assert cache[k].dtype == torch.bfloat16
        assert tuple(cache[k].shape) == jcache[k].shape
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]),
                                   rtol=2 ** -7, atol=0)


def test_decode_chain_f32_matches_reference(case):
    jcfg, cfg = _cfgs(case, "float32")
    jax_params, tokens = case[2:]
    params = _port(cfg, jax_params)
    prompt = tokens[:, :S]
    want, want_toks = _jax_decode_chain(jcfg, jax_params, jnp.asarray(prompt),
                                        STEPS)
    got, got_toks = _port_decode_chain(cfg, params,
                                       torch.from_numpy(prompt).long(), STEPS)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)
    assert [t.tolist() for t in got_toks] == [t.tolist() for t in want_toks]


def _scaled_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest difference over the largest logit: bf16 logits of unit scale
    carry ~2**-8 of rounding each, and both frameworks round in other
    places, so an element-wise relative test fails on logits near zero."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bf16_teacher_forced_logits_match_reference(case):
    jcfg, cfg = _cfgs(case, "bfloat16")
    jax_params, tokens = case[2:]
    params = _port(cfg, jax_params)
    want = _np(jt.forward(jcfg, jax_params, jnp.asarray(tokens)))
    got = forward(cfg, params, torch.from_numpy(tokens).long())
    assert got.dtype == torch.bfloat16
    assert _scaled_err(_np(got), want) <= 2e-2
    # and the port in bf16 is as close to the f32 reference as the
    # reference's own bf16 path is
    exact = _np(jt.forward(dataclasses.replace(jcfg, dtype="float32"),
                           jax_params, jnp.asarray(tokens)))
    assert _scaled_err(_np(got), exact) <= 1.25 * _scaled_err(want, exact)

    feed = tokens[:, S:]
    prompt = tokens[:, :S]
    want, _ = _jax_decode_chain(jcfg, jax_params, jnp.asarray(prompt), STEPS,
                                feed=feed)
    got, _ = _port_decode_chain(cfg, params, torch.from_numpy(prompt).long(),
                                STEPS, feed=feed)
    for w, g in zip(want, got):
        assert _scaled_err(g, w) <= 2e-2


def _port_shapes(tree, path=()) -> dict:
    """{path: (shape, dtype)} of the port's leaves, each block of the stack
    (a list here) folded into one leaf with a leading n_blocks axis, as the
    reference stacks them."""
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), tree.dtype)}
    if isinstance(tree, list):
        blocks = [_port_shapes(b, path) for b in tree]
        assert all(b == blocks[0] for b in blocks), path
        return {p: ((len(blocks),) + shape, dt) for p, (shape, dt) in blocks[0].items()}
    return {k: v for name, sub in tree.items()
            for k, v in _port_shapes(sub, path + (name,)).items()}


def test_command_r_full_size_leaves_match_reference():
    """command_r_35b at full size, nothing allocated: the port's leaves on
    the meta device have the paths and shapes of ``jax.eval_shape`` over
    the reference's init; the matrices (bf16 for serving) take 2 x
    ``param_count()`` bytes, 60.3 GiB, and only the LayerNorm leaves are
    float32."""
    jcfg = jax_get_config("command_r_35b")
    cfg = get_config("command_r_35b")
    want = jax.eval_shape(partial(jt.init_params, jcfg), jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = _port_shapes(init_params(cfg, device="meta"))
    assert {p: shape for p, (shape, _) in got.items()} == want
    assert got[("stack", "l0", "attn", "wk")][0] == (40, 8192, 8 * 128)
    bf16 = sum(np.prod(shape) * 2 for shape, dt in got.values() if dt == torch.bfloat16)
    assert bf16 == 2 * cfg.param_count() == 2 * jcfg.param_count()
    assert round(bf16 / 2**30, 1) == 60.3
    assert {p[-2] for p, (_, dt) in got.items() if dt == torch.float32} == {
        "ln1", "ln2", "final_norm"}


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference_field_for_field(smoke):
    want = jax_get_config("mistral_nemo_12b", smoke=smoke)
    got = get_config("mistral_nemo_12b", smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("hd", "block_size", "n_blocks"):
        assert getattr(got, prop) == getattr(want, prop)


def test_rope_matches_reference():
    from repro.models.layers import apply_rope as jax_rope
    from repro_torch.models.layers import apply_rope
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 4, 32), dtype=np.float32)
    pos = np.arange(3, 12)
    for theta in (1e4, 1e6):
        want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), theta))
        got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dt):
    from repro.models.layers import make_norm as jax_make_norm
    from repro_torch.models.layers import make_norm
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 64), dtype=np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    _, jax_apply = jax_make_norm(JAX_SMOKE)
    want = _np(jax_apply({"w": jnp.asarray(w)}, jnp.asarray(x).astype(dt)))
    init, apply = make_norm(SMOKE)
    assert bool((init(64, "cpu")["w"] == 1).all())
    got = apply({"w": torch.from_numpy(w)},
                torch.from_numpy(x).to(getattr(torch, dt)))
    assert got.dtype == getattr(torch, dt)
    tol = 2e-2 if dt == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


def test_unported_configs_raise():
    """Every architecture of the reference initialises in the port: the
    three that waited for cross-attention memory, the encoder and hybrid
    blocks pass ``check_supported`` and carry their leaves. The
    expert-parallel MoE dispatch initialises too: without a mesh it
    computes the scatter dispatch, as the reference does; all three train
    (the fused RMSNorm and the SSD scan have a backward)."""
    from repro_torch.models.transformer import check_supported
    from repro_torch.train import make_train_step
    for arch, leaf in (("llama32_vision_11b", "xattn"),
                       ("seamless_m4t_medium", "xattn"),
                       ("jamba_v01_52b", "ssm")):
        cfg = get_config(arch, smoke=True)
        check_supported(get_config(arch))
        params = init_params(cfg, device="cpu")
        assert any(leaf in lp for blk in params["stack"] for lp in blk.values())
        assert ("enc_stack" in params) == cfg.is_enc_dec
    shard_map = init_params(dataclasses.replace(
        get_config("jamba_v01_52b", smoke=True), moe_dispatch="shard_map"),
        device="cpu")
    assert any("moe" in lp for blk in shard_map["stack"] for lp in blk.values())
    for arch in ("llama32_vision_11b", "jamba_v01_52b", "seamless_m4t_medium"):
        make_train_step(get_config(arch, smoke=True))
    # MoE layers are ported: the same change initialises
    moe = init_params(dataclasses.replace(SMOKE, moe_experts=4, moe_top_k=2),
                      device="cpu")
    assert set(moe["stack"][0]["l0"]["moe"]) == {"router", "wi", "wg", "wo"}
