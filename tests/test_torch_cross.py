"""The port's cross-attention memory and encoder against the JAX reference,
on the CPU (the plain versions of the kernels): the VLM
(``llama32_vision_11b``, GQA, cross-attention every other layer in SMOKE)
and the encoder-decoder (``seamless_m4t_medium``, LayerNorm, GELU, MHA,
every decoder layer cross-attends to the encoder's output).

Weights come from the reference's ``init_params`` through numpy
(``params_from_jax_numpy``); tokens, image embeddings and audio frames are
seeded in numpy and handed to both. Tolerances: the layers and ``encode``
in float32 within 1e-5; whole models in float32 as
``tests/test_torch_model.py`` holds mistral (prefill logits 1e-4, the bf16
K/V cache one bf16 ulp, the decode chain through a bf16 cache 1e-3 with
greedy tokens identical), and decode steps from the reference's prefill
cache held in float32 within 1e-4 (nothing rounds to bf16 there); the loss
within 1e-5 relative; bfloat16 logits within 2e-2 of the largest logit
(``_scaled_err``).
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
from repro.train.data import SyntheticTokens as JaxSyntheticTokens
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, encode, forward, init_params,
                                loss_fn, params_from_jax_numpy, prefill,
                                synth_batch)
from repro_torch.models import layers as L
from repro_torch.serve import ServeEngine
from repro_torch.train import (AdamWConfig, SyntheticTokens, adamw_init,
                               make_train_step)
from repro_torch.train.optimizer import tree_leaves

ARCHS = ["llama32_vision_11b", "seamless_m4t_medium"]
B, S, STEPS = 2, 12, 4
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch: str, dtype: str = "float32"):
    return (dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, jax params) of the SMOKE config."""
    jcfg, _ = _cfgs(request.param)
    return request.param, jt.init_params(jcfg, jax.random.PRNGKey(0))


def _port(cfg, jparams, dtype=None):
    return params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu", dtype=dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _scaled_err(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(cfg, seed: int = 0, b: int = B):
    """(tokens (b, S + STEPS) int32, memory source (b, M, d) float32): the
    image embeddings of the VLM, the audio frames of the encoder-decoder."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, S + STEPS)).astype(np.int32)
    m = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    return toks, rng.standard_normal((b, m, cfg.d_model)).astype(np.float32)


def _memories(jcfg, cfg, jparams, params, src: np.ndarray):
    """The memory each package attends to: the image embeddings as they
    are, or each package's encoder output over the audio frames."""
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    jsrc, tsrc = jnp.asarray(src).astype(jcfg.dtype), torch.from_numpy(src).to(dt)
    if not cfg.is_enc_dec:
        return jsrc, tsrc
    return jt.encode(jcfg, jparams, jsrc), encode(cfg, params, tsrc)


# --------------------------------- layers ------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_matches_reference(arch):
    """The layer for a sequence of queries and, through the decode kernel's
    plain version, for one query over every memory key."""
    jcfg, cfg = _cfgs(arch)
    jp = JL.init_attention(jax.random.PRNGKey(1), jcfg, cross=True)
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 21, cfg.d_model)).astype(np.float32)
    want = np.asarray(JL.cross_attention(jp, jnp.asarray(x), jnp.asarray(mem), jcfg))
    got = L.cross_attention(tp, torch.from_numpy(x), torch.from_numpy(mem), cfg)
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)
    one = L.decode_cross_attention(
        tp, torch.from_numpy(x[:, -1:]), torch.from_numpy(mem), cfg,
        torch.tensor([21], dtype=torch.int32))
    np.testing.assert_allclose(one.numpy(), want[:, -1:], **LAYER_TOL)


def test_encode_matches_reference():
    jcfg, cfg = _cfgs("seamless_m4t_medium")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    params = _port(cfg, jparams)
    _, frames = _inputs(cfg)
    want = jt.encode(jcfg, jparams, jnp.asarray(frames))
    got = encode(cfg, params, torch.from_numpy(frames))
    assert tuple(got.shape) == (B, cfg.n_audio_frames, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_convert_carries_memory_leaves(model):
    """``lnx``/``xattn`` on the cross layers, ``enc_stack`` (one dictionary
    per encoder layer) and ``enc_final_norm`` cross over value for value,
    and the port's own init has the same tree."""
    arch, jparams = model
    _, cfg = _cfgs(arch)
    params = _port(cfg, jparams)
    assert set(params) == set(jparams)
    for b in range(cfg.n_blocks):
        for i in range(cfg.block_size):
            lp, jl = params["stack"][b][f"l{i}"], jparams["stack"][f"l{i}"]
            assert ("xattn" in lp) == cfg.layer_is_cross(i) == ("lnx" in jl)
            for k in ("lnx", "xattn") if "xattn" in lp else ():
                for n, t in lp[k].items():
                    np.testing.assert_array_equal(t.numpy(), np.asarray(jl[k][n][b]))
    if cfg.is_enc_dec:
        assert len(params["enc_stack"]) == cfg.encoder_layers
        for i, ep in enumerate(params["enc_stack"]):
            assert set(ep) == {"ln1", "attn", "ln2", "mlp"}
            for k in ("attn", "mlp", "ln1"):
                for n, t in ep[k].items():
                    np.testing.assert_array_equal(
                        t.numpy(), np.asarray(jparams["enc_stack"][k][n][i]))
        np.testing.assert_array_equal(params["enc_final_norm"]["w"].numpy(),
                                      np.asarray(jparams["enc_final_norm"]["w"]))
    ours = init_params(cfg, seed=0, device="cpu")
    assert len(tree_leaves(ours)) == len(tree_leaves(params))
    for a, b in zip(tree_leaves(ours), tree_leaves(params)):
        assert a.shape == b.shape


# --------------------------------- models ------------------------------------
def test_forward_and_prefill_f32_match_reference(model):
    arch, jparams = model
    jcfg, cfg = _cfgs(arch)
    params = _port(cfg, jparams)
    toks, src = _inputs(cfg)
    jm, tm = _memories(jcfg, cfg, jparams, params, src)
    want = jt.forward(jcfg, jparams, jnp.asarray(toks), memory=jm)
    got = forward(cfg, params, torch.from_numpy(toks).long(), memory=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the memory reaches the logits (a dropped memory would pass the above
    # only if the two packages both dropped it)
    assert _scaled_err(forward(cfg, params, torch.from_numpy(toks).long()),
                       want) > 1e-2
    prompt = toks[:, :S]
    jlogits, jcache = jt.prefill(jcfg, jparams, jnp.asarray(prompt), memory=jm)
    logits, cache = prefill(cfg, params, torch.from_numpy(prompt).long(),
                            memory=tm)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    assert set(cache) == set(jcache)
    for k in ("k", "v"):
        assert cache[k].dtype == torch.bfloat16
        assert tuple(cache[k].shape) == jcache[k].shape
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]),
                                   rtol=2 ** -7, atol=1e-6)


def _jax_chain(jcfg, params, prompt, memory, steps, feed=None, dtype=None):
    """Reference prefill, its cache moved into a serving-length one (in
    ``dtype``, default its own bf16), then ``steps`` decode steps, greedy or
    fed ``feed``. Returns (logits per step, tokens, the prefill cache)."""
    logits, cache0 = jax.jit(partial(jt.prefill, jcfg))(params, prompt, memory)
    dtype = dtype or jnp.bfloat16
    cache = jt.init_cache(jcfg, prompt.shape[0], S + steps + 1, dtype=dtype)
    cache = {k: cache[k].at[:, :, :, :S].set(cache0[k].astype(dtype))
             for k in cache}
    step = jax.jit(partial(jt.decode_step, jcfg))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    outs, toks = [], []
    for i in range(steps):
        if feed is not None:
            tok = jnp.asarray(feed[:, i])
        toks.append(np.asarray(tok).tolist())
        lg, cache = step(params, cache, tok, jnp.int32(S + i), memory)
        outs.append(_np(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return outs, toks, cache0


def _port_chain(cfg, params, prompt, memory, steps, feed=None, cache=None):
    """The port's prefill (or, given ``cache``, decode from it) and decode
    steps, as :func:`_jax_chain`."""
    logits, filled = prefill(cfg, params, torch.from_numpy(prompt).long(),
                             max_len=S + steps + 1, memory=memory)
    cache = filled if cache is None else cache
    tok = torch.argmax(logits[:, -1], -1)
    outs, toks = [], []
    for i in range(steps):
        if feed is not None:
            tok = torch.from_numpy(feed[:, i]).long()
        toks.append(tok.tolist())
        lg, cache = decode_step(cfg, params, cache, tok, S + i, memory=memory)
        outs.append(_np(lg))
        tok = torch.argmax(lg, -1)
    return outs, toks


def test_decode_chain_f32_matches_reference(model):
    """Greedy from the prompt through each package's bf16 cache: logits
    within 1e-3, tokens identical; and decode steps from the reference's
    prefill cache held in float32 (the cache rounds nothing): within 1e-4."""
    arch, jparams = model
    jcfg, cfg = _cfgs(arch)
    params = _port(cfg, jparams)
    toks, src = _inputs(cfg, seed=1)
    jm, tm = _memories(jcfg, cfg, jparams, params, src)
    prompt = toks[:, :S]
    want, want_toks, _ = _jax_chain(jcfg, jparams, jnp.asarray(prompt), jm, STEPS)
    got, got_toks = _port_chain(cfg, params, prompt, tm, STEPS)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)
    assert got_toks == want_toks

    feed = toks[:, S:]
    want, _, cache0 = _jax_chain(jcfg, jparams, jnp.asarray(prompt), jm, STEPS,
                                 feed=feed, dtype=jnp.float32)
    cache = {k: torch.zeros(v.shape[:3] + (S + STEPS + 1,) + v.shape[4:])
             for k, v in cache0.items()}
    for k, v in cache0.items():
        cache[k][:, :, :, :S] = torch.from_numpy(_np(v))
    got, _ = _port_chain(cfg, params, prompt, tm, STEPS, feed=feed, cache=cache)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_bf16_logits_match_reference(model):
    """Teacher-forced forward and decode logits in bfloat16 within 2e-2 of
    the largest logit, with the memory in bfloat16 on both sides."""
    arch, jparams = model
    jcfg, cfg = _cfgs(arch, "bfloat16")
    params = _port(cfg, jparams)
    toks, src = _inputs(cfg, seed=2)
    jm, tm = _memories(jcfg, cfg, jparams, params, src)
    want = jt.forward(jcfg, jparams, jnp.asarray(toks), memory=jm)
    got = forward(cfg, params, torch.from_numpy(toks).long(), memory=tm)
    assert got.dtype == torch.bfloat16
    assert _scaled_err(got, want) <= 2e-2
    feed, prompt = toks[:, S:], toks[:, :S]
    want, _, _ = _jax_chain(jcfg, jparams, jnp.asarray(prompt), jm, STEPS, feed=feed)
    got, _ = _port_chain(cfg, params, prompt, tm, STEPS, feed=feed)
    for w, g in zip(want, got):
        assert _scaled_err(g, w) <= 2e-2


# ------------------------------ loss and training -----------------------------
def _batch(cfg, seed: int, b: int = B):
    """One batch for both packages, the memory's source under the key
    ``loss_fn`` reads (``image_embeds`` or ``audio_frames``)."""
    toks, src = _inputs(cfg, seed, b)
    key = "image_embeds" if cfg.family == "vlm" else "audio_frames"
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:]),
             key: jnp.asarray(src)},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long(),
             key: torch.from_numpy(src)})


def test_loss_matches_reference(model):
    """``loss_fn`` takes the memory from the batch: the image embeddings,
    or the encoder over the audio frames."""
    arch, jparams = model
    jcfg, cfg = _cfgs(arch)
    jbatch, batch = _batch(cfg, seed=3)
    want = float(jt.loss_fn(jcfg, jparams, jbatch))
    got = float(loss_fn(cfg, _port(cfg, jparams), batch))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    key = next(k for k in batch if k not in ("tokens", "labels"))
    batch[key] = batch[key] * 2.0
    assert abs(float(loss_fn(cfg, _port(cfg, jparams), batch)) - want) > 1e-4


def test_seamless_train_step_matches_reference():
    """One AdamW step of the encoder-decoder (the encoder's gradients flow
    through the cross-attention) against the reference's: loss within 1e-5
    relative, gradient norm within 1e-4; the updated parameters at the
    reference's rtol 2e-2, atol 2e-3."""
    jcfg, cfg = _cfgs("seamless_m4t_medium")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    jbatch, batch = _batch(cfg, seed=4)
    jp, _, jm = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(lr=1e-3)))(
        jparams, jax_adamw_init(jparams), jbatch)
    params = _port(cfg, jparams, torch.float32)
    params, opt, m = make_train_step(cfg, AdamWConfig(lr=1e-3))(
        params, adamw_init(params), batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert int(opt["step"]) == 1
    for got, want in zip(tree_leaves(params),
                         tree_leaves(_port(cfg, jp, torch.float32))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-3)


def test_seamless_grad_accumulation_splits_the_audio_frames():
    """accum=2 slices ``audio_frames`` with the tokens: the same update as
    accum=1 on the whole batch."""
    cfg = get_config("seamless_m4t_medium", smoke=True)
    batch = synth_batch(cfg, 4, 16, torch.Generator().manual_seed(0))
    assert tuple(batch["audio_frames"].shape) == (4, cfg.n_audio_frames, cfg.d_model)
    out = []
    for accum in (1, 2):
        params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
        p, _, m = make_train_step(cfg, AdamWConfig(lr=1e-3), accum=accum)(
            params, adamw_init(params), batch)
        out.append((float(m["loss"]), tree_leaves(p)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-3)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_inputs_carry_the_memory(arch):
    """``synth_batch`` and ``SyntheticTokens`` give the memory's source as
    the reference's do: ``SyntheticTokens`` the same values from one
    seed, in bfloat16."""
    cfg = get_config(arch, smoke=True)
    key, m = (("image_embeds", cfg.n_image_tokens) if cfg.family == "vlm"
              else ("audio_frames", cfg.n_audio_frames))
    batch = synth_batch(cfg, 3, 8, torch.Generator().manual_seed(1))
    assert set(batch) == {"tokens", "labels", key}
    assert batch[key].shape == (3, m, cfg.d_model)
    assert batch[key].dtype == torch.bfloat16
    extras = {key: (m, cfg.d_model)}
    want = next(iter(JaxSyntheticTokens(cfg.vocab, 2, 8, seed=5, extras=extras)))
    got = next(iter(SyntheticTokens(cfg.vocab, 2, 8, seed=5, extras=extras)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))


# --------------------------------- serving -----------------------------------
def test_memory_threads_both_paths():
    """The port of ``tests/test_serving.py::test_memory_threads_both_jitted_paths``:
    the memory reaches the engine's prefill and its decode step (a dropped
    memory leaves the logits unchanged), and ``generate`` takes it."""
    cfg = get_config("llama32_vision_11b", smoke=True)
    params = init_params(cfg, seed=0, device="cpu")
    eng = ServeEngine(cfg, params, max_batch=1, max_len=32, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (1, 4), generator=torch.Generator().manual_seed(0))
    m1 = torch.zeros((1, cfg.n_image_tokens, cfg.d_model))
    m2 = torch.ones((1, cfg.n_image_tokens, cfg.d_model))
    with torch.no_grad():
        pre1, slot = eng._prefill(prompts, m1)
        pre2, _ = eng._prefill(prompts, m2)
        assert not torch.allclose(pre1, pre2)
        tok = pre1[:, -1].argmax(-1)
        dec1 = eng._decode(slot, tok, 4, m1).clone()
        dec2 = eng._decode(slot, tok, 4, m2)
        assert not torch.allclose(dec1, dec2)
        with pytest.raises(ValueError, match="memory"):
            eng._decode(slot, tok, 4)
    res = eng.generate(prompts, n_tokens=3, memory=m1)
    assert len(res.tokens) == 3
    # a request without memory gets a slot of its own
    eng.generate(prompts, n_tokens=3)
    assert set(eng._slots) == {(1, tuple(m1.shape)), 1}


def test_engine_greedy_tokens_match_reference(model):
    """The serving engines, reference and port, greedy from the same
    prompts, weights and memory (f32): identical tokens."""
    arch, jparams = model
    jcfg, cfg = _cfgs(arch)
    params = _port(cfg, jparams)
    toks, src = _inputs(cfg, seed=6)
    jm, tm = _memories(jcfg, cfg, jparams, params, src)
    prompt = toks[:, :S]
    want = JaxServeEngine(jcfg, jparams, max_batch=B, max_len=S + 6).generate(
        jnp.asarray(prompt), n_tokens=5, memory=jm).tokens
    got = ServeEngine(cfg, params, max_batch=B, max_len=S + 6, device="cpu").generate(
        torch.from_numpy(prompt).long(), n_tokens=5, memory=tm).tokens
    assert [list(map(int, t)) for t in got] == [list(map(int, t)) for t in want]
