"""The port's serving engine and launcher against the JAX reference.

Greedy generation on the float32 SMOKE configs of mistral_nemo_12b and
command_r_35b must emit the reference engine's tokens exactly; the rest
mirrors the reference's engine tests (tests/test_serving.py) on the port
alone.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.launch.serve import run_serve
from repro_torch.models import init_params, params_from_jax_numpy
from repro_torch.serve import ServeEngine

SMOKE = get_config("mistral_nemo_12b", smoke=True)


@pytest.fixture(scope="module")
def engine():
    params = init_params(SMOKE, seed=0, device="cpu")
    return ServeEngine(SMOKE, params, max_batch=2, max_len=48, device="cpu")


def _prompts(b: int, s: int, seed: int = 0, vocab: int = SMOKE.vocab) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (b, s))).long()


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "command_r_35b"])
def test_greedy_generation_f32_matches_reference_engine(arch):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    prompts = _prompts(2, 10, seed=4, vocab=cfg.vocab)
    want = JaxServeEngine(jcfg, jparams, max_batch=2, max_len=17).generate(
        jnp.asarray(prompts.numpy(), jnp.int32), n_tokens=6)
    got = ServeEngine(cfg, params, max_batch=2, max_len=17,
                      device="cpu").generate(prompts, n_tokens=6)
    assert got.tokens == want.tokens
    assert got.ttft > 0 and got.tpot > 0 and got.tokens_per_s > 0


def test_generate_window_overflow_raises(engine):
    small = ServeEngine(SMOKE, engine.params, max_batch=1, max_len=16,
                        device="cpu")
    prompts = _prompts(1, 8)
    with pytest.raises(ValueError, match="max_len"):
        small.generate(prompts, n_tokens=9)
    with pytest.raises(ValueError, match="max_len"):
        small.decode_steady(prompts, n_steps=8, warmup=0)
    assert len(small.generate(prompts, n_tokens=8).tokens) == 8


def test_batch_over_max_batch_raises(engine):
    prompts = _prompts(3, 8)
    with pytest.raises(ValueError, match="max_batch"):
        engine.generate(prompts, n_tokens=2)
    with pytest.raises(ValueError, match="max_batch"):
        engine.decode_steady(prompts, n_steps=1, warmup=0)
    assert len(engine.generate(prompts[:2], n_tokens=2).tokens[0]) == 2


def test_decode_steady_timing_fields(engine):
    t = engine.decode_steady(_prompts(2, 8), n_steps=3, warmup=1)
    assert t.ttft > 0 and t.warmup == 1 and t.batch == 2
    assert len(t.step_times) == 3 and all(s > 0 for s in t.step_times)
    assert t.tpot == pytest.approx(sum(t.step_times) / 3)
    assert t.tokens_per_s == pytest.approx(2 / t.tpot)


def test_sampled_generation_seeded_deterministic(engine):
    prompts = _prompts(1, 8, seed=7)
    kw = dict(n_tokens=8, temperature=1.0)
    a = engine.generate(prompts, rng=torch.Generator().manual_seed(11), **kw)
    b = engine.generate(prompts, rng=torch.Generator().manual_seed(11), **kw)
    assert a.tokens == b.tokens
    c = engine.generate(prompts, rng=torch.Generator().manual_seed(12), **kw)
    assert c.tokens != a.tokens
    # a fresh variate every step: a sampled run does not repeat one token
    assert len({t[0] for t in a.tokens}) > 1


def test_sampling_without_rng_is_greedy(engine):
    prompts = _prompts(1, 8)
    hot = engine.generate(prompts, n_tokens=4, temperature=1.0, rng=None)
    cold = engine.generate(prompts, n_tokens=4)
    assert hot.tokens == cold.tokens


def test_run_serve_on_cpu_at_smoke_size(capsys):
    res = run_serve(SMOKE, requests=2, prompt_len=8, tokens=4, seed=0,
                    device="cpu")
    assert len(res.tokens) == 4 and all(len(t) == 2 for t in res.tokens)
    assert all(0 <= x < SMOKE.vocab for t in res.tokens for x in t)
    again = run_serve(SMOKE, requests=2, prompt_len=8, tokens=4, seed=0,
                      device="cpu")
    assert again.tokens == res.tokens
    assert "TTFT" in capsys.readouterr().out


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_serve(SMOKE, requests=1, prompt_len=4, tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(SMOKE, {})
