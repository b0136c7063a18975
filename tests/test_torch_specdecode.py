"""The port's greedy sequence speculative decoding against the port's own
greedy engine and the JAX reference's ``speculative_generate``, on the CPU
(olmo_1b SMOKE in float32, weights from the reference's ``init_params``
through numpy, prompts from numpy).

With the target as its own draft every proposal is accepted and the
stream must equal the engine's greedy tokens bit for bit; with another
draft (the target's first layer alone) the tokens, the acceptance rate
and the number of target calls must be identical to the reference's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro.serve.specdecode import speculative_generate as jax_speculative_generate
from repro_torch.configs import get_config
from repro_torch.models import params_from_jax_numpy
from repro_torch.serve import ServeEngine, speculative_generate

ARCH = "olmo_1b"


def _cfgs():
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype="float32"),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32"))


@pytest.fixture(scope="module")
def models():
    """(jax cfg, cfg, jax params, port params) of the target, and the same
    of the draft: the target's first layer alone (its embedding and head),
    an early-exit draft that agrees with the target often, not always."""
    jcfg, cfg = _cfgs()
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    jdcfg, dcfg = (dataclasses.replace(c, n_layers=1) for c in (jcfg, cfg))
    jd = dict(jp, stack=jax.tree.map(lambda x: x[:1], jp["stack"]))
    return (jcfg, cfg, jp, tp), (jdcfg, dcfg, jd, dict(tp, stack=tp["stack"][:1]))


def _prompt(vocab: int, seed: int, s: int = 8) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (1, s)).astype(np.int32)


@pytest.mark.parametrize("window", [2, 4])
def test_self_draft_is_the_engines_greedy_stream(models, window):
    (_, cfg, _, params), _ = models
    prompt = torch.from_numpy(_prompt(cfg.vocab, 5)).long()
    n = 8
    engine = ServeEngine(cfg, params, max_batch=1, max_len=48, device="cpu")
    plain = [t[0] for t in engine.generate(prompt, n_tokens=n).tokens]
    spec, rate, target_calls = speculative_generate(
        cfg, params, cfg, params, prompt, n_tokens=n, window=window)
    assert spec == plain
    assert rate == 1.0
    # each target call emits window + 1 tokens
    assert target_calls == -(-n // (window + 1)) < n


@pytest.mark.parametrize("window, seed", [(4, 0), (3, 1)])
def test_other_draft_matches_reference(models, window, seed):
    """The draft (the target's first layer) proposes tokens the target
    partly rejects: tokens, acceptance rate and target calls identical."""
    (jcfg, cfg, jtarget, target), (jdcfg, dcfg, jdraft, draft) = models
    prompt = _prompt(cfg.vocab, seed, 16)
    want = jax_speculative_generate(jcfg, jtarget, jdcfg, jdraft,
                                    jnp.asarray(prompt), n_tokens=12,
                                    window=window)
    got = speculative_generate(cfg, target, dcfg, draft,
                               torch.from_numpy(prompt).long(), n_tokens=12,
                               window=window)
    assert got[0] == [int(t) for t in want[0]]
    assert got[1] == want[1] and got[2] == want[2]
    assert len(got[0]) == 12 and 0.0 < got[1] < 1.0
