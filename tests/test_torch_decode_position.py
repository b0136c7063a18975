"""The decode position as a device tensor, as the reference traces it.

The reference compiles one decode step and takes ``pos`` as a traced
``jax.Array`` (``len_ref`` in the Pallas kernel's SMEM); the port's
``decode_step`` takes a one-element tensor on the model's device, so that
the step can be captured in a CUDA graph and replayed at every later
position. On the CPU: the tensor position gives logits and caches
bit-identical to the int one (the same arithmetic, only where the value
lives differs) on the three served architectures' SMOKE configs; in float32
it agrees with JAX's ``decode_step`` at a ``jnp.int32`` position within the
decode-chain tolerance of the model tests (1e-3); ``decode_attention``'s
plain version gives the same bits with a tensor ``kv_len`` as with an int,
and the wrapper refuses a ``kv_len`` of the wrong dtype, size or device.
The engine keeps one cache per batch size, which prefill writes in place;
the launch counters count a graph's kernels per replay.
"""
from __future__ import annotations

import dataclasses

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

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.models import (decode_step, init_params,  # noqa: E402
                                params_from_jax_numpy, prefill)
from repro_torch.models.transformer import position  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCHS = ("mistral_nemo_12b", "minitron_4b", "mamba2_130m")
B, S, STEPS = 2, 12, 3


def _tokens(vocab: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, S + STEPS)).astype(np.int32)


def _clone(cache: dict) -> dict:
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_tensor_position_is_bit_identical_to_int(arch, dtype):
    """Prefill, then STEPS decode steps twice from the same cache: the
    position as a Python int, and as a one-element tensor (int64 or int32)."""
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab)).long()
    _, cache = prefill(cfg, params, toks[:, :S], max_len=S + STEPS)
    by_int, by_tensor = _clone(cache), _clone(cache)
    for i in range(STEPS):
        tok = toks[:, S + i]
        want, by_int = decode_step(cfg, params, by_int, tok, S + i)
        got, by_tensor = decode_step(cfg, params, by_tensor, tok,
                                     torch.tensor([S + i], dtype=dtype))
        assert torch.equal(got, want)
    assert by_int.keys() == by_tensor.keys()
    for k in by_int:
        assert torch.equal(by_tensor[k], by_int[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_matches_reference_at_a_traced_position(arch):
    """float32 SMOKE: prefill and STEPS decode steps, the port's position a
    tensor and the reference's a ``jnp.int32``, fed the same tokens; logits
    within the model tests' decode-chain tolerance (1e-3)."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(2))
    params = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    toks = _tokens(cfg.vocab, seed=3)
    _, jcache0 = jt.prefill(jcfg, jparams, jnp.asarray(toks[:, :S]))
    _, cache = prefill(cfg, params, torch.from_numpy(toks[:, :S]).long(),
                       max_len=S + STEPS)
    jcache = jt.init_cache(jcfg, B, S + STEPS)
    if "k" in jcache:       # the reference engine's move into a longer cache
        jcache = {k: jcache[k].at[:, :, :, :S].set(jcache0[k]) for k in jcache}
    else:
        jcache = jcache0
    jstep = jax.jit(lambda p, c, t, pos: jt.decode_step(jcfg, p, c, t, pos))
    for i in range(STEPS):
        tok = toks[:, S + i]
        want, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        got, cache = decode_step(cfg, params, cache, torch.from_numpy(tok).long(),
                                 torch.tensor([S + i], dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3)


def test_position_refuses_what_is_not_one_integer():
    assert torch.equal(position(7, torch.device("cpu")), torch.tensor([7]))
    pos = torch.tensor([5])
    assert position(pos, torch.device("cpu")).data_ptr() == pos.data_ptr()
    with pytest.raises(ValueError, match="one integer"):
        position(torch.tensor([5.0]), torch.device("cpu"))
    with pytest.raises(ValueError, match="one integer"):
        position(torch.tensor([5, 6]), torch.device("cpu"))
    with pytest.raises(ValueError, match="on meta"):
        position(torch.empty(1, dtype=torch.int64, device="meta"),
                 torch.device("cpu"))


@pytest.mark.parametrize("kv_len", [0, 1, 29, 40])
def test_plain_decode_attention_takes_a_tensor_kv_len(kv_len):
    """kv_len 0 (no valid key), 1, a ragged length and S = 40: the plain
    version and the wrapper on CPU tensors give the same bits with an int
    and with a one-element int32 tensor (at kv_len 0 both are NaN: the
    plain version has no l == 0 guard, as the reference's has none)."""
    rng = np.random.default_rng(kv_len)
    q = torch.from_numpy(rng.standard_normal((2, 8, 32), dtype=np.float32)).bfloat16()
    cache = torch.from_numpy(
        rng.standard_normal((2, 40, 2, 32), dtype=np.float32)).bfloat16()
    k, v = cache.transpose(1, 2), cache.flip(1).transpose(1, 2)
    t = torch.tensor([kv_len], dtype=torch.int32)
    for fn in (lambda n: decode_attention_ref(q, k, v, n, return_lse=True),
               lambda n: decode_attention(q, k, v, n)):
        for got, want in zip(fn(t), fn(kv_len)):
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("bad,error,match", [
    (torch.tensor([3], dtype=torch.int64), TypeError, "int32"),
    (torch.tensor([3, 4], dtype=torch.int32), ValueError, "one value"),
    (torch.empty(1, dtype=torch.int32, device="meta"), ValueError, "on meta")])
def test_decode_attention_refuses_a_wrong_kv_len(bad, error, match):
    q = torch.zeros(1, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 16, 32, dtype=torch.bfloat16)
    with pytest.raises(error, match=match):
        decode_attention(q, k, k, bad)


def test_prefill_writes_into_a_given_cache():
    cfg = get_config("mistral_nemo_12b", smoke=True)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab)).long()[:, :S]
    want_logits, want = prefill(cfg, params, toks, max_len=S + 4)
    cache = {k: torch.full_like(v, 7) for k, v in want.items()}
    logits, got = prefill(cfg, params, toks, cache=cache)
    assert got is cache and torch.equal(logits, want_logits)
    assert torch.equal(got["k"][..., :S, :, :], want["k"][..., :S, :, :])
    assert bool((got["k"][..., S:, :, :] == 7).all())     # kept, not cleared
    with pytest.raises(ValueError, match="sequences"):
        prefill(cfg, params, toks[:1], cache=cache)
    with pytest.raises(ValueError, match="positions"):
        prefill(cfg, params, torch.cat([toks, toks], 1), cache=cache)


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "mamba2_130m"])
def test_engine_keeps_one_cache_per_batch_size(arch):
    """Two generate calls at one batch size reuse the cache that prefill
    writes (the address a captured step reads), give the same greedy tokens
    as a fresh engine, and the CPU captures nothing; a second batch size
    gets its own cache."""
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, seed=0, device="cpu")
    prompts = torch.from_numpy(_tokens(cfg.vocab, seed=5)).long()[:, :8]
    engine = ServeEngine(cfg, params, max_batch=2, max_len=16, device="cpu")
    first = engine.generate(prompts, n_tokens=4)
    cache = engine._slots[2].cache
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    other = engine.generate(prompts.flip(1), n_tokens=4)
    again = engine.generate(prompts, n_tokens=4)
    assert engine._slots[2].cache is cache
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert again.tokens == first.tokens and other.tokens != first.tokens
    fresh = ServeEngine(cfg, params, max_batch=2, max_len=16, device="cpu")
    assert fresh.generate(prompts, n_tokens=4).tokens == first.tokens
    engine.generate(prompts[:1], n_tokens=2)
    assert set(engine._slots) == {1, 2} and engine.captures == 0


def test_a_captured_launch_counts_on_its_graphs_tally(monkeypatch):
    """While a stream is capturing, a wrapper's launch goes to the tally of
    the graph being captured (each replay adds it), and with no counted
    graph open it is not counted at all; otherwise to the counter."""

    def wrapper():
        pass
    wrapper.launches = 0
    capturing = False
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    _build.launched(wrapper)
    assert wrapper.launches == 1
    capturing = True
    _build.launched(wrapper)                 # a timing capture: not counted
    tally: dict = {}
    _build._tallies.append(tally)
    try:
        _build.launched(wrapper)
        _build.launched(wrapper)
    finally:
        _build._tallies.pop()
    assert wrapper.launches == 1 and tally == {(wrapper, None): 2}
