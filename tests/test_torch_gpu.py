"""The port's CUDA kernels and model on the card (marked ``gpu``).

Each kernel is held against its plain PyTorch version on the same inputs on
the card, at serving and ragged shapes, element-wise within the bf16
tolerance of the reference's kernel tests (rtol = atol = 2e-2); decode
attention's outputs, averages over up to ~2000 values, are held within four
bf16 ulps of the largest reference output instead. The model on the card is held against the plain versions on the CPU. Without a card
every test here skips. Run them on a card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import (decode_attention, flash_attention,
                                 fused_rmsnorm, launches, reset_launches)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref
from repro_torch.launch.serve import run_serve
from repro_torch.models import decode_step, init_params, prefill, to_device

pytestmark = pytest.mark.gpu
SMOKE = get_config("mistral_nemo_12b", smoke=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, tol=2e-2):
    torch.cuda.synchronize()
    got, want = got.float().cpu(), want.float().cpu()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def _scaled_err(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("t,d", [(4, 5120), (300, 5120), (7, 100)])
def test_rmsnorm_kernel_matches_plain(cuda, t, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(t, d, generator=g, device=cuda).bfloat16()
    r = torch.randn(t, d, generator=g, device=cuda).bfloat16()
    w = torch.rand(d, generator=g, device=cuda) + 0.5
    n = fused_rmsnorm.launches
    y, res = fused_rmsnorm(x, w, r)
    assert fused_rmsnorm.launches == n + 1
    yr, resr = fused_rmsnorm_ref(x, w, r)
    _close(y, yr)
    _close(res, resr, 0.0)          # the same f32 sum, rounded once
    y0, res0 = fused_rmsnorm(x, w)
    _close(y0, fused_rmsnorm_ref(x, w)[0])
    _close(res0, x, 0.0)


@pytest.mark.parametrize("b,h,hkv,s,hd,kv_len", [
    (4, 32, 8, 2081, 128, 2079), (2, 4, 2, 37, 32, 37),
    (3, 8, 8, 300, 64, 1), (2, 8, 2, 50, 128, 0)])
def test_decode_kernel_matches_plain(cuda, b, h, hkv, s, hd, kv_len):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, h, hd, generator=g, device=cuda).bfloat16()
    cache_k = torch.randn(b, s, hkv, hd, generator=g, device=cuda).bfloat16()
    cache_v = torch.randn(b, s, hkv, hd, generator=g, device=cuda).bfloat16()
    k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    o, lse = decode_attention(q, k, v, kv_len)
    if kv_len == 0:                 # the kernel's l == 0 guard
        _close(o, torch.zeros_like(o), 0.0)
        assert bool((lse == -1e30).all())
        return
    orf, lser = decode_attention_ref(q, k, v, kv_len, return_lse=True)
    assert bool(torch.isfinite(o.float()).all())
    assert _scaled_err(o, orf) <= 2.0 ** -6
    _close(lse, lser, 1e-3)


def test_kernels_refuse_float32_on_the_card(cuda):
    q = torch.zeros(2, 8, 64, device=cuda)
    k = torch.zeros(2, 2, 90, 64, device=cuda)
    with pytest.raises(TypeError, match="decode_attention"):
        decode_attention(q, k, k, 77)
    with pytest.raises(TypeError, match="decode_attention"):
        decode_attention(q, k.bfloat16(), k.bfloat16(), 77)
    with pytest.raises(TypeError, match="fused_rmsnorm"):
        fused_rmsnorm(torch.zeros(4, 64, device=cuda),
                      torch.ones(64, device=cuda))


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal", [
    (2, 32, 8, 512, 512, 128, True), (1, 4, 2, 100, 100, 32, True),
    (1, 4, 1, 70, 130, 64, False), (2, 4, 2, 130, 70, 128, True)])
def test_flash_kernel_matches_plain(cuda, b, h, hkv, sq, sk, hd, causal):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(b, sq, h, hd, generator=g, device=cuda).bfloat16()
    k = torch.randn(b, sk, hkv, hd, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, sk, hkv, hd, generator=g, device=cuda).bfloat16()
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    n = flash_attention.launches
    out = flash_attention(*args, causal=causal)
    assert flash_attention.launches == n + 1
    assert out.shape == (b, h, sq, hd)
    _close(out, flash_attention_ref(*args, causal=causal))


def test_model_on_card_matches_cpu_and_counts_launches(cuda):
    """bf16 kernels on the card against the plain versions on the CPU, same
    weights and tokens; a prefill and one decode step launch each kernel
    the expected number of times."""
    cpu = init_params(SMOKE, seed=0, device="cpu")
    gpu = to_device(cpu, cuda)
    prompt = torch.randint(0, SMOKE.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(3))
    want, want_cache = prefill(SMOKE, cpu, prompt, max_len=14)
    reset_launches()
    got, cache = prefill(SMOKE, gpu, prompt.to(cuda), max_len=14)
    assert _scaled_err(got, want) <= 2e-2
    assert _scaled_err(cache["k"], want_cache["k"]) <= 2e-2
    tok = want[:, -1].argmax(-1)
    step, cache = decode_step(SMOKE, gpu, cache, tok.to(cuda), 12)
    torch.cuda.synchronize()
    n = SMOKE.n_layers
    assert launches() == {"rmsnorm": 2 * (1 + 2 * n), "flash_attention": n,
                          "decode_attention": n}
    want_step, want_cache = decode_step(SMOKE, cpu, want_cache, tok, 12)
    assert _scaled_err(step, want_step) <= 2e-2
    assert _scaled_err(cache["v"], want_cache["v"]) <= 2e-2


def test_run_serve_defaults_to_the_card(cuda):
    reset_launches()
    res = run_serve(SMOKE, requests=2, prompt_len=8, tokens=3)
    assert len(res.tokens) == 3
    assert launches()["decode_attention"] == SMOKE.n_layers * 2
