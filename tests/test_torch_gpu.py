"""The port's CUDA kernels, models and training step on the card (marked
``gpu``).

Each kernel is held against its plain PyTorch version on the same inputs on
the card, at serving and ragged shapes, element-wise within the bf16
tolerance of the reference's kernel tests (rtol = atol = 2e-2); decode
attention's outputs, averages over up to ~2000 values, are held within four
bf16 ulps of the largest reference output instead. The fused RMSNorm is
also held within one bf16 ulp of its f64 value, its new residual bit for
bit, and its gated form within one ulp of the unfused chain it replaces,
at the serving paths' six shapes and ragged ones. The SSD kernel computes
in f32 and is held to the reference's 2e-4 on y and the final state. The
models on the card are held against the plain versions on the CPU within
2e-2 of the largest logit, and the engine's captured decode step against
the eager one (identical tokens). The f64 pricing kernel must be
bit-identical to its plain version and to the numpy formula, and the f32
one within the drift band 1e-5 of the f64 reference. The training kernels
(the forward with LSE, dK/dV, dQ) and the gradients through
``flash_attention_train`` are held within 2e-2 of the largest plain value,
and a training step on the card against the same step on the CPU. The
RMSNorm's backward kernel is held against its plain version within the
bf16 tolerance, dw within 1e-4 of its largest value (f32 sums over rows in
another order), and two calls bit-identical.
Cross-attention runs through the flash forward without the mask and
through decode attention over the whole memory, held to the plain
versions within 2e-2 of the largest value; the engine serves a memory
through its captured graph. The kernels' contract: hd 16 in bf16 as the
bf16 cases are held, float32 at the reference's 2e-5 (forward) and 2e-4
(backward), decode over a float32 model's bf16 cache, RMSNorm and its
backward in float32; float16 and hd 8 raise. The float32 decode kernel is
also replayed from one captured launch with kv_len changed on the card, and
the float32 dQ, forward and dK/dV hold their tolerances with the backward's
bits the same across two calls. The hd-64 serving forward and decode (kernels
of their own) are held at SeamlessM4T's shapes and their tiles' and items'
edges, two calls the same bits, the decode replayed across its 64-key tiles'
edges with each replay timed. Without a card every
test here skips. Run them on a card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import DSEEngine
from repro_torch.core.pricing import (_price, _roofline, price_plans,
                                      stack_plans)
from repro_torch.kernels import (decode_attention, flash_attention,
                                 flash_attention_bwd_dkv,
                                 flash_attention_bwd_dq,
                                 flash_attention_fwd_lse,
                                 flash_attention_train, fused_rmsnorm,
                                 fused_rmsnorm_bwd, launches, launches_by_kind,
                                 reset_launches,
                                 ssd_chunk)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ref import (
    attention_delta, flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
    flash_attention_bwd_ref, flash_attention_fwd_lse_ref, flash_attention_ref)
from repro_torch.kernels.pricing import (certify, certify_f32, pricing_f32,
                                         pricing_f64)
from repro_torch.kernels.pricing.ops import f32_drift
from repro_torch.kernels.pricing.ref import (FORMULAS, edge_plan_vectors,
                                             pricing_ref,
                                             random_plan_vectors,
                                             random_roofline_columns)
from repro_torch.kernels.rmsnorm.ref import (fused_rmsnorm_bwd_ref,
                                             fused_rmsnorm_ref)
from repro_torch.kernels.ssd.ref import ssd_scan_ref
from repro_torch.launch.serve import run_serve
from repro_torch.models import (decode_step, init_params, param_dtype,
                                prefill, synth_batch, to_device)
from repro_torch.train import AdamWConfig, adamw_init, make_train_step
from repro_torch.train.optimizer import tree_leaves

pytestmark = pytest.mark.gpu
SMOKE = get_config("mistral_nemo_12b", smoke=True)
SSM_SMOKE = get_config("mamba2_130m", smoke=True)


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


def _row_scaled_err(got, want) -> float:
    """The worst row's max |got - want| over that row's max |want| (rows
    along the last dimension), each row's scale at least 1e-3 of the
    tensor's (dq at causal query 0 is zero by cancellation). Causal
    attention's rows differ in size by orders of magnitude, so a scale
    taken over the whole tensor would hide a dropped tile deep in the
    sequence."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs()
    return ((got - want).abs().amax(-1)
            / scale.amax(-1).clamp_min(1e-3 * scale.max())).max().item()


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


def _rmsnorm_case(cuda, rows, d, kind, seed=0):
    """Seeded inputs of one RMSNorm call: bf16 x and r ("residual"), bf16 x
    alone ("plain"), or the f32 y and a bf16 gate sliced out of a wider
    tensor as the Mamba2 layer passes it ("gated")."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.rand(d, generator=g, device=cuda) + 0.5
    x = torch.randn(rows, d, generator=g, device=cuda)
    if kind == "gated":
        z = (2 * torch.randn(rows, 2 * d + 280, generator=g, device=cuda)).bfloat16()[:, :d]
        return x, w, dict(gate=z)
    r = torch.randn(rows, d, generator=g, device=cuda).bfloat16()
    return x.bfloat16(), w, dict(residual=r if kind == "residual" else None)


def _ulps_from(got, want64):
    """|got - want| in bf16 ulps at want (8 significant bits)."""
    ulp = torch.exp2(torch.floor(torch.log2(want64.abs().clamp_min(1e-30))) - 7)
    return ((got.double() - want64).abs() / ulp).max().item()


@pytest.mark.parametrize("rows,d,kind", [
    (4, 5120, "residual"), (8192, 5120, "residual"), (8, 768, "residual"),
    (8, 1536, "gated"), (16384, 768, "residual"), (16384, 1536, "gated"),
    (4, 5120, "plain"), (7, 100, "residual"), (3, 770, "residual"),
    (7, 100, "gated"), (3, 770, "gated")])
def test_rmsnorm_kernel_within_one_ulp_of_f64(cuda, rows, d, kind):
    """y within TOL of the plain version and within one bf16 ulp of its f64
    value from the same bf16 inputs (a dropped warp's partial sum, 1/20 of
    it at d 5120, moves y ~2.6 %: many ulps); the new residual
    bit-identical to bf16(f32(x) + f32(r)); the gated norm from the chain's
    g (the cast, F.silu, the product, on the card) and within one ulp of
    the chain's norm; one launch counted."""
    import torch.nn.functional as F

    x, w, kw = _rmsnorm_case(cuda, rows, d, kind)
    n = fused_rmsnorm.launches
    y, rout = fused_rmsnorm(x, w, **kw)
    assert fused_rmsnorm.launches == n + 1
    if kind == "gated":
        g = x.bfloat16() * F.silu(kw["gate"])
        s = g.double()
        assert rout is None
        chain = fused_rmsnorm(g, w)[0]
        assert _ulps_from(y, chain.double()) <= 1
    else:
        r = kw["residual"]
        want = x.float() + (r.float() if r is not None else 0.0)
        assert torch.equal(rout, want.bfloat16())
        s = x.double() + (r.double() if r is not None else 0.0)
    y64 = s * torch.rsqrt((s * s).mean(-1, keepdim=True) + 1e-6) * w.double()
    _close(y, fused_rmsnorm_ref(x, w, **kw)[0])
    assert _ulps_from(y, y64) <= 1


def test_rmsnorm_plan_switches_at_the_measured_row_count(cuda):
    """One block a row up to 128 rows (the decode design), then a one-wave
    grid of at most 256 threads a block; odd widths, gated too, on the
    scalar path."""
    from repro_torch.kernels.rmsnorm.ops import plan

    few, many = plan(128, 5120), plan(129, 5120)
    assert (few["grid"], few["threads"], few["vectors_per_thread"]) == (128, 640, 1)
    assert many["threads"] <= 256 and many["grid"] <= 129
    assert plan(4, 1536, gated=True)["grid"] == 4
    assert plan(16384, 768)["vectors_per_thread"] == 1
    for gated in (False, True):
        assert plan(7, 100, gated=gated, vec=False) == dict(
            grid=7, threads=32, vectors_per_thread=4, vector=1)


def test_rmsnorm_kernel_refuses_what_it_does_not_take(cuda):
    bf = torch.bfloat16
    z = torch.ones(4, 64, dtype=bf, device=cuda)
    with pytest.raises(TypeError, match="fused_rmsnorm"):      # gated: x f32, z bf16
        fused_rmsnorm(torch.ones(4, 64, dtype=bf, device=cuda), torch.ones(64, device=cuda),
                      gate=z)
    with pytest.raises(TypeError, match="fused_rmsnorm"):
        fused_rmsnorm(torch.ones(4, 64, device=cuda), torch.ones(64, device=cuda),
                      gate=z.half())
    with pytest.raises(ValueError, match="wider than the kernel takes"):   # f32 at 12296
        fused_rmsnorm(torch.ones(2, 12296, device=cuda), torch.ones(12296, device=cuda))
    for d, kw in ((16392, {}), (4100, {}), (8200, {"gated": True})):
        x = torch.ones(2, d, dtype=torch.float32 if kw else bf, device=cuda)
        gate = dict(gate=torch.ones(2, d, dtype=bf, device=cuda)) if kw else {}
        with pytest.raises(ValueError, match="wider than the kernel takes"):
            fused_rmsnorm(x, torch.ones(d, device=cuda), **gate)


@pytest.mark.parametrize("b,h,hkv,s,hd,kv_len", [
    (4, 32, 8, 2081, 128, 2079), (2, 4, 2, 37, 32, 37),
    (3, 8, 8, 300, 64, 1), (2, 8, 2, 50, 128, 0),
    # GQA group 3 (minitron_4b), compiled as it is; groups 16
    # (qwen3_moe_235b) and 5, in chunks of 8 query heads
    (4, 24, 8, 2081, 128, 2079), (2, 6, 2, 50, 64, 33),
    (2, 64, 4, 600, 128, 577), (1, 10, 2, 90, 32, 90)])
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


@pytest.mark.parametrize("b,h,hkv,s,hd", [
    (4, 32, 8, 2081, 128),      # mistral_nemo_12b's serving cache
    (4, 24, 8, 2081, 128),      # GQA group 3 (minitron_4b)
    (2, 64, 4, 600, 128)])      # GQA group 16 (qwen3_moe_235b), in chunks
def test_decode_kernel_replayed_with_kv_len_changed_on_the_card(cuda, b, h, hkv, s, hd):
    """One launch captured in a CUDA graph with a device kv_len, replayed
    with kv_len set on the device between replays (0, 1, ragged, S, past S):
    each replay matches the plain version at that length, and the kernel
    counts one launch per replay through a counted graph."""
    from repro_torch.kernels._build import CountedGraph
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(b, h, hd, generator=g, device=cuda).bfloat16()
    k = torch.randn(b, s, hkv, hd, generator=g, device=cuda).bfloat16().transpose(1, 2)
    v = torch.randn(b, s, hkv, hd, generator=g, device=cuda).bfloat16().transpose(1, 2)
    kl = torch.full((1,), 5, dtype=torch.int32, device=cuda)
    decode_attention(q, k, v, kl)           # warm: builds the kernel
    graph = CountedGraph()
    with graph.capture():
        o, lse = decode_attention(q, k, v, kl)
    n = decode_attention.launches
    for i, kv_len in enumerate((0, 1, 37, s // 2, s, s + 50)):
        kl.fill_(kv_len)
        graph.replay()
        assert decode_attention.launches == n + i + 1
        if kv_len == 0:
            _close(o, torch.zeros_like(o), 0.0)
            assert bool((lse == -1e30).all())
            continue
        orf, lser = decode_attention_ref(q, k, v, min(kv_len, s), return_lse=True)
        assert _scaled_err(o, orf) <= 2.0 ** -6
        _close(lse, lser, 1e-3)


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "mamba2_130m",
                                  "jamba_v01_52b"])
def test_engine_graph_tokens_match_eager_decode(cuda, arch):
    """The engine on the card captures the decode step once and replays it:
    its greedy tokens and logits equal decode_step called eagerly, a warm
    generate captures nothing, and the launch counters count the replays
    (decode attention: one per attention layer and decode step)."""
    cfg = get_config(arch, smoke=True)
    from repro_torch.serve import ServeEngine
    params = init_params(cfg, seed=0, device=cuda)
    prompts = torch.randint(0, cfg.vocab, (2, 8), device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(9))
    engine = ServeEngine(cfg, params, max_batch=2, max_len=16)
    reset_launches()
    first = engine.generate(prompts, n_tokens=6)
    assert engine.captures == 1
    n_attn = sum(cfg.layer_kind(i % cfg.block_size) == "attn"
                 for i in range(cfg.n_layers))
    assert launches()["decode_attention"] == n_attn * 5
    again = engine.generate(prompts, n_tokens=6)
    assert engine.captures == 1 and again.tokens == first.tokens
    with torch.no_grad():
        logits, cache = prefill(cfg, params, prompts, max_len=16)
        tok = logits[:, -1].argmax(-1)
        eager = [tok.tolist()]
        for i in range(5):
            lg, cache = decode_step(cfg, params, cache, tok, 8 + i)
            tok = lg.argmax(-1)
            eager.append(tok.tolist())
    assert first.tokens == eager


@pytest.mark.parametrize("arch", ["llama32_vision_11b", "seamless_m4t_medium"])
def test_cross_attention_kernels_match_plain(cuda, arch):
    """Cross-attention at SMOKE size through the flash forward without the
    mask (a sequence of queries) and through decode attention over every
    memory key (one query), each one launch, against the plain versions
    on the CPU on the same bf16 inputs."""
    from repro_torch.models import layers as L
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = L.init_attention(gen, cfg, torch.bfloat16, cuda)
    m = cfg.n_image_tokens or cfg.n_audio_frames
    x = torch.randn(2, 12, cfg.d_model, generator=gen, device=cuda).bfloat16()
    mem = torch.randn(2, m, cfg.d_model, generator=gen, device=cuda).bfloat16()
    cpu = {k: v.cpu() for k, v in p.items()}
    mem_len = torch.tensor([m], dtype=torch.int32)
    reset_launches()
    with torch.no_grad():
        got = L.cross_attention(p, x, mem, cfg)
        one = L.decode_cross_attention(p, x[:, -1:], mem, cfg, mem_len.to(cuda))
    assert launches()["flash_attention"] == 1 and launches()["decode_attention"] == 1
    want = L.cross_attention(cpu, x.cpu(), mem.cpu(), cfg)
    assert _scaled_err(got, want) <= 2e-2
    assert _scaled_err(one, L.decode_cross_attention(
        cpu, x[:, -1:].cpu(), mem.cpu(), cfg, mem_len)) <= 2e-2
    assert _scaled_err(one, want[:, -1:]) <= 2e-2


def test_engine_with_memory_replays_its_graph(cuda):
    """The VLM SMOKE engine with a memory: graph tokens equal eager
    decode_step calls with that memory, and a second memory of the same
    shape is served by the same captured graph (no new capture) with that
    memory's tokens."""
    from repro_torch.serve import ServeEngine
    cfg = get_config("llama32_vision_11b", smoke=True)
    params = init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    prompts = torch.randint(0, cfg.vocab, (2, 8), device=cuda, generator=gen)
    engine = ServeEngine(cfg, params, max_batch=2, max_len=16)
    for i in range(2):
        mem = torch.randn(2, cfg.n_image_tokens, cfg.d_model, generator=gen,
                          device=cuda).bfloat16()
        got = engine.generate(prompts, n_tokens=6, memory=mem).tokens
        assert engine.captures == 1
        with torch.no_grad():
            logits, cache = prefill(cfg, params, prompts, max_len=16, memory=mem)
            tok = logits[:, -1].argmax(-1)
            eager = [tok.tolist()]
            for j in range(5):
                lg, cache = decode_step(cfg, params, cache, tok, 8 + j, memory=mem)
                tok = lg.argmax(-1)
                eager.append(tok.tolist())
        assert got == eager, i


def test_engine_raises_when_the_step_cannot_be_captured(cuda, monkeypatch):
    """A step that reads a value on the host cannot be captured: the engine
    raises instead of decoding eagerly."""
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import engine as engine_mod
    step = engine_mod.decode_step

    def host_reading_step(cfg, params, cache, token, pos, *memory):
        if torch.cuda.is_current_stream_capturing():
            int(pos.sum())
        return step(cfg, params, cache, token, pos, *memory)
    monkeypatch.setattr(engine_mod, "decode_step", host_reading_step)
    engine = ServeEngine(SMOKE, init_params(SMOKE, seed=0, device=cuda),
                         max_batch=1, max_len=16)
    with pytest.raises(RuntimeError, match="does not decode eagerly"):
        engine.generate(torch.zeros((1, 8), dtype=torch.int64, device=cuda), n_tokens=3)


def test_kernels_refuse_float32_on_the_card(cuda):
    """What the kernels refuse on the card: float32 is taken since the
    float32 kernels came (a bf16 q over an f32 cache is not), float16 and
    other dtypes raise."""
    q = torch.zeros(2, 8, 64, device=cuda)
    k = torch.zeros(2, 2, 90, 64, device=cuda)
    with pytest.raises(TypeError, match="decode_attention"):
        decode_attention(q.half(), k.half(), k.half(), 77)
    with pytest.raises(TypeError, match="decode_attention"):
        decode_attention(q.bfloat16(), k, k, 77)
    with pytest.raises(TypeError, match="fused_rmsnorm"):
        fused_rmsnorm(torch.zeros(4, 64, device=cuda).half(),
                      torch.ones(64, device=cuda))
    with pytest.raises(ValueError, match="hd 8"):
        decode_attention(q[..., :8], k[..., :8], k[..., :8], 77)


# the serving forward's shapes: its 128-row blocks and 128-key tiles end
# at 127, 128, 129 and 257; Sq > Sk causal; n_rep 1, 2, 4; hd 32, 64, 128
FLASH_SHAPES = [(2, 32, 8, 512, 512, 128, True), (1, 4, 2, 100, 100, 32, True),
                (1, 4, 1, 70, 130, 64, False), (2, 4, 2, 130, 70, 128, True),
                (1, 8, 2, 127, 127, 128, True), (1, 8, 2, 128, 128, 64, True),
                (1, 8, 2, 129, 129, 32, True), (1, 8, 2, 257, 257, 128, True),
                (1, 8, 8, 257, 257, 64, False), (1, 8, 2, 300, 129, 128, True),
                (1, 4, 1, 129, 257, 32, False),
                (2, 24, 8, 2048, 2048, 128, True)]   # minitron_4b's prefill, group 3


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal", FLASH_SHAPES)
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
    want = flash_attention_ref(*args, causal=causal)
    _close(out, want)
    assert _row_scaled_err(out, want) <= 2e-2


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
    assert launches() == {**dict.fromkeys(launches(), 0),
                          "rmsnorm": 2 * (1 + 2 * n), "flash_attention": n,
                          "decode_attention": n}
    want_step, want_cache = decode_step(SMOKE, cpu, want_cache, tok, 12)
    assert _scaled_err(step, want_step) <= 2e-2
    assert _scaled_err(cache["v"], want_cache["v"]) <= 2e-2


def test_minitron_serves_on_the_card(cuda):
    """minitron_4b (GQA group 3) at full width, its depth cut to 2 layers
    (its SMOKE config's hd 16 is not a kernel's): run_serve decodes through
    the kernels, and the first decode step's logits match a prefill over
    the same tokens."""
    import dataclasses
    cfg = dataclasses.replace(get_config("minitron_4b"), n_layers=2)
    assert cfg.n_heads // cfg.n_kv_heads == 3 and cfg.hd == 128
    reset_launches()
    res = run_serve(cfg, requests=2, prompt_len=64, tokens=3)
    assert len(res.tokens) == 3
    assert launches()["decode_attention"] == cfg.n_layers * 2
    assert launches()["flash_attention"] == cfg.n_layers
    params = init_params(cfg, seed=0, device=cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 64), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(8))
    with torch.no_grad():
        logits, cache = prefill(cfg, params, prompt, max_len=66)
        tok = logits[:, -1].argmax(-1)
        step, _ = decode_step(cfg, params, cache, tok, 64)
        want, _ = prefill(cfg, params, torch.cat([prompt, tok[:, None]], 1))
    assert bool(torch.isfinite(step.float()).all())
    assert _scaled_err(step, want[:, -1]) <= 2e-2


def test_run_serve_defaults_to_the_card(cuda):
    reset_launches()
    res = run_serve(SMOKE, requests=2, prompt_len=8, tokens=3)
    assert len(res.tokens) == 3
    assert launches()["decode_attention"] == SMOKE.n_layers * 2


@pytest.mark.parametrize("b,s,h,p,n,dtype,model", [
    (8, 2048, 24, 64, 128, torch.bfloat16, True),   # mamba2_130m serving
    (2, 100, 3, 64, 128, torch.bfloat16, True),     # ragged
    (2, 300, 4, 16, 32, torch.float32, True),       # P != N
    (2, 300, 4, 40, 72, torch.bfloat16, True),      # warps and N not filled
    (2, 300, 4, 40, 72, torch.float32, True),
    (48, 512, 0, 64, 128, torch.float32, False),    # the Pallas layout
    (1, 256, 0, 128, 128, torch.float32, False)])
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, dtype, model):
    g = torch.Generator(device=cuda).manual_seed(4)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=cuda)
    lead = (b, s, h) if model else (b, s)
    dt = torch.nn.functional.softplus(randn(*lead))
    x = randn(*lead, p).to(dtype)
    if model:    # B/C shared by the heads, read at head stride 0
        Bm, Cm = (randn(b, s, 1, n, scale=0.3).to(dtype).expand(b, s, h, n)
                  for _ in range(2))
        dA = dt * -torch.exp(randn(h, scale=0.5))
    else:
        Bm, Cm = (randn(b, s, n, scale=0.3).to(dtype) for _ in range(2))
        dA = -0.1 * dt
    before = ssd_chunk.launches
    y, state = ssd_chunk(x, dt, Bm, Cm, dA)
    assert ssd_chunk.launches == before + 1
    assert y.shape == x.shape and y.dtype == state.dtype == torch.float32
    if model:
        yr, sr = ssd_scan_ref(*(t.transpose(1, 2) for t in (x, dt, Bm, Cm, dA)))
        yr = yr.transpose(1, 2)
        assert state.shape == (b, h, p, n)
    else:
        yr, sr = ssd_scan_ref(x, dt, Bm, Cm, dA)
        assert state.shape == (b, p, n)
    _close(y, yr, 2e-4)
    _close(state, sr, 2e-4)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 64, 256, device=cuda)
    dt = torch.zeros(2, 64, device=cuda)
    bc = torch.zeros(2, 64, 16, device=cuda)
    with pytest.raises(ValueError, match="P <= 128"):
        ssd_chunk(x, dt, bc, bc, dt)
    with pytest.raises(TypeError, match="ssd_chunk"):
        ssd_chunk(x[..., :64], dt, bc.bfloat16(), bc, dt)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(x[..., :64], dt.bfloat16(), bc, bc, dt)


def test_mamba2_model_on_card_matches_cpu_and_counts_launches(cuda):
    """bf16 kernels on the card against the plain versions on the CPU, same
    weights and tokens; a prefill launches the SSD kernel once per layer and
    a decode step not at all, and each pass the norm 1 + 2L times."""
    cpu = init_params(SSM_SMOKE, seed=0, device="cpu")
    gpu = to_device(cpu, cuda)
    prompt = torch.randint(0, SSM_SMOKE.vocab, (2, 100),
                           generator=torch.Generator().manual_seed(5))
    want, want_cache = prefill(SSM_SMOKE, cpu, prompt, max_len=102)
    reset_launches()
    got, cache = prefill(SSM_SMOKE, gpu, prompt.to(cuda), max_len=102)
    assert _scaled_err(got, want) <= 2e-2
    assert _scaled_err(cache["ssm"], want_cache["ssm"]) <= 2e-2
    tok = want[:, -1].argmax(-1)
    step, cache = decode_step(SSM_SMOKE, gpu, cache, tok.to(cuda), 100)
    torch.cuda.synchronize()
    n = SSM_SMOKE.n_layers
    assert launches() == {**dict.fromkeys(launches(), 0),
                          "rmsnorm": 2 * (1 + 2 * n), "ssd": n}
    want_step, want_cache = decode_step(SSM_SMOKE, cpu, want_cache, tok, 100)
    assert _scaled_err(step, want_step) <= 2e-2
    assert _scaled_err(cache["conv"], want_cache["conv"]) <= 2e-2


def test_run_serve_mamba2_defaults_to_the_card(cuda):
    reset_launches()
    res = run_serve(SSM_SMOKE, requests=2, prompt_len=8, tokens=3)
    assert len(res.tokens) == 3
    assert launches()["ssd"] == SSM_SMOKE.n_layers


def _pricing_inputs(entry: str, n: int) -> dict[str, np.ndarray]:
    if entry == "roofline":
        return random_roofline_columns(n, seed=1)
    finite, special = edge_plan_vectors()
    return stack_plans(random_plan_vectors(n, seed=1) + finite + special)


def _stack(entry: str, cols, device) -> torch.Tensor:
    names = FORMULAS[entry][1]
    return torch.from_numpy(np.stack([cols[k] for k in names])).to(device)


@pytest.mark.parametrize("entry", ["price", "roofline"])
@pytest.mark.parametrize("n", [1, 255, 4099])
def test_pricing_f64_kernel_bit_identical(cuda, entry, n):
    cols = _pricing_inputs(entry, n)
    x = _stack(entry, cols, cuda)
    before = pricing_f64.launches
    y = pricing_f64(x, entry)
    assert pricing_f64.launches == before + 1
    torch.cuda.synchronize()
    plain = pricing_ref(x, entry)
    got = y.cpu().numpy().view(np.uint64)
    assert np.array_equal(got, plain.cpu().numpy().view(np.uint64))
    formula = _price if entry == "price" else _roofline
    with np.errstate(all="ignore"):
        want = formula(np, cols)
    for k, name in enumerate(FORMULAS[entry][2]):
        w = np.asarray(want[name], dtype=np.float64)
        assert np.array_equal(got[k], w.view(np.uint64)), name


@pytest.mark.parametrize("entry", ["price", "roofline"])
def test_pricing_f32_kernel_within_band(cuda, entry):
    cols = _pricing_inputs(entry, 5000)
    if entry == "price":
        cols = stack_plans(random_plan_vectors(5000, seed=2))
    x = _stack(entry, cols, cuda)
    before = pricing_f32.launches
    y = pricing_f32(x, entry)
    assert pricing_f32.launches == before + 1 and y.dtype == torch.float32
    outs, bools = FORMULAS[entry][2], FORMULAS[entry][3]
    got = {name: y[k].cpu().numpy() != 0 if name in bools
           else y[k].cpu().numpy() for k, name in enumerate(outs)}
    want = (_price if entry == "price" else _roofline)(np, cols)
    drifts = f32_drift(got, want, cols.get("mem_capacity", 1.0))
    assert max(drifts.values()) <= 1e-5, drifts
    # against its plain f32 version: a few f32 ulps (FMA contraction only)
    plain = pricing_ref(x, entry, f32=True).cpu().numpy()
    vs_plain = f32_drift(got, {
        name: plain[k] != 0 if name in bools else plain[k].astype(np.float64)
        for k, name in enumerate(outs)}, cols.get("mem_capacity", 1.0))
    assert max(vs_plain.values()) <= 2.0 ** -19, vs_plain


def test_pricing_certify_harnesses_on_the_card(cuda):
    assert certify(n=512, device=cuda)["bit_identical"]
    assert certify_f32(n=512, device=cuda)["max_drift"] <= 1e-5


def test_pricing_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="float64"):
        pricing_f64(torch.zeros(25, 8, device=cuda, dtype=torch.float32))
    with pytest.raises(ValueError, match="float64"):
        pricing_f64(torch.zeros(24, 8, device=cuda, dtype=torch.float64))


def test_price_plans_one_launch_per_call(cuda):
    cols = stack_plans(random_plan_vectors(300, seed=3))
    before = pricing_f64.launches, pricing_f32.launches
    a = price_plans(cols, backend="kernel", device=cuda)
    b = price_plans(cols, backend="kernel-f32", device=cuda)
    assert (pricing_f64.launches, pricing_f32.launches) == (
        before[0] + 1, before[1] + 1)
    want = price_plans(cols, backend="numpy")
    for key in want:
        if key == "feasible":
            assert np.array_equal(a[key], want[key])
        else:
            assert np.array_equal(a[key].view(np.uint64),
                                  want[key].view(np.uint64)), key
    assert b["iter_time"].dtype == np.float32


def test_dse_sweep_on_the_card_matches_numpy(cuda):
    want = DSEEngine(parallel=False, pricing_backend="numpy").sweep_scenario(
        "llm", smoke=True).rows()
    for backend in ("kernel", "kernel-f32", "torch"):
        got = DSEEngine(parallel=False, pricing_backend=backend
                        ).sweep_scenario("llm", smoke=True).rows()
        assert got == want, backend


# ------------------------------ training path ---------------------------------
TRAIN_SHAPES = [(2, 16, 16, 512, 512, 128, True),     # olmo heads, causal
                (2, 24, 8, 1000, 1000, 128, True),    # GQA, ragged
                (1, 8, 2, 70, 130, 64, False),        # full, Sq != Sk
                (2, 4, 2, 130, 70, 32, True),         # Sq > Sk, top-left
                (1, 4, 4, 96, 96, 64, False),
                # the forward's 128-row / 128-key tile edges, n_rep 4
                (1, 8, 2, 127, 127, 128, True), (1, 8, 2, 129, 129, 64, True),
                (1, 8, 2, 257, 257, 32, True), (1, 8, 2, 128, 128, 128, False),
                (1, 8, 2, 300, 129, 128, True)]


def _train_inputs(cuda, b, h, hkv, sq, sk, hd, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):    # the model's (B, S, heads, hd) layout, transposed
        return torch.randn(shape, generator=g, device=cuda).bfloat16().transpose(1, 2)
    return (randn(b, sq, h, hd), randn(b, sk, hkv, hd), randn(b, sk, hkv, hd),
            randn(b, sq, h, hd))


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal", TRAIN_SHAPES)
def test_flash_training_kernels_match_plain(cuda, b, h, hkv, sq, sk, hd,
                                            causal):
    q, k, v, do = _train_inputs(cuda, b, h, hkv, sq, sk, hd)
    n = dict(launches())
    o, lse = flash_attention_fwd_lse(q, k, v, causal)
    orf, lser = flash_attention_fwd_lse_ref(q, k, v, causal)
    assert o.shape == (b, h, sq, hd) and lse.shape == (b, h, sq)
    _close(o, orf)
    assert _row_scaled_err(o, orf) <= 2e-2
    _close(lse, lser, 1e-3)
    dd = attention_delta(orf, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
    dq = flash_attention_bwd_dq(q, k, v, do, lser, dd, causal)
    dkr, dvr = flash_attention_bwd_dkv_ref(q, k, v, do, lser, dd, causal)
    dqr = flash_attention_bwd_dq_ref(q, k, v, do, lser, dd, causal)
    for got, want in ((dq, dqr), (dk, dkr), (dv, dvr)):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all())
        assert _scaled_err(got, want) <= 2e-2
        assert _row_scaled_err(got, want) <= 2e-2
    c = launches()
    assert [c[f"flash_attention_{k}"] - n[f"flash_attention_{k}"]
            for k in ("fwd_lse", "bwd_dkv", "bwd_dq")] == [1, 1, 1]


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal", TRAIN_SHAPES)
def test_flash_backward_is_bit_identical_across_calls(cuda, b, h, hkv, sq, sk,
                                                     hd, causal):
    """No atomics: one thread sums each dK, dV and dQ element in one order,
    so two calls give the same bits."""
    q, k, v, do = _train_inputs(cuda, b, h, hkv, sq, sk, hd, seed=7)
    o, lse = flash_attention_fwd_lse(q, k, v, causal)
    dd = attention_delta(o, do)
    first = (*flash_attention_bwd_dkv(q, k, v, do, lse, dd, causal),
             flash_attention_bwd_dq(q, k, v, do, lse, dd, causal))
    second = (*flash_attention_bwd_dkv(q, k, v, do, lse, dd, causal),
              flash_attention_bwd_dq(q, k, v, do, lse, dd, causal))
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert bool(torch.isfinite(a.float()).all())
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal", TRAIN_SHAPES[1:4])
def test_flash_attention_train_grads_match_plain(cuda, b, h, hkv, sq, sk, hd,
                                                 causal):
    """Gradients through the autograd Function (kernels) against autograd
    through the plain forward, both from the same bf16 inputs, and, row by
    row, against the plain FA-2 backward given the card's own forward
    output and LSE. The FA-2 backward takes D = rowsum(dO * o) from the
    bf16 output, so it differs from autograd, and from the same formula
    fed another rounding of o, most in early causal rows, whose gradient
    nearly cancels: only identical inputs are held row by row."""
    *qkv, g = _train_inputs(cuda, b, h, hkv, sq, sk, hd, seed=6)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in qkv]
        (fn(*leaves, causal=causal).float() * g.float()).sum().backward()
        return [t.grad for t in leaves]

    o, lse = flash_attention_fwd_lse(*qkv, causal)
    plain = flash_attention_bwd_ref(*qkv, o, lse, g, causal)
    for got, want, same in zip(grads(flash_attention_train),
                               grads(flash_attention_ref), plain):
        assert got.dtype == torch.bfloat16
        assert _scaled_err(got, want) <= 2e-2
        assert _row_scaled_err(got, same) <= 2e-2


def test_training_kernels_refuse_float32(cuda):
    """float32 is taken since the float32 kernels came; float16 raises."""
    q = torch.zeros(1, 2, 64, 64, device=cuda).half()
    rows = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="flash_attention_fwd_lse"):
        flash_attention_fwd_lse(q, q, q)
    with pytest.raises(TypeError, match="flash_attention_bwd_dkv"):
        flash_attention_bwd_dkv(q, q, q, q, rows, rows)
    with pytest.raises(TypeError, match="flash_attention_bwd_dq"):
        flash_attention_bwd_dq(q, q, q, q, rows, rows)


def test_forward_only_kernels_refuse_autograd(cuda):
    """The serving flash forward and decode attention refuse autograd; the
    fused RMSNorm and the SSD scan return gradients (the norm's through its
    backward kernel, the scan's through its plain backward)."""
    q = torch.randn(1, 2, 64, 64, device=cuda).bfloat16().requires_grad_(True)
    kv = torch.randn(1, 2, 64, 64, device=cuda).bfloat16()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, kv, kv)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q[:, :, 0], kv, kv, 10)
    with torch.no_grad():
        flash_attention(q, kv, kv)
    x = torch.randn(4, 64, device=cuda).bfloat16().requires_grad_(True)
    w = torch.ones(64, device=cuda, requires_grad=True)
    n = fused_rmsnorm_bwd.launches
    fused_rmsnorm(x, w)[0].float().sum().backward()
    assert fused_rmsnorm_bwd.launches == n + 1
    assert bool(torch.isfinite(x.grad.float()).all()) and w.grad.shape == (64,)
    y = torch.randn(2, 64, 4, device=cuda, requires_grad=True)
    dt = torch.rand(2, 64, device=cuda, requires_grad=True)
    out, _ = ssd_chunk(y, dt, y, y, -dt)
    out.sum().backward()
    assert bool(torch.isfinite(y.grad).all()) and bool(dt.grad.abs().sum() > 0)


@pytest.mark.parametrize("rows,d,kind", [(16384, 768, "residual"), (16384, 1536, "gated"),
                                         (4096, 5120, "residual"), (4096, 5120, "plain"),
                                         (7, 100, "residual"), (7, 100, "gated"),
                                         (3, 770, "plain")])
def test_rmsnorm_backward_kernel_matches_plain(cuda, rows, d, kind):
    """The backward kernel at the training shapes (mamba2 8 x 2048, mistral
    2 x 2048) and on the scalar path, against its plain version on the same
    inputs, two calls bit-identical, one count a call."""
    x, w, kw = _rmsnorm_case(cuda, rows, d, kind, seed=3)
    g = torch.Generator(device=cuda).manual_seed(4)
    dh = torch.randn(rows, d, generator=g, device=cuda).bfloat16()
    dr = None if kind == "gated" else torch.randn(rows, d, generator=g, device=cuda).bfloat16()
    args = (dh, dr, x, w, kw.get("residual"), 1e-6, kw.get("gate"))
    n = fused_rmsnorm_bwd.launches
    got = fused_rmsnorm_bwd(*args)
    again = fused_rmsnorm_bwd(*args)
    assert fused_rmsnorm_bwd.launches == n + 2
    want = fused_rmsnorm_bwd_ref(*args)
    for a, b, c in zip(got, again, want):
        assert (a is None) == (b is None) == (c is None)
        if a is not None:
            assert torch.equal(a, b) and a.dtype == c.dtype and a.shape == c.shape
    _close(got[0], want[0])
    if kind == "gated":
        _close(got[1], want[1])
        assert got[1].is_contiguous()
    assert _scaled_err(got[2], want[2]) <= 1e-4


@pytest.mark.parametrize("arch", ["olmo_1b", "seamless_m4t_medium", "mistral_nemo_12b",
                                  "mamba2_130m", "olmoe_1b_7b", "jamba_v01_52b"])
def test_smoke_train_step_on_card_matches_cpu(cuda, arch):
    """One AdamW step of a SMOKE config (f32 params, bf16 compute) on the
    card against the same step on the CPU; remat "full" launches the
    forward with LSE twice per attention (the encoder-decoder's: each
    encoder layer's, each decoder layer's self- and cross-attention, the
    latter at Sq != Sk without the mask), each backward kernel once; on an
    RMSNorm config the norm's forward twice per norm in a layer (once for
    the first norm) and its backward once per norm, and the scan's forward
    twice per SSM layer."""
    cfg = get_config(arch, smoke=True)
    cpu = init_params(cfg, seed=0, device="cpu", dtype=param_dtype(cfg))
    gpu = to_device(cpu, cuda)
    batch = synth_batch(cfg, 2, 64, torch.Generator().manual_seed(1))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    _, _, want = step(cpu, adamw_init(cpu), batch)
    reset_launches()
    _, opt, got = step(gpu, adamw_init(gpu), {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    kinds = [cfg.layer_kind(i % cfg.block_size) for i in range(cfg.n_layers)]
    n = kinds.count("attn") + cfg.encoder_layers + sum(
        cfg.layer_is_cross(i % cfg.block_size) for i in range(cfg.n_layers))
    want_launches = {"flash_attention_fwd_lse": 2 * n, "flash_attention_bwd_dkv": n,
                     "flash_attention_bwd_dq": n, "ssd": 2 * kinds.count("ssm")}
    if cfg.norm == "rmsnorm":
        norms = 1 + cfg.n_layers + kinds.count("ssm") + (cfg.n_layers if cfg.d_ff else 0)
        want_launches |= {"rmsnorm": 2 * norms - 1, "rmsnorm_bwd": norms}
    assert launches() == {**dict.fromkeys(launches(), 0), **want_launches}
    assert abs(float(got["loss"]) - float(want["loss"])) <= 2e-2 * float(want["loss"])
    assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= \
        5e-2 * float(want["grad_norm"])
    for a, b in zip(tree_leaves(gpu), tree_leaves(cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-2, atol=2e-3)
    assert int(opt["step"]) == 1


# ------------------------- the split-row gated norm --------------------------
@pytest.mark.parametrize("rows,d,dn,width", [(8, 768, 1536, 1804), (300, 4096, 8192, 8288),
                                             (37, 100, 200, 212)])
def test_split_row_norm_launches_match_plain(cuda, rows, d, dn, width):
    """Each statistic and apply launch of the gated norm over a split row
    (one rank's block, its gate a column slice of its in_proj output)
    against its plain version: the sums within 1e-5 of the terms'
    magnitudes, the outputs within the bf16 tolerance; and two blocks put
    together against the one-launch gated norm."""
    from repro_torch.kernels.rmsnorm import ops, ref
    g = torch.Generator(device="cuda").manual_seed(0)
    ys = [torch.randn(rows, d, generator=g, device="cuda") for _ in range(dn // d)]
    zs = [torch.randn(rows, width, generator=g, device="cuda").to(torch.bfloat16)[:, :d]
          for _ in ys]
    w = torch.rand(dn, generator=g, device="cuda") + 0.5
    ws = w.split(d)
    dh = torch.randn(rows, d, generator=g, device="cuda").to(torch.bfloat16)
    stats = sum(ops.gated_norm_stat(y, z, wb) for y, z, wb in zip(ys, zs, ws))
    want = sum(ref.gated_norm_stat_ref(y, z) for y, z in zip(ys, zs))
    assert float(((stats - want).abs() / want).max()) <= 1e-5
    outs = [ops.gated_norm_apply(y, z, wb.contiguous(), stats, dn)
            for y, z, wb in zip(ys, zs, ws)]
    for o, y, z, wb in zip(outs, ys, zs, ws):
        torch.testing.assert_close(o.float(), ref.gated_norm_apply_ref(
            y, z, wb, stats, dn).float(), rtol=2e-2, atol=2e-2)
    whole = ops.fused_rmsnorm(torch.cat(ys, 1), w, gate=torch.cat(zs, 1))[0]
    torch.testing.assert_close(torch.cat(outs, 1).float(), whole.float(),
                               rtol=2e-2, atol=2e-2)
    bst = ops.gated_norm_bwd_stat(dh, ys[0], zs[0], ws[0].contiguous())
    torch.testing.assert_close(bst, ref.gated_norm_bwd_stat_ref(dh, ys[0], zs[0], ws[0]),
                               rtol=1e-4, atol=1e-3)
    got = ops.gated_norm_bwd_apply(dh, ys[0], zs[0], ws[0].contiguous(), bst * 2, dn)
    for a, b in zip(got, ref.gated_norm_bwd_apply_ref(dh, ys[0], zs[0], ws[0],
                                                      bst * 2, dn)):
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)


def _split_case(rows, d, width, dtype, seed):
    """Two ranks' blocks of a split row: y (f32), each gate a column slice of
    its own (rows, width) in_proj output, w, dh in the gate's dtype."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ys = [torch.randn(rows, d, generator=g, device="cuda") for _ in range(2)]
    zs = [torch.randn(rows, width, generator=g, device="cuda").to(dtype)[:, :d] for _ in ys]
    ws = [torch.rand(d, generator=g, device="cuda") + 0.5 for _ in ys]
    dhs = [torch.randn(rows, d, generator=g, device="cuda").to(dtype) for _ in ys]
    return ys, zs, ws, dhs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [1801, 1802, 1804, 1808])
@pytest.mark.parametrize("rows", [1, 300])
def test_split_row_norm_every_gate_alignment(cuda, dtype, width, rows):
    """The four split-row launches at every gate alignment (a bf16 gate's
    rows on 2, 4, 8 and 16 bytes, a float32 one's on 4, 8 and 16) and with a
    row of 1: each through its kernel (the gate at the widest load its rows
    allow, counted), against its plain version; dw's bits the same twice."""
    from repro_torch.kernels.rmsnorm import ops, ref
    d, dn = 768, 1536
    ys, zs, ws, dhs = _split_case(rows, d, width, dtype, seed=width + rows)
    widths = ops.split_widths(ys[0], zs[0], ws[0], dhs[0])
    assert widths["gate"] == min(16, (width & -width) * dtype.itemsize)
    reset_launches()
    stats = sum(ops.gated_norm_stat(y, z, w) for y, z, w in zip(ys, zs, ws))
    want = sum(ref.gated_norm_stat_ref(y, z) for y, z in zip(ys, zs))
    scale = sum(ref.gated_norm_stat_ref(y.abs(), z) for y, z in zip(ys, zs))
    assert float(((stats - want).abs() / scale).max()) <= 1e-5
    bstats = sum(ops.gated_norm_bwd_stat(dh, y, z, w) for y, z, w, dh in zip(ys, zs, ws, dhs))
    bwant = sum(ref.gated_norm_bwd_stat_ref(dh, y, z, w) for y, z, w, dh in zip(ys, zs, ws, dhs))
    torch.testing.assert_close(bstats, bwant, rtol=1e-4, atol=1e-3)
    tol = F32 if dtype == torch.float32 else {}
    for y, z, w, dh in zip(ys, zs, ws, dhs):
        _allclose(ops.gated_norm_apply(y, z, w, stats, dn),
                  ref.gated_norm_apply_ref(y, z, w, stats, dn), tol or dict(rtol=2e-2, atol=2e-2))
        got = ops.gated_norm_bwd_apply(dh, y, z, w, bstats, dn)
        plain = ref.gated_norm_bwd_apply_ref(dh, y, z, w, bstats, dn)
        for a, b in zip(got[:2], plain[:2]):
            _allclose(a, b, F32_BWD if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2))
        torch.testing.assert_close(got[2], plain[2], rtol=1e-4,
                                   atol=1e-4 * float(plain[2].abs().max()))
        assert torch.equal(ops.gated_norm_bwd_apply(dh, y, z, w, bstats, dn)[2], got[2])
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    for name, n in (("rmsnorm_split_stat", 2), ("rmsnorm_split_apply", 2),
                    ("rmsnorm_bwd_split_stat", 2), ("rmsnorm_bwd_split_apply", 4)):
        assert launches()[name] == n and launches_by_kind()[f"{name}[{kind}]"] == n


def test_split_row_norm_refuses_widths_it_has_no_kernel_for(cuda):
    """A gate load the kernels were not built for raises on the card (a
    float32 gate in 2-byte loads, 32-byte loads, a 16-byte gate on the
    scalar path); nothing falls back to the plain version."""
    from repro_torch.kernels.rmsnorm import ops
    for kind in ops.SPLIT_KINDS:
        assert ops.plan_split(kind, 300, 768, True, 8)["gate_bytes"] == 8
        for vec, zb, dtype in ((True, 2, torch.float32), (True, 32, torch.bfloat16),
                               (False, 16, torch.bfloat16), (True, 6, torch.bfloat16)):
            with pytest.raises(RuntimeError, match="CUDA error"):
                ops.plan_split(kind, 300, 768, vec, zb, dtype)


def test_split_row_norm_apply_in_a_captured_graph(cuda):
    """The split apply launches captured into a CUDA graph and replayed give
    the eager launches' bits (Mamba2's decode rows, its 8-byte gate)."""
    from repro_torch.kernels.rmsnorm import ops
    ys, zs, ws, dhs = _split_case(8, 768, 1804, torch.bfloat16, seed=5)
    y, z, w, dh = ys[0], zs[0], ws[0], dhs[0]
    stats = ops.gated_norm_stat(y, z, w) * 2
    bstats = ops.gated_norm_bwd_stat(dh, y, z, w) * 2
    eager = (ops.gated_norm_apply(y, z, w, stats, 1536),
             *ops.gated_norm_bwd_apply(dh, y, z, w, bstats, 1536))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.gated_norm_apply(y, z, w, stats, 1536)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (ops.gated_norm_apply(y, z, w, stats, 1536),
               *ops.gated_norm_bwd_apply(dh, y, z, w, bstats, 1536))
    for o in out:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


# ------------------------- the contract: hd 16, float32 -----------------------
F32 = dict(rtol=2e-5, atol=2e-5)          # the reference's float32 forward
F32_BWD = dict(rtol=2e-4, atol=2e-4)      # and backward


def _allclose(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal,dtype", [
    (2, 8, 2, 512, 512, 16, True, torch.bfloat16),     # qwen3_moe SMOKE heads
    (1, 6, 2, 129, 129, 16, True, torch.bfloat16),     # group 3, a tile edge
    (1, 8, 8, 70, 130, 16, False, torch.bfloat16),
    (2, 8, 2, 300, 300, 16, True, torch.float32),
    (1, 4, 1, 70, 130, 32, False, torch.float32),
    (2, 4, 2, 130, 70, 64, True, torch.float32),
    (2, 32, 8, 257, 257, 128, True, torch.float32)])
def test_flash_kernel_takes_hd16_and_float32(cuda, b, h, hkv, sq, sk, hd, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(9)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype).transpose(1, 2)
    q, k, v = randn(b, sq, h, hd), randn(b, sk, hkv, hd), randn(b, sk, hkv, hd)
    reset_launches()
    o = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert o.dtype == dtype and flash_attention.launches == 1
    kind = f"{'f32' if dtype == torch.float32 else 'bf16'}/hd{hd}"
    assert flash_attention.by_kind == {kind: 1}
    if dtype == torch.float32:
        _allclose(o, want, F32)
    else:
        _close(o, want)
        assert _row_scaled_err(o, want) <= 2e-2


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal,dtype", [
    (2, 8, 2, 512, 512, 16, True, torch.bfloat16),
    (1, 8, 2, 300, 129, 16, True, torch.bfloat16),
    (2, 8, 2, 300, 300, 16, True, torch.float32),
    (1, 8, 2, 70, 130, 32, False, torch.float32),
    (2, 16, 16, 256, 256, 128, True, torch.float32)])
def test_training_kernels_take_hd16_and_float32(cuda, b, h, hkv, sq, sk, hd, causal,
                                                dtype):
    g = torch.Generator(device=cuda).manual_seed(10)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype).transpose(1, 2)
    q, k, v, do = (randn(b, sq, h, hd), randn(b, sk, hkv, hd), randn(b, sk, hkv, hd),
                   randn(b, sq, h, hd))
    o, lse = flash_attention_fwd_lse(q, k, v, causal)
    orf, lser = flash_attention_fwd_lse_ref(q, k, v, causal)
    dd = attention_delta(orf, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
    dq = flash_attention_bwd_dq(q, k, v, do, lser, dd, causal)
    dkr, dvr = flash_attention_bwd_dkv_ref(q, k, v, do, lser, dd, causal)
    dqr = flash_attention_bwd_dq_ref(q, k, v, do, lser, dd, causal)
    if dtype == torch.float32:
        _allclose(o, orf, F32)
        _allclose(lse, lser, F32)
        for got, want in ((dq, dqr), (dk, dkr), (dv, dvr)):
            _allclose(got, want, F32_BWD)
    else:
        _close(o, orf)
        _close(lse, lser, 1e-3)
        for got, want in ((dq, dqr), (dk, dkr), (dv, dvr)):
            assert _row_scaled_err(got, want) <= 2e-2
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("b,h,hkv,s,hd,kv_len,dtype,cache", [
    (4, 8, 2, 2081, 16, 2079, torch.bfloat16, torch.bfloat16),
    (2, 6, 2, 50, 16, 33, torch.bfloat16, torch.bfloat16),      # group 3
    (2, 64, 4, 600, 16, 577, torch.bfloat16, torch.bfloat16),   # group 16
    (2, 8, 2, 50, 16, 0, torch.bfloat16, torch.bfloat16),
    (2, 32, 8, 2081, 128, 2079, torch.float32, torch.bfloat16),  # a float32 model's
    (2, 6, 2, 300, 16, 299, torch.float32, torch.float32),
    (3, 8, 8, 90, 32, 1, torch.float32, torch.bfloat16),
    (2, 64, 4, 200, 64, 177, torch.float32, torch.float32),
    (2, 8, 2, 50, 128, 0, torch.float32, torch.float32)])
def test_decode_kernel_takes_hd16_and_float32(cuda, b, h, hkv, s, hd, kv_len, dtype, cache):
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(b, h, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, s, hkv, hd, generator=g, device=cuda).to(cache).transpose(1, 2)
    v = torch.randn(b, s, hkv, hd, generator=g, device=cuda).to(cache).transpose(1, 2)
    o, lse = decode_attention(q, k, v, kv_len)
    assert o.dtype == dtype
    if kv_len == 0:
        assert bool((o == 0).all()) and bool((lse == -1e30).all())
        return
    orf, lser = decode_attention_ref(q, k, v, kv_len, return_lse=True)
    if dtype == torch.float32:
        _allclose(o, orf, F32)
        _allclose(lse, lser, F32)
    else:
        assert _scaled_err(o, orf) <= 2.0 ** -6
        _close(lse, lser, 1e-3)


@pytest.mark.parametrize("rows,d,kind", [(2, 5120, "residual"), (4096, 5120, "residual"),
                                         (300, 12288, "residual"), (7, 100, "residual"),
                                         (8, 1536, "gated"), (16384, 1536, "gated"),
                                         (3, 770, "gated"), (4, 5120, "plain")])
def test_rmsnorm_kernels_take_float32(cuda, rows, d, kind):
    """Row 1 and its backward in float32 (the gated form with a float32
    gate read through its row stride) against their plain versions."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(rows, d, generator=g, device=cuda)
    w = torch.rand(d, generator=g, device=cuda) + 0.5
    r = torch.randn(rows, d, generator=g, device=cuda) if kind == "residual" else None
    z = (2 * torch.randn(rows, 2 * d + 280, generator=g, device=cuda))[:, :d] \
        if kind == "gated" else None
    reset_launches()
    y, res = fused_rmsnorm(x, w, r, gate=z)
    wy, wres = fused_rmsnorm_ref(x, w, r, gate=z)
    assert y.dtype == torch.float32 and fused_rmsnorm.by_kind == {"f32": 1}
    _allclose(y, wy, F32)
    if res is not None:
        _allclose(res, wres, F32)
    if d > 8192:                        # the backward's widest row
        return
    dh = torch.randn(rows, d, generator=g, device=cuda)
    dr = torch.randn(rows, d, generator=g, device=cuda) if kind == "residual" else None
    got = fused_rmsnorm_bwd(dh, dr, x, w, r, 1e-6, z)
    want = fused_rmsnorm_bwd_ref(dh, dr, x, w, r, 1e-6, z)
    for a, b_ in zip(got, want):
        if b_ is not None:
            _allclose(a, b_, F32_BWD)


# --------------------- the float32 decode and dQ redesign ---------------------
@pytest.mark.parametrize("b,h,hkv,s,hd,cache", [
    (1, 32, 8, 2081, 128, torch.bfloat16),   # mistral_nemo_12b in float32
    (1, 32, 8, 2081, 128, torch.float32),
    (4, 8, 2, 2081, 16, torch.bfloat16),     # the hd-16 SMOKE configs' heads
    (2, 10, 2, 300, 64, torch.float32),      # group 5: one chunk of 5 heads
    (2, 24, 8, 90, 32, torch.bfloat16)])     # group 3
def test_decode_f32_kernel_replayed_with_kv_len_changed_on_the_card(cuda, b, h, hkv, s, hd,
                                                                    cache):
    """The float32 decode kernel (a block per head group, the keys split
    over a cluster) captured once with a device kv_len and replayed at 0, 1,
    ragged, half, S and past S: each replay within 2e-5 of the plain
    version (kv_len 0: o = 0, lse = -1e30), one launch counted a replay."""
    from repro_torch.kernels._build import CountedGraph
    g = torch.Generator(device=cuda).manual_seed(29)
    q = torch.randn(b, h, hd, generator=g, device=cuda)
    k = torch.randn(b, s, hkv, hd, generator=g, device=cuda).to(cache).transpose(1, 2)
    v = torch.randn(b, s, hkv, hd, generator=g, device=cuda).to(cache).transpose(1, 2)
    kl = torch.full((1,), 7, dtype=torch.int32, device=cuda)
    o, lse = decode_attention(q, k, v, kl)      # eagerly first (builds the kernel)
    orf, lser = decode_attention_ref(q, k, v, 7, return_lse=True)
    _allclose(o, orf, F32)
    _allclose(lse, lser, F32)
    graph = CountedGraph()
    with graph.capture():
        o, lse = decode_attention(q, k, v, kl)
    n = decode_attention.launches
    for i, kv_len in enumerate((0, 1, 37, s // 2, s, s + 50)):
        kl.fill_(kv_len)
        graph.replay()
        assert decode_attention.launches == n + i + 1
        if kv_len == 0:
            assert bool((o == 0).all()) and bool((lse == -1e30).all())
            continue
        orf, lser = decode_attention_ref(q, k, v, min(kv_len, s), return_lse=True)
        _allclose(o, orf, F32)
        _allclose(lse, lser, F32)


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal", [
    (1, 16, 16, 1024, 1024, 128, True),   # olmo_1b's heads
    (2, 8, 2, 300, 300, 64, True),        # GQA 4, ragged
    (1, 6, 2, 129, 129, 16, True),        # group 3, a tile edge
    (1, 8, 2, 70, 130, 32, False),        # Sq < Sk, no mask
    (1, 4, 2, 300, 129, 128, True)])      # Sq > Sk, causal
def test_f32_backward_and_forward_hold_with_the_same_bits(cuda, b, h, hkv, sq, sk, hd,
                                                          causal):
    """The float32 dQ (split TF32) within 2e-4 of its plain version, the
    forward with LSE within 2e-5 and dK/dV within 2e-4, each counted once
    by kind, and two calls of dQ and of dK/dV the same bits."""
    g = torch.Generator(device=cuda).manual_seed(30)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).transpose(1, 2)
    q, k, v, do = randn(b, sq, h, hd), randn(b, sk, hkv, hd), randn(b, sk, hkv, hd), \
        randn(b, sq, h, hd)
    reset_launches()
    o, lse = flash_attention_fwd_lse(q, k, v, causal)
    orf, lser = flash_attention_fwd_lse_ref(q, k, v, causal)
    _allclose(o, orf, F32)
    _allclose(lse, lser, F32)
    dd = attention_delta(orf, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lser, dd, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
    kind = f"f32/hd{hd}"
    assert flash_attention_bwd_dq.by_kind == {kind: 1} and dq.dtype == torch.float32
    assert flash_attention_bwd_dkv.by_kind == {kind: 1}
    _allclose(dq, flash_attention_bwd_dq_ref(q, k, v, do, lser, dd, causal), F32_BWD)
    dkr, dvr = flash_attention_bwd_dkv_ref(q, k, v, do, lser, dd, causal)
    _allclose(dk, dkr, F32_BWD)
    _allclose(dv, dvr, F32_BWD)
    assert torch.equal(dq, flash_attention_bwd_dq(q, k, v, do, lser, dd, causal))
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


# ------------------- the hd-16 decode and dK/dV redesign ----------------------
@pytest.mark.parametrize("b,h,hkv,s", [
    (4, 8, 2, 2081),       # the hd-16 SMOKE configs' heads over the serving cache
    (2, 6, 2, 300),        # group 3 (minitron_4b SMOKE)
    (2, 32, 2, 600),       # group 16, in chunks of 8 heads
    (1, 8, 2, 8192)])      # a block takes more tiles than its ring holds
def test_hd16_decode_replayed_across_tile_edges(cuda, b, h, hkv, s):
    """The hd-16 decode kernel (64-key tiles) captured once with a device
    kv_len and replayed while kv_len advances across the tiles' edges, to
    S and past it: each replay within 2^-6 of the largest plain output and
    lse within 1e-3 (kv_len 0: o = 0, lse = -1e30), one launch counted a
    replay."""
    from repro_torch.kernels._build import CountedGraph
    g = torch.Generator(device=cuda).manual_seed(31)
    q = torch.randn(b, h, 16, generator=g, device=cuda).bfloat16()
    k = torch.randn(b, s, hkv, 16, generator=g, device=cuda).bfloat16().transpose(1, 2)
    v = torch.randn(b, s, hkv, 16, generator=g, device=cuda).bfloat16().transpose(1, 2)
    kl = torch.full((1,), 3, dtype=torch.int32, device=cuda)
    decode_attention(q, k, v, kl)           # warm: builds the kernel
    graph = CountedGraph()
    with graph.capture():
        o, lse = decode_attention(q, k, v, kl)
    n = decode_attention.launches
    lens = (0, 1, 63, 64, 65, 127, 128, 129, 1000, s - 1, s, s + 50)
    for i, kv_len in enumerate(lens):
        kl.fill_(kv_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        # a wait of the kernel that gives up takes ~2 s (its watchdog), and
        # one in the producer's drain leaves the outputs right: time it
        assert time.perf_counter() - t0 < 0.5
        assert decode_attention.launches == n + i + 1
        if kv_len == 0:
            assert bool((o == 0).all()) and bool((lse == -1e30).all())
            continue
        orf, lser = decode_attention_ref(q, k, v, min(kv_len, s), return_lse=True)
        assert bool(torch.isfinite(o.float()).all())
        assert _scaled_err(o, orf) <= 2.0 ** -6
        _close(lse, lser, 1e-3)


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", [
    (4, 8, 2, 2048, 2048, True),   # the hd-16 SMOKE configs' training heads
    (2, 6, 2, 191, 191, True),     # group 3, Sk not a multiple of 64
    (1, 4, 1, 77, 65, False),      # full attention, one key past a tile
    (1, 4, 2, 300, 129, True),     # Sq > Sk
    (1, 4, 4, 129, 300, True)])    # Sq < Sk: keys past Sq see no query
def test_hd16_dkv_matches_plain_with_the_same_bits(cuda, b, h, hkv, sq, sk, causal):
    """The hd-16 dK/dV kernel (64-key items split over a cluster, the
    partials summed in rank order) against its plain version, each key row
    within 2e-2 of that row's largest plain value, and two calls the same
    bits."""
    g = torch.Generator(device=cuda).manual_seed(32)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).bfloat16().transpose(1, 2)
    q, k, v, do = randn(b, sq, h, 16), randn(b, sk, hkv, 16), randn(b, sk, hkv, 16), \
        randn(b, sq, h, 16)
    orf, lser = flash_attention_fwd_lse_ref(q, k, v, causal)
    dd = attention_delta(orf, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
    dkr, dvr = flash_attention_bwd_dkv_ref(q, k, v, do, lser, dd, causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dk.float()).all() and torch.isfinite(dv.float()).all())
    assert _row_scaled_err(dk, dkr) <= 2e-2 and _row_scaled_err(dv, dvr) <= 2e-2
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_other_head_dims_keep_their_instantiations(cuda):
    """hd 32, 64 and 128 keep the training kernels they had before the hd-16
    designs, and hd 32 and 128 the serving forward and decode too: decode's
    plan a cluster of at most 8 blocks a group, the forward's, dK/dV's and
    dQ's shared memory (the hd-16 grouped forward, cluster dK/dV and
    cluster dQ have their own, and the hd-64 forward its three-warpgroup form), and
    each held against its plain version (their bits against the previous
    source are held by tools/kernel_compare.py)."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.ops import plan
    smem = _build.bind("flash_attention", "flash_attention_smem_bytes",
                       [ctypes.c_int, ctypes.c_int])
    for hd in (32, 64, 128):
        pl = plan(4, 8, 2, hd)
        assert pl["cluster"] and pl["n_split"] <= 8
        # K, V of 128 keys, the ring of Q/dO tiles and row statistics, as before
        st = 3 if hd == 128 else 4
        assert smem(1, hd) == (1024 + 2 * 128 * hd * 2 + st * 2 * 64 * hd * 2 + st * 128 * 4
                               + 8 * (1 + 2 * st) + 16)
        # the forward: two Q buffers, K and V rings; dQ: Q, dO, a K/V ring
        fst = 2 if hd == 128 else 4
        assert smem(0, hd) == (1024 + 2 * 128 * hd * 2 + fst * 2 * 128 * hd * 2
                               + 8 * (4 + 4 * fst) + 16)
        assert smem(2, hd) == 1024 + 2 * 128 * hd * 2 + 4 * 2 * 64 * hd * 2 + 8 * 9 + 16
    for kernel in (3, 4, 5):     # the hd-16 kernels: cluster dK/dV, forward, dQ
        assert smem(kernel, 16) > 0 and smem(kernel, 32) == 0
    assert smem(6, 64) > 0 and smem(6, 16) == smem(6, 128) == 0   # the hd-64 forward
    g = torch.Generator(device=cuda).manual_seed(33)
    for hd in (32, 64, 128):
        q = torch.randn(4, 8, hd, generator=g, device=cuda).bfloat16()
        k = torch.randn(4, 300, 2, hd, generator=g, device=cuda).bfloat16().transpose(1, 2)
        v = torch.randn(4, 300, 2, hd, generator=g, device=cuda).bfloat16().transpose(1, 2)
        o, lse = decode_attention(q, k, v, 277)
        orf, lser = decode_attention_ref(q, k, v, 277, return_lse=True)
        assert _scaled_err(o, orf) <= 2.0 ** -6
        _close(lse, lser, 1e-3)
        qt, kt, vt, do = (torch.randn(2, s, n, hd, generator=g, device=cuda).bfloat16()
                          .transpose(1, 2) for s, n in ((200, 8), (200, 2), (200, 2), (200, 8)))
        orf, lser = flash_attention_fwd_lse_ref(qt, kt, vt, True)
        dd = attention_delta(orf, do)
        dk, dv = flash_attention_bwd_dkv(qt, kt, vt, do, lser, dd, True)
        dkr, dvr = flash_attention_bwd_dkv_ref(qt, kt, vt, do, lser, dd, True)
        assert _row_scaled_err(dk, dkr) <= 2e-2 and _row_scaled_err(dv, dvr) <= 2e-2
        o, lse = flash_attention_fwd_lse(qt, kt, vt, True)
        assert _row_scaled_err(o, orf) <= 2e-2
        _close(lse, lser, 1e-3)
        assert _row_scaled_err(flash_attention(qt, kt, vt, causal=True), orf) <= 2e-2
        dq = flash_attention_bwd_dq(qt, kt, vt, do, lser, dd, True)
        assert _row_scaled_err(dq, flash_attention_bwd_dq_ref(qt, kt, vt, do, lser, dd,
                                                              True)) <= 2e-2


# ---------------- the hd-16 forward and dQ redesign ----------------------------
#: (B, H, Hkv, Sq, Sk, causal): the SMOKE heads at the training length and
#: twice as long, every GQA group packing (1, 2, 3: a tail row, 4, 8, 16; 80:
#: chunks of 64 heads), Sq and Sk off the key tiles (128 keys in the forward,
#: 64 in dQ) and the items' positions, Sq != Sk both ways, full attention
#: (the memory and the encoder's shapes)
HD16_EDGES = [(4, 8, 2, 2048, 2048, True),
              (2, 16, 4, 4096, 4096, True),   # four rounds of items a block
              (2, 6, 2, 191, 191, True),      # group 3: 21 positions, a tail row
              (1, 4, 1, 77, 65, False),       # group 4 full, one key past a tile
              (1, 4, 4, 129, 300, True),      # group 1, Sq < Sk
              (1, 4, 2, 300, 129, True),      # group 2, Sq > Sk
              (2, 16, 2, 100, 100, True),     # group 8
              (1, 64, 4, 200, 200, True),     # group 16
              (1, 80, 1, 37, 90, False),      # group 80: two chunks, the second part-filled
              (1, 8, 2, 70, 130, False)]      # unmasked, Sq != Sk


def _hd16_inputs(cuda, seed, b, h, hkv, sq, sk):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).bfloat16().transpose(1, 2)
    return randn(b, sq, h, 16), randn(b, sk, hkv, 16), randn(b, sk, hkv, 16), \
        randn(b, sq, h, 16)


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", HD16_EDGES)
def test_hd16_forward_matches_plain_with_the_same_bits(cuda, b, h, hkv, sq, sk, causal):
    """The hd-16 forward, with and without the LSE (items of 64 rows packing
    a GQA group's heads, one warpgroup a block, a persistent grid dealing
    the items in zigzag rounds), against its plain version:
    each query row within 2e-2 of that row's largest plain value, the LSE
    within 1e-3, the two launches' o the same bits, two calls the same bits,
    one launch each counted at bf16/hd16."""
    q, k, v, _ = _hd16_inputs(cuda, 34, b, h, hkv, sq, sk)
    reset_launches()
    o = flash_attention(q, k, v, causal=causal)
    o2, lse = flash_attention_fwd_lse(q, k, v, causal)
    assert flash_attention.by_kind == {"bf16/hd16": 1}
    assert flash_attention_fwd_lse.by_kind == {"bf16/hd16": 1}
    orf, lser = flash_attention_fwd_lse_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o.float()).all())
    assert _row_scaled_err(o, orf) <= 2e-2
    _close(lse, lser, 1e-3)
    assert torch.equal(o, o2)
    assert torch.equal(o, flash_attention(q, k, v, causal=causal))
    o3, lse3 = flash_attention_fwd_lse(q, k, v, causal)
    assert torch.equal(o2, o3) and torch.equal(lse, lse3)


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", HD16_EDGES)
def test_hd16_dq_matches_plain_with_the_same_bits(cuda, b, h, hkv, sq, sk, causal):
    """The hd-16 dQ (items of 64 packed rows on a persistent grid, each
    item's f32 dQ summed in registers) against its plain version, each
    query row within 2e-2 of that row's largest plain value, and two calls
    the same bits."""
    q, k, v, do = _hd16_inputs(cuda, 35, b, h, hkv, sq, sk)
    orf, lser = flash_attention_fwd_lse_ref(q, k, v, causal)
    dd = attention_delta(orf, do)
    reset_launches()
    dq = flash_attention_bwd_dq(q, k, v, do, lser, dd, causal)
    assert flash_attention_bwd_dq.by_kind == {"bf16/hd16": 1}
    dqr = flash_attention_bwd_dq_ref(q, k, v, do, lser, dd, causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dq.float()).all())
    assert _row_scaled_err(dq, dqr) <= 2e-2
    assert torch.equal(dq, flash_attention_bwd_dq(q, k, v, do, lser, dd, causal))


# ---------------- the hd-64 serving forward and decode redesign ---------------
#: (B, H, Hkv, Sq, Sk, causal): SeamlessM4T's three shapes (the decoder's
#: cross-attention over 1024 frames, the encoder's 1024², the decoder's
#: causal 2048²), Sq off the 192-row items (191, 193, 385) and Sk off the
#: 128-key tiles, Sq != Sk both ways, GQA groups 1, 3, 4 and 16
HD64_EDGES = [(4, 16, 16, 2048, 1024, False),
              (4, 16, 16, 1024, 1024, False),
              (4, 16, 16, 2048, 2048, True),
              (1, 8, 2, 191, 191, True),
              (1, 8, 8, 193, 193, True),
              (1, 4, 4, 385, 300, False),
              (2, 4, 2, 300, 129, True),
              (1, 4, 4, 129, 300, True),
              (2, 6, 2, 1000, 1000, True),
              (1, 64, 4, 200, 200, True)]


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", HD64_EDGES)
def test_hd64_forward_matches_plain_with_the_same_bits(cuda, b, h, hkv, sq, sk, causal):
    """The hd-64 serving forward (items of 192 rows, three consumer
    warpgroups taking turns, a persistent grid dealing the items in zigzag
    rounds) against its plain version, Q, K and V the model's transposed
    views: each query row within 2e-2 of that row's largest plain value,
    two calls the same bits, one launch counted at bf16/hd64."""
    g = torch.Generator(device=cuda).manual_seed(36)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).bfloat16().transpose(1, 2)
    q, k, v = randn(b, sq, h, 64), randn(b, sk, hkv, 64), randn(b, sk, hkv, 64)
    reset_launches()
    o = flash_attention(q, k, v, causal=causal)
    assert flash_attention.by_kind == {"bf16/hd64": 1}
    orf = flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o.float()).all())
    assert _row_scaled_err(o, orf) <= 2e-2
    assert torch.equal(o, flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("b,h,hkv,s", [
    (4, 16, 16, 2081),     # SeamlessM4T's decoder cache
    (4, 16, 16, 1024),     # its memory: 1024 frames
    (2, 8, 2, 600),        # group 4
    (2, 6, 2, 300),        # group 3
    (2, 32, 2, 600),       # group 16, in chunks of 8 heads
    (1, 2, 1, 8192)])      # a block takes more tiles than its ring holds
def test_hd64_decode_replayed_across_tile_edges(cuda, b, h, hkv, s):
    """The hd-64 decode kernel (32-key tiles, two ring stages a warp, the
    blocks of a cluster pushing their partials to block 0) captured once
    with a device kv_len and replayed while kv_len advances across the
    tiles' edges, to S and past it, each replay timed (a wait that gives up
    takes ~2 s): o within 2^-6 of the largest plain output and lse within
    1e-3 (kv_len 0: o = 0, lse = -1e30), one launch counted a replay at
    bf16/hd64; two eager calls the same bits."""
    from repro_torch.kernels._build import CountedGraph
    g = torch.Generator(device=cuda).manual_seed(37)
    q = torch.randn(b, h, 64, generator=g, device=cuda).bfloat16()
    k = torch.randn(b, s, hkv, 64, generator=g, device=cuda).bfloat16().transpose(1, 2)
    v = torch.randn(b, s, hkv, 64, generator=g, device=cuda).bfloat16().transpose(1, 2)
    kl = torch.full((1,), s - 2, dtype=torch.int32, device=cuda)
    o1, lse1 = decode_attention(q, k, v, kl)           # warm: builds the kernel
    o2, lse2 = decode_attention(q, k, v, kl)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    graph = CountedGraph()
    with graph.capture():
        o, lse = decode_attention(q, k, v, kl)
    reset_launches()
    lens = (0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 1000, s - 1, s, s + 50)
    seconds = []
    for i, kv_len in enumerate(lens):
        kl.fill_(kv_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        assert seconds[-1] < 0.5, (kv_len, seconds)
        assert decode_attention.by_kind == {"bf16/hd64": i + 1}
        if kv_len == 0:
            assert bool((o == 0).all()) and bool((lse == -1e30).all())
            continue
        orf, lser = decode_attention_ref(q, k, v, min(kv_len, s), return_lse=True)
        assert bool(torch.isfinite(o.float()).all())
        assert _scaled_err(o, orf) <= 2.0 ** -6
        _close(lse, lser, 1e-3)
