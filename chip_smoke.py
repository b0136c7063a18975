#!/usr/bin/env python3
"""Serve Mistral-NeMo-12B on one NVIDIA card through the PyTorch port.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure:
  1. the card and the toolchain;
  2. build every kernel from ``src/repro_torch/kernels/*/csrc`` with nvcc
     (sm_90a), printing ``-Xptxas -v``;
  3. every kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it and at ragged ones, with its time,
     the plain version's, one PyTorch library call's and the least time the
     card could take (bound);
  4. the main path: ``run_serve`` on the full mistral_nemo_12b config, 4
     requests x 2048-token prompts x 32 new tokens, random weights from a
     seed; the kernels' launch counters are zeroed just before and read just
     after, and must show every kernel on the path;
  5. steady-state decode timings and correctness checks: the kernels'
     model against the plain versions on a small config, and at full size
     the decode path's logits against a teacher-forced prefill over the
     generated tokens;
  6. one JSON line of kernel numbers, the card's name and power limit, and
     a last JSON line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet, dense, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12        # tensor cores
F32_FLOP_PER_S = 67e12          # CUDA cores

REQUESTS, PROMPT_LEN, NEW_TOKENS, SEED = 4, 2048, 32, 0
TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 kernel vs plain, element-wise
# Decode attention averages ~2000 values, so its outputs are ~0.03: an
# absolute 2e-2 would hide a dropped split. Its limit is four bf16 ulps of
# the largest reference output instead.
DECODE_REL = 2.0 ** -6
SCALED_TOL_SMALL = 2e-2            # whole model, small config, bf16
SCALED_TOL_FULL = 5e-2             # 40 bf16 layers, decode vs prefill path


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def say(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


# ------------------------------- measuring ------------------------------------
class Timer:
    """Device time of one call. The call is captured once into a CUDA graph
    and the graph replayed, so the host's share (Python, ctypes, allocation)
    is left out; CUDA events around each replay, averaged, with the L2
    cache flushed before each replay so every call reads device memory."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int) -> float:
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm up off the capture
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / iters


def profile(torch, fn) -> dict:
    """One call under torch.profiler: host wall time, device busy time by
    kernel group and the device's idle share (1 - busy / wall). Profiling
    slows the host, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)) / 1e3
        name = e.key
        group = ("rmsnorm" if "rmsnorm_kernel" in name else
                 "decode_attention" if "decode_" in name and "_kernel" in name else
                 "flash_attention" if "flash_fwd_kernel" in name else
                 "matmul" if any(w in name.lower() for w in
                                 ("gemm", "gemv", "nvjet", "xmma", "cutlass"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + t
        kernels.append((t, e.count, name[:90]))
    busy = sum(groups.values())
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_ops": sum(n for _, n, _ in kernels),
            "idle_share": 1 - busy / wall if busy else None,
            "by_group_ms": {k: round(v, 4) for k, v in sorted(
                groups.items(), key=lambda kv: -kv[1])},
            "top": [(round(t, 4), n, k) for t, n, k in sorted(kernels)[::-1][:8]]}


def bound(nbytes: float, ops: float, op_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, name: str) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    lim = TOL["atol"] + TOL["rtol"] * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max |kernel - plain| {err.max().item():.3g}"
                             f" outside rtol=atol=2e-2")
    return err.max().item()


def compare_scaled(torch, got, want, name: str, rel: float) -> float:
    """max |got - want| <= rel * max |want|; returns max |got - want|."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    lim = rel * want.float().abs().max().item()
    if not err <= lim:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3g} > {lim:.3g}"
                             f" ({rel:g} x max |plain|)")
    return err


def sdpa(F, q, k, v, causal: bool):
    """The library yardstick for attention: one scaled_dot_product_attention
    call with grouped K/V (never called by the port)."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


# ------------------------------- phase 3 --------------------------------------
def check_kernels(torch, timer) -> dict:
    """Each kernel against its plain version at the serving shapes and at
    ragged ones; times at the heaviest serving shape."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref

    cfg = get_config("mistral_nemo_12b")
    B, S, d = REQUESTS, PROMPT_LEN, cfg.d_model
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    max_len = PROMPT_LEN + NEW_TOKENS + 1
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    out = {}

    # ---- fused RMSNorm: prefill rows, decode rows, a ragged width
    errs = []
    cases = {}
    for label, t, dd in (("prefill", B * S, d), ("decode", B, d),
                         ("ragged", 7, 100)):
        x, r = randn(t, dd), randn(t, dd)
        w = torch.rand(dd, generator=g, device=dev) + 0.5
        y, res = fused_rmsnorm(x, w, r)
        yr, resr = fused_rmsnorm_ref(x, w, r)
        errs += [compare(torch, y, yr, f"rmsnorm {label} y"),
                 compare(torch, res, resr, f"rmsnorm {label} residual")]
        cases[label] = (x, w, r)
        say(f"  rmsnorm {label} ({t}, {dd}) max|err| {max(errs[-2:]):.3g}")
    numbers = {}
    for label in ("prefill", "decode"):
        x, w, r = cases[label]
        wb = w.to(bf)
        t, dd = x.shape
        nb, fl = 4 * t * dd * 2 + dd * 4, 5.0 * t * dd
        b_ms, b_by = bound(nb, fl, F32_FLOP_PER_S)
        numbers[label] = dict(
            ms=timer.ms(lambda: fused_rmsnorm(x, w, r), 100),
            plain_ms=timer.ms(lambda: fused_rmsnorm_ref(x, w, r), 20),
            library_ms=timer.ms(lambda: F.rms_norm(x + r, (dd,), wb, 1e-6), 100),
            bound_ms=b_ms, bound_by=b_by, shape=[t, dd])
        say(f"  rmsnorm {label} {numbers[label]}")
    out["rmsnorm"] = dict(max_abs_err=max(errs), **numbers["prefill"],
                          decode=numbers["decode"])

    # ---- decode attention: the serving cache (B, max_len, Hkv, hd), read
    # transposed; the last decode step's kv_len; ragged shapes
    errs = []
    kv_last = PROMPT_LEN + NEW_TOKENS - 1
    for label, (b, h, hkv, s, dh, kv_len) in (
            ("serve", (B, H, Hkv, max_len, hd, kv_last)),
            ("serve-first", (B, H, Hkv, max_len, hd, PROMPT_LEN + 1)),
            ("ragged", (3, 8, 2, 37, 64, 29)),
            ("ragged-mha", (2, 4, 4, 300, 32, 300))):
        q = randn(b, h, dh)
        ck, cv = randn(b, s, hkv, dh), randn(b, s, hkv, dh)
        k, v = ck.transpose(1, 2), cv.transpose(1, 2)
        o, lse = decode_attention(q, k, v, kv_len)
        orf, lser = decode_attention_ref(q, k, v, kv_len, return_lse=True)
        errs.append(compare_scaled(torch, o, orf, f"decode {label} o",
                                   DECODE_REL))
        lse_err = (lse - lser).abs().max().item()
        if not lse_err <= 1e-3 * max(1.0, lser.abs().max().item()):
            raise AssertionError(f"decode {label}: lse error {lse_err:.3g}")
        say(f"  decode_attention {label} q {tuple(q.shape)} cache "
            f"{tuple(ck.shape)} kv_len {kv_len} max|err| o {errs[-1]:.3g} "
            f"lse {lse_err:.3g}")
        if label == "serve":
            main = (q, k, v, kv_len)
    q, k, v, kv_len = main
    kc, vc = k[:, :, :kv_len], v[:, :, :kv_len]
    nb = (q.numel() * 2 * 2 + 2 * B * Hkv * kv_len * hd * 2 + B * H * 4)
    b_ms, b_by = bound(nb, 4.0 * B * H * kv_len * hd, BF16_FLOP_PER_S)

    def sdpa_decode():
        return sdpa(F, q[:, :, None], kc, vc, causal=False)
    out["decode_attention"] = dict(
        max_abs_err=max(errs),
        ms=timer.ms(lambda: decode_attention(q, k, v, kv_len), 200),
        plain_ms=timer.ms(lambda: decode_attention_ref(q, k, v, kv_len,
                                                       return_lse=True), 20),
        library_ms=timer.ms(sdpa_decode, 200),
        bound_ms=b_ms, bound_by=b_by,
        shape=[B, H, Hkv, max_len, hd, kv_len])
    say(f"  decode_attention serve {out['decode_attention']}")

    # ---- flash attention: the prefill's (B, S, H, hd) activations, read
    # transposed; ragged lengths
    errs = []
    for label, (b, h, hkv, sq, sk, dh, causal) in (
            ("serve", (B, H, Hkv, S, S, hd, True)),
            ("ragged-causal", (2, H, Hkv, 1000, 1000, hd, True)),
            ("ragged-full", (1, 8, 2, 70, 130, 64, False)),
            ("ragged-causal-sq>sk", (2, 4, 2, 130, 70, 32, True))):
        qa, ka, va = randn(b, sq, h, dh), randn(b, sk, hkv, dh), randn(b, sk, hkv, dh)
        args = (qa.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2))
        o = flash_attention(*args, causal=causal)
        errs.append(compare(torch, o, flash_attention_ref(*args, causal=causal),
                            f"flash {label}"))
        say(f"  flash_attention {label} q {tuple(args[0].shape)} k "
            f"{tuple(args[1].shape)} causal {causal} max|err| {errs[-1]:.3g}")
        if label == "serve":
            main = args
    qf, kf, vf = main
    pairs = S * (S + 1) / 2
    nb = (2 * qf.numel() + 2 * kf.numel()) * 2
    b_ms, b_by = bound(nb, 4.0 * B * H * hd * pairs, BF16_FLOP_PER_S)
    out["flash_attention"] = dict(
        max_abs_err=max(errs),
        ms=timer.ms(lambda: flash_attention(qf, kf, vf, causal=True), 20),
        plain_ms=timer.ms(lambda: flash_attention_ref(qf, kf, vf, causal=True), 5),
        library_ms=timer.ms(lambda: sdpa(F, qf, kf, vf, causal=True), 20),
        bound_ms=b_ms, bound_by=b_by, shape=[B, H, Hkv, S, S, hd])
    say(f"  flash_attention serve {out['flash_attention']}")
    return out


# ------------------------------- phase 5 --------------------------------------
def scaled_err(got, want) -> float:
    """Largest difference over the largest reference value."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def check_small_model(torch) -> float:
    """The kernels' model on the card against the plain versions on the CPU:
    mistral_nemo_12b SMOKE in bf16, same weights, prefill plus 4
    teacher-forced decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill, to_device

    cfg = get_config("mistral_nemo_12b", smoke=True)
    cpu = init_params(cfg, seed=SEED, device="cpu")
    gpu = to_device(cpu, "cuda")
    g = torch.Generator().manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=g)
    s, steps = 16, 4
    worst = 0.0
    with torch.no_grad():
        want, wc = prefill(cfg, cpu, toks[:, :s], max_len=s + steps)
        got, gc = prefill(cfg, gpu, toks[:, :s].cuda(), max_len=s + steps)
        worst = max(worst, scaled_err(got.cpu(), want),
                    scaled_err(gc["k"].cpu(), wc["k"]))
        for i in range(steps):
            want, wc = decode_step(cfg, cpu, wc, toks[:, s + i], s + i)
            got, gc = decode_step(cfg, gpu, gc, toks[:, s + i].cuda(), s + i)
            worst = max(worst, scaled_err(got.cpu(), want))
    if not worst <= SCALED_TOL_SMALL:
        raise AssertionError(f"small model: card vs CPU error {worst:.3g}")
    return worst


def check_full_model(torch, cfg, params, prompts, tokens) -> dict:
    """At full size: the decode path's logits (decode kernel, cache) for the
    generated tokens against one forward pass (flash kernel) over the prompt
    and those tokens; and the greedy tokens against that pass's argmax."""
    from repro_torch.models import decode_step, forward, prefill

    gen = torch.tensor(tokens, device=prompts.device).t()  # (B, n)
    n, s = gen.shape[1], prompts.shape[1]
    with torch.no_grad():
        full = forward(cfg, params, torch.cat([prompts, gen[:, :-1]], 1))
        teacher = full[:, s - 1:]                           # (B, n, V)
        if not bool(torch.isfinite(teacher.float()).all()):
            raise AssertionError("full model: non-finite logits")
        agree = (teacher.argmax(-1) == gen).float().mean().item()
        _, cache = prefill(cfg, params, prompts, max_len=s + n)
        worst = 0.0
        for i in range(n - 1):
            lg, cache = decode_step(cfg, params, cache, gen[:, i], s + i)
            worst = max(worst, scaled_err(lg, teacher[:, i + 1]))
    if not worst <= SCALED_TOL_FULL:
        raise AssertionError(f"full model: decode vs prefill error {worst:.3g}")
    if not agree >= 0.8:
        raise AssertionError(f"full model: greedy tokens agree with the "
                             f"teacher-forced argmax on {agree:.2%} only")
    return {"decode_vs_prefill_scaled_err": worst, "greedy_agreement": agree}


# ------------------------------- main -----------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        return fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    t_start = time.perf_counter()
    # 1. card and toolchain
    card = nvidia_smi("name,power.limit")
    say(f"[1] card: {card}")
    say(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")
    nv = subprocess.run([_build.nvcc(), "--version"], check=True,
                        capture_output=True, text=True).stdout.strip()
    say(f"    nvcc: {nv.splitlines()[-1]}")
    try:
        import triton
        say(f"    triton {triton.__version__} (not used by this slice)")
    except ImportError:
        say("    triton: not installed")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    say(f"[2] built {len(logs)} kernels for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "smem", "error", "warning")):
                say(f"    {name}: {line.strip()}")

    # 3. kernels vs plain
    say("[3] kernels against their plain versions (bf16, rtol=atol=2e-2; "
        f"decode o within {DECODE_REL:g} x max|plain|, lse within 1e-3)")
    timer = Timer(torch)
    numbers = check_kernels(torch, timer)
    del timer
    torch.cuda.empty_cache()

    # 4. the main path
    cfg = get_config("mistral_nemo_12b")
    say(f"[4] run_serve {cfg.name}: {REQUESTS} requests x {PROMPT_LEN} "
        f"prompt tokens x {NEW_TOKENS} new tokens, seed {SEED}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = run_serve(cfg, requests=REQUESTS, prompt_len=PROMPT_LEN,
                    tokens=NEW_TOKENS, seed=SEED)
    counts = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (NEW_TOKENS - 1),
            "rmsnorm": (1 + 2 * cfg.n_layers) * NEW_TOKENS}
    say(f"    TTFT {res.ttft * 1e3:.3f} ms, TPOT {res.tpot * 1e3:.4f} ms, "
        f"{res.tokens_per_s:.2f} tokens/s, peak memory "
        f"{peak / 2**30:.3f} GiB; launches {counts}")
    if counts != want:
        return fail(f"launch counts {counts} != {want}")
    if len(res.tokens) != NEW_TOKENS or any(
            len(t) != REQUESTS or not all(0 <= x < cfg.vocab for x in t)
            for t in res.tokens):
        return fail("generated tokens malformed")

    # 5. steady state and correctness
    params = init_params(cfg, seed=SEED)
    engine = ServeEngine(cfg, params, max_batch=REQUESTS,
                         max_len=PROMPT_LEN + NEW_TOKENS + 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=gen, device="cuda")
    warm = engine.generate(prompts, n_tokens=NEW_TOKENS)
    if warm.tokens != res.tokens:
        return fail("a second run from the same seed gave other tokens")
    steady = engine.decode_steady(prompts, n_steps=16, warmup=2)
    say(f"[5] warm generate: TTFT {warm.ttft * 1e3:.3f} ms, TPOT "
        f"{warm.tpot * 1e3:.4f} ms, {warm.tokens_per_s:.2f} tokens/s")
    say(f"    decode_steady: TPOT mean {steady.tpot * 1e3:.4f} ms, min "
        f"{min(steady.step_times) * 1e3:.4f}, max "
        f"{max(steady.step_times) * 1e3:.4f} over {len(steady.step_times)} "
        f"steps; {steady.tokens_per_s:.2f} tokens/s")
    full = check_full_model(torch, cfg, params, prompts, res.tokens)
    say(f"    full-size consistency: {full}")
    from repro_torch.models import decode_step, prefill
    with torch.no_grad():
        logits, cache = prefill(cfg, params, prompts, max_len=PROMPT_LEN + 2)
        tok = logits[:, -1].argmax(-1)
        decode_step(cfg, params, cache, tok, PROMPT_LEN)      # warm
        say(f"    profile of one decode step: {profile(torch, lambda: decode_step(cfg, params, cache, tok, PROMPT_LEN))}")
        del logits, cache
        say(f"    profile of one prefill: {profile(torch, lambda: prefill(cfg, params, prompts))}")
    del engine, params
    torch.cuda.empty_cache()
    small = check_small_model(torch)
    say(f"    small config, card vs CPU plain: scaled error {small:.3g}")

    # 6. result
    sources = {"rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:43",
               "decode_attention": "src/repro/kernels/decode_attention/kernel.py:89",
               "flash_attention": "src/repro/kernels/flash_attention/kernel.py:112"}
    line = []
    for name, n in numbers.items():
        line.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
                     "replaces": sources[name], "launches": counts[name],
                     **n})
    say(f"    total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": line}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
