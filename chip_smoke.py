#!/usr/bin/env python3
"""Drive the PyTorch port's two paths on one NVIDIA card: serve
Mistral-NeMo-12B, and run the DSE price phase.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure:
  1. the card and the toolchain;
  2. build every kernel from ``src/repro_torch/kernels/*/csrc`` with nvcc
     (sm_90a), one process per source, all in parallel, printing
     ``-Xptxas -v``;
  3. every kernel against its plain PyTorch version on the card, at the
     shapes its path gives it and at ragged ones, with its time, the plain
     version's, one PyTorch library call's (where one exists) and the least
     time the card could take (bound); the pricing kernel at 2^20 rows, f64
     bit for bit and f32 within the drift band;
  4. the serving path: ``run_serve`` on the full mistral_nemo_12b config, 4
     requests x 2048-token prompts x 32 new tokens, random weights from a
     seed; the kernels' launch counters are zeroed just before and read just
     after, and must show every kernel on the path;
  5. steady-state decode timings and correctness checks: the kernels'
     model against the plain versions on a small config, and at full size
     the decode path's logits against a teacher-forced prefill over the
     generated tokens;
  6. the DSE path: ``DSEEngine.sweep`` on the seven smoke scenarios and a
     parallel sweep, then ``reprice_grid`` on the 100,224-cell dense grid,
     on the kernel backends, each against the numpy backend (rows and
     winners identical) with its launch counters zeroed before and read
     after; the price phase split into plan, copies and kernel;
  7. one JSON line of kernel numbers, the card's name and power limit, and
     a last JSON line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet, dense, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12        # tensor cores
F32_FLOP_PER_S = 67e12          # CUDA cores
F64_FLOP_PER_S = 34e12          # CUDA cores (FP64, outside the tensor cores)

REQUESTS, PROMPT_LEN, NEW_TOKENS, SEED = 4, 2048, 32, 0
TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 kernel vs plain, element-wise
# Decode attention averages ~2000 values, so its outputs are ~0.03: an
# absolute 2e-2 would hide a dropped split. Its limit is four bf16 ulps of
# the largest reference output instead.
DECODE_REL = 2.0 ** -6
SCALED_TOL_SMALL = 2e-2            # whole model, small config, bf16
SCALED_TOL_FULL = 5e-2             # 40 bf16 layers, decode vs prefill path

PRICE_ROWS, PRICE_TIMED_ROWS = 131072, 1 << 20
DRIFT_BAND = 1e-5                  # f32 pricing vs the f64 reference
# f32 pricing kernel vs its plain f32 version, relative, element-wise: the
# two differ only where the kernel contracts a product and a sum into an
# FMA; 2^-19 is 4 to 8 f32 ulps.
F32_PLAIN_REL = 2.0 ** -19
SMOKE_SCENARIOS = ("llm", "dlrm", "hpl", "fft", "moe", "mamba2", "serving")
PARALLEL_TIMEOUT_S = 600


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


def device_split(torch, fn):
    """Run ``fn`` once under torch.profiler; returns its result and the
    device time (ms) and count of the host->device copies, the pricing
    kernels, the device->host copies and anything else on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    split = {k: [0.0, 0] for k in ("h2d", "kernel", "d2h", "other")}
    events = []
    for e in prof.key_averages():
        memcpy = "Memcpy" in e.key
        if getattr(e, "device_type", None) != DeviceType.CUDA and not memcpy:
            continue
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)) / 1e3
        key = ("h2d" if "HtoD" in e.key else "d2h" if "DtoH" in e.key else
               "kernel" if "pricing_kernel" in e.key else "other")
        split[key][0] += t
        split[key][1] += e.count
        events.append((e.key[:48], str(getattr(e, "device_type", None)),
                       e.count, round(t, 6)))
    return out, {f"{k}_ms": t for k, (t, _) in split.items()} | {
        f"{k}_n": n for k, (_, n) in split.items()} | {"events": events}


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


# ------------------------------- phase 3: pricing -----------------------------
# Arithmetic operations per row of each formula (additions, subtractions,
# multiplications, divisions; comparisons and selects not counted).
PRICING_OPS = {"price": 35, "roofline": 11}


def _max_abs_finite(a, b) -> float:
    """Largest |a - b| over the entries where both are finite."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0


def check_pricing(torch, timer) -> dict:
    """The pricing kernel, f64 and f32, on its two formulas: seeded rows plus
    hand-made edge rows (zero branches, NaN, ±inf, signed zeros). f64 must be
    bit-identical to its plain version on the card and to the numpy formula
    on the host; f32 within the drift band of that f64 reference, a feasible
    bit flipping only within the band of the capacity. The certification
    harnesses at n = 512, then times at 2^20 rows (the seeded rows tiled)."""
    import numpy as np

    from repro_torch.core.pricing import stack_plans
    from repro_torch.kernels.pricing import (certify, certify_f32,
                                             pricing_f32, pricing_f64)
    from repro_torch.kernels.pricing.ops import f32_drift
    from repro_torch.kernels.pricing.ref import (FORMULAS, edge_plan_vectors,
                                                 pricing_ref,
                                                 random_plan_vectors,
                                                 random_roofline_columns)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    finite, special = edge_plan_vectors()
    inputs = {"price": stack_plans(random_plan_vectors(PRICE_ROWS, SEED)
                                   + finite + special),
              "roofline": random_roofline_columns(PRICE_ROWS, SEED)}
    say(f"  inputs: {PRICE_ROWS} seeded rows per formula, "
        f"{len(finite) + len(special)} edge rows for price "
        f"({time.perf_counter() - t0:.1f} s)")
    stacks, errs, drift_all = {}, {"pricing": 0.0, "pricing_f32": 0.0}, {}
    rel32 = 0.0
    for entry, cols in inputs.items():
        formula, names, outs, bools = FORMULAS[entry]
        x = torch.from_numpy(np.stack([cols[k] for k in names])).to(dev)
        stacks[entry] = x
        with np.errstate(all="ignore"):
            host = formula(np, cols)
        want = np.stack([np.asarray(host[k], np.float64) for k in outs])
        got = pricing_f64(x, entry)
        plain = pricing_ref(x, entry)
        torch.cuda.synchronize()
        got, plain = got.cpu().numpy(), plain.cpu().numpy()
        bad = {"plain": int((got.view(np.uint64) != plain.view(np.uint64)).sum()),
               "numpy": int((got.view(np.uint64) != want.view(np.uint64)).sum())}
        if any(bad.values()):
            raise AssertionError(f"pricing f64 {entry}: values whose bits "
                                 f"differ from the plain version / numpy: {bad}")
        errs["pricing"] = max(errs["pricing"], _max_abs_finite(got, plain))
        got32 = pricing_f32(x, entry)
        plain32 = pricing_ref(x, entry, f32=True)
        torch.cuda.synchronize()
        got32, plain32 = got32.cpu().numpy(), plain32.cpu().numpy()
        errs["pricing_f32"] = max(errs["pricing_f32"],
                                  _max_abs_finite(got32, plain32))
        got32_cols = {k: got32[i] != 0 if k in bools else got32[i]
                      for i, k in enumerate(outs)}
        vs_plain = f32_drift(got32_cols, {
            k: plain32[i] != 0 if k in bools else plain32[i].astype(np.float64)
            for i, k in enumerate(outs)}, cols.get("mem_capacity", 1.0))
        rel32 = max(rel32, max(vs_plain.values()))
        if not rel32 <= F32_PLAIN_REL:
            raise AssertionError(f"pricing f32 {entry}: relative difference "
                                 f"from its plain f32 version beyond "
                                 f"{F32_PLAIN_REL:g}: {vs_plain}")
        drifts = f32_drift(got32_cols, host, cols.get("mem_capacity", 1.0))
        drift_all[entry] = drifts
        say(f"  pricing {entry} {tuple(x.shape)}: f64 bit-identical to its "
            f"plain version and to numpy; f32 within "
            f"{max(vs_plain.values()):.3g} (relative) of its plain version, "
            f"largest relative drift from f64 per column "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in drifts.items()})}")
        if not max(drifts.values()) <= DRIFT_BAND:
            raise AssertionError(f"pricing f32 {entry}: drift beyond the band "
                                 f"{DRIFT_BAND:g}: {drifts}")
    rep64 = certify(n=512, device=dev)
    rep32 = certify_f32(n=512, band=DRIFT_BAND, device=dev)
    say(f"  certify: {rep64}; certify_f32: max drift {rep32['max_drift']:.3g}")

    numbers = {}
    reps = PRICE_TIMED_ROWS // PRICE_ROWS
    for name, kernel, f32 in (("pricing", pricing_f64, False),
                              ("pricing_f32", pricing_f32, True)):
        per = {}
        for entry, x in stacks.items():
            n_in, n_out = len(FORMULAS[entry][1]), len(FORMULAS[entry][2])
            xb = x[:, :PRICE_ROWS].repeat(1, reps)
            n = xb.shape[1]
            nb = n_in * n * 8 + n_out * n * (4 if f32 else 8)
            b_ms, b_by = bound(nb, PRICING_OPS[entry] * n,
                               F32_FLOP_PER_S if f32 else F64_FLOP_PER_S)
            per[entry] = dict(
                ms=timer.ms(lambda: kernel(xb, entry), 50),
                plain_ms=timer.ms(lambda: pricing_ref(xb, entry, f32), 10),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=[n_in, n])
            del xb
        numbers[name] = dict(
            max_abs_err=errs[name], **per["price"], roofline=per["roofline"],
            **({"max_rel_err": rel32, "rel_err_limit": F32_PLAIN_REL,
                "max_rel_drift": max(max(d.values())
                                     for d in drift_all.values()),
                "drift_band": DRIFT_BAND}
               if f32 else {}))
        say(f"  {name} {numbers[name]}")
    return numbers


# ------------------------------- phase 6 --------------------------------------
def exact_rows(rows: list[dict]) -> list[dict]:
    """Sweep rows with every float spelled exactly (``float.hex``)."""
    return [{k: v.hex() if isinstance(v, float) else v for k, v in r.items()}
            for r in rows]


def _timed_out(what: str) -> None:
    print(f"chip_smoke: FAILED: {what} did not finish in "
          f"{PARALLEL_TIMEOUT_S} s", file=sys.stderr, flush=True)
    os._exit(1)


def check_dse(kernels) -> dict[str, int]:
    """The DSE price phase on the card: every smoke scenario swept on the
    kernel backends (and the eager torch one) against the numpy backend, one
    parallel sweep after CUDA is initialized (forkserver workers), and
    ``reprice_grid`` on the dense grid with its phase split. Each run's
    launch counters are zeroed just before it and read just after; returns
    the pricing launches summed over the runs."""
    import warnings

    import torch

    from repro_torch.core import DSEEngine
    from repro_torch.search import DenseGridSpec
    from repro_torch.workloads.scenarios import get_scenario

    total = {"pricing": 0, "pricing_f32": 0}

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        c = kernels.launches()
        if any(v for k, v in c.items() if k not in total):
            raise AssertionError(f"serving kernels launched on the DSE path: {c}")
        for k in total:
            total[k] += c[k]
        return out, c

    t0 = time.perf_counter()
    for name in SMOKE_SCENARIOS:
        want = exact_rows(DSEEngine(parallel=False, pricing_backend="numpy")
                          .sweep_scenario(name, smoke=True).rows())
        note = []
        for backend in ("kernel", "kernel-f32", "torch"):
            engine = DSEEngine(parallel=False, pricing_backend=backend)
            res, c = counted(lambda: engine.sweep_scenario(name, smoke=True))
            if exact_rows(res.rows()) != want:
                raise AssertionError(f"sweep {name} on {backend}: rows differ "
                                     f"from the numpy backend's")
            key = "pricing_f32" if backend == "kernel-f32" else "pricing"
            if backend != "torch" and not c[key]:
                raise AssertionError(f"sweep {name} on {backend}: no launch")
            note.append(f"{backend} {c[key] if backend != 'torch' else 0}")
            if backend == "kernel-f32":
                drift = engine.last_drift_stats
                if not drift["max_iter_drift"] <= DRIFT_BAND:
                    raise AssertionError(f"sweep {name}: drift {drift}")
                note.append(f"max iter drift {drift['max_iter_drift']:.3g}")
        say(f"  sweep {name} smoke: {len(want)} rows identical to numpy on "
            f"kernel, kernel-f32 and torch; launches {', '.join(note)}")
    say(f"  seven scenarios x four backends in {time.perf_counter() - t0:.1f} s")

    engine = DSEEngine(parallel=True, max_workers=2, pricing_backend="kernel")
    method = engine._start_method()
    if method != "forkserver":
        raise AssertionError(f"CUDA is initialized but the pool starts by {method}")
    watchdog = threading.Timer(PARALLEL_TIMEOUT_S, _timed_out,
                               ("the parallel sweep",))
    watchdog.daemon = True
    t0 = time.perf_counter()
    watchdog.start()
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="parallel sweep unavailable")
            res, c = counted(lambda: engine.sweep_scenario("llm", smoke=True))
    finally:
        watchdog.cancel()
    want = exact_rows(DSEEngine(parallel=False, pricing_backend="numpy")
                      .sweep_scenario("llm", smoke=True).rows())
    if exact_rows(res.rows()) != want or not c["pricing"]:
        raise AssertionError(f"parallel sweep: rows differ or no launch ({c})")
    say(f"  parallel sweep llm smoke ({method}, 2 workers) in "
        f"{time.perf_counter() - t0:.1f} s: rows identical to numpy; "
        f"launches {c['pricing']}; plan stats {engine.last_plan_stats}")

    grid = DenseGridSpec.dense(100_000)
    spec = grid.spec()
    work = get_scenario("llm", smoke=True).work_fn
    keys = ("cells", "groups", "enumerated", "survived", "priced_rows",
            "chunks")
    ref = DSEEngine(parallel=False, pricing_backend="numpy").reprice_grid(
        work, spec)
    say(f"  reprice_grid numpy (cold plan): {json.dumps(ref)}")
    for backend, key in (("kernel", "pricing"), ("kernel-f32", "pricing_f32")):
        engine = DSEEngine(parallel=False, pricing_backend=backend)
        (rep, c), split = device_split(
            torch, lambda: counted(lambda: engine.reprice_grid(work, spec)))
        if {k: rep[k] for k in keys} != {k: ref[k] for k in keys}:
            raise AssertionError(f"reprice_grid {backend}: report differs "
                                 f"from numpy's: {rep}")
        if c[key] != rep["chunks"] or not rep["winners_identical"]:
            raise AssertionError(f"reprice_grid {backend}: launches {c} for "
                                 f"{rep['chunks']} chunks")
        if split["kernel_n"] != sum(c.values()):
            raise AssertionError(f"reprice_grid {backend}: the profiler saw "
                                 f"{split['kernel_n']} pricing kernels, the "
                                 f"counters {c}")
        device_s = (split["h2d_ms"] + split["kernel_ms"] + split["d2h_ms"]
                    + split["other_ms"]) / 1e3
        # the chunk's host->device copy alone, timed with CUDA events at the
        # same size and from the same kind of (pinned) buffer
        stack = torch.empty((25, rep["priced_rows"]), dtype=torch.float64,
                            pin_memory=True)
        h2d_ms = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            stack.to("cuda", non_blocking=True)
            end.record()
            torch.cuda.synchronize()
            h2d_ms.append(start.elapsed_time(end))
        say(f"  reprice_grid {backend}: {rep['cells']} cells, "
            f"{rep['groups']} groups, {rep['priced_rows']} rows priced in "
            f"{rep['chunks']} chunk(s), {c[key]} launch(es); winners "
            f"identical to numpy; repriced_frac {rep['repriced_frac']:.6g}, "
            f"max iter drift "
            f"{(rep['drift'] or {}).get('max_iter_drift', 0.0):.6g}")
        say(f"    price phase split (torch.profiler device time): plan_s "
            f"{rep['plan_s']:.6f}, price_s {rep['price_s']:.6f} = "
            f"host->device {split['h2d_ms']:.6f} ms ({split['h2d_n']} copies)"
            f" + kernel {split['kernel_ms']:.6f} ms ({split['kernel_n']}) + "
            f"device->host {split['d2h_ms']:.6f} ms ({split['d2h_n']}) + "
            f"other device work {split['other_ms']:.6f} ms "
            f"({split['other_n']}) + the rest on the host (stacking, "
            f"concatenation, winner certification) "
            f"{rep['price_s'] - device_s:.6f} s")
        say(f"    profiled device events {split['events']}; host->device "
            f"copy of the chunk's (25, {rep['priced_rows']}) float64 "
            f"stack alone: {min(h2d_ms):.6f} ms (best of 5, CUDA events)")
    return total


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
        f"decode o within {DECODE_REL:g} x max|plain|, lse within 1e-3; "
        f"pricing f64 bit for bit, f32 within {DRIFT_BAND:g} of f64)")
    timer = Timer(torch)
    numbers = check_kernels(torch, timer)
    numbers.update(check_pricing(torch, timer))
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
            "rmsnorm": (1 + 2 * cfg.n_layers) * NEW_TOKENS,
            "pricing": 0, "pricing_f32": 0}
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

    # 6. the DSE path
    say("[6] DSE price phase: sweeps, a parallel sweep and reprice_grid on "
        "the kernel backends against numpy")
    t0 = time.perf_counter()
    counts.update(check_dse(kernels))
    say(f"    DSE path in {time.perf_counter() - t0:.1f} s; pricing launches "
        f"{counts['pricing']}, pricing_f32 launches {counts['pricing_f32']}")

    # 7. result
    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:43",
                "decode_attention": "src/repro/kernels/decode_attention/kernel.py:89",
                "flash_attention": "src/repro/kernels/flash_attention/kernel.py:112",
                "pricing": "src/repro/kernels/pricing/kernel.py:165",
                "pricing_f32": "src/repro/kernels/pricing/kernel.py:235"}
    line = []
    for name, n in numbers.items():
        src = name.removesuffix("_f32")
        line.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/{src}/csrc/{src}.cu",
                     "replaces": replaces[name], "launches": counts[name],
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
