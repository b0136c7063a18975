#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card: serve
Mistral-NeMo-12B, serve Mamba2-130M, run the DSE price phase, train
OLMo-1B, and serve Minitron-4B (GQA group 3) at full width.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure:
  1. the card and the toolchain;
  2. build every kernel from ``src/repro_torch/kernels/*/csrc`` with nvcc
     (sm_90a), one process per source, and a small measurement helper
     (PROBE_SOURCE), all in parallel, printing ``-Xptxas -v``; every
     RMSNorm, flash-attention, decode and SSD instantiation's registers,
     spills (none allowed) and shared memory;
  3. every kernel against its plain PyTorch version on the card, at the
     shapes its path gives it and at ragged ones, with its time, the plain
     version's, one PyTorch library call's (where one exists) and the least
     time the card could take (bound); the fused RMSNorm at the six shapes
     of the serving paths (RMSNORM_SHAPES: the residual norm of mistral and
     mamba2 and Mamba2's gated norm, decode and prefill) and at ragged and
     unaligned ones, y within one bf16 ulp of its f64 value, the residual
     bit for bit, the gated norm within one ulp of the unfused chain, a race
     check (a predecessor that writes x last, eagerly and replayed), each
     decode shape timed as 81 launches captured in one graph beside an
     empty kernel's, each prefill shape with the L2 flushed by a read and
     by a write; the pricing kernel at 2^20 rows, f64
     bit for bit and f32 within the drift band; the SSD scan in f32 within
     the reference's 2e-4, in the model's layout (B/C at head stride 0, or
     per head) and in the Pallas kernel's, at ragged lengths, P != N and a
     strong decay, two calls bit-identical; decode attention with a device
     kv_len at the serving cache (also kv_len 0, 1 and S) and GQA groups 3
     and 16, each output also within one bf16 ulp of its f64 value, and one
     captured launch replayed with kv_len changed on the device; its time
     with the L2 flushed by a write and, beside SDPA, by a read;
     the serving forward at the mistral and minitron_4b prefill shapes,
     ragged lengths and its 128-row / 128-key tile edges, each
     query row within 2e-2 of that row's largest plain value; the three
     training attention kernels (forward with LSE, dK/dV, dQ) at the
     olmo_1b training shape (8, 16, 2048, 128) causal, a GQA ragged shape,
     hd 64 full attention and the same tile edges, each row of o, dq (per
     query) and dk, dv (per key) within 2e-2 of that row's largest plain
     value, and the backward kernels bit-identical across two calls;
  4. the DSE path: ``DSEEngine.sweep`` on the seven smoke scenarios and a
     parallel sweep, then ``reprice_grid`` on the 100,224-cell dense grid,
     on the kernel backends, each against the numpy backend (rows and
     winners identical) with its launch counters zeroed before and read
     after; the price phase split into plan, copies and kernel (it runs
     before the serving paths' profiles, after which torch.profiler has
     missed the pricing kernel's event);
 4b. the DSE features that run through the pricing kernels, under a
     watchdog: the learned ranker fitted from the smoke sweeps on the
     kernel backend (equal to numpy's, recall at its target), every smoke
     scenario rank on and off on kernel, kernel-f32 and torch (rows and
     rank survivors equal numpy's); ``reprice_grid`` rank on at 100,224
     cells on both kernels (counts equal numpy's, price_s beside rank
     off); certified ``search`` (random, halving, surrogate on the llm
     smoke grid, halving on dense grids up to the largest that finishes
     within SEARCH_LIMIT_S), each equal to numpy's; then the DSE service
     daemon started after CUDA is initialized (its warm pool by
     forkserver, a serial session refused): two clients with 6
     overlapping cells, a search and a reprice request, rows equal to the
     numpy engine's, dedup hits equal to the overlap, pricing launches
     during the requests, a clean shutdown;
  5. the serving path: ``run_serve`` on the full mistral_nemo_12b config, 4
     requests x 2048-token prompts x 32 new tokens, random weights from a
     seed; the kernels' launch counters are zeroed just before and read just
     after, and must show every kernel on the path (the decode step runs as
     a captured CUDA graph, whose replays count their launches); the
     engine's graph tokens against eager ``decode_step`` calls for all 31
     steps (identical; the largest logit difference printed);
  6. a new engine's generate (one capture, its time), a warm one that
     captures nothing, steady-state decode through the graph, profiles of
     an eager and of a replayed decode step, and correctness checks: the
     kernels' model against the plain versions on a small config, and at
     full size the decode path's logits against a teacher-forced prefill
     over the generated tokens;
  7. the SSM serving path: ``run_serve`` on the full mamba2_130m config, 8
     requests x 2048-token prompts x 32 new tokens, counters zeroed just
     before and read just after; a second run from the seed, steady-state
     decode, the decode path (the recurrence) against a teacher-forced
     forward (the chunked scan), for the whole model and for each layer
     alone, the state handoff layer by layer, every sequence of the batch,
     on three weight seeds, once with the scan through the kernel and once
     through its plain version (the kernel route held to the plain route's
     readings, see SSM_REL), profiles of a prefill and a decode step, and
     the small config on the card against the plain versions; then one
     more profiled ``reprice_grid``, whose pricing
     events the profiler is asked for after the serving profiles
     (reported, not checked);
  8. training: the gradients of a 2-layer olmo_1b at full width, batch 2 x
     2048, through the kernels against the same model with the plain
     attention under autograd (every leaf within 2e-2 of its largest
     value, wq/wk/wv non-zero); the SMOKE config's 3 train steps on the
     card against the CPU; then ``run_train`` on the full olmo_1b, 8 x
     2048 tokens, 8 steps on one repeated batch, counters zeroed just
     before and read just after (2L forward-with-LSE launches per step
     under remat "full", L of each backward kernel), a finite loss that
     starts near ln V + 1/2 and falls, step time, tokens/s, the FLOP
     shares of the 989 TFLOP/s peak and peak memory; and a profile of one
     full step;
  9. a GQA group-3 serving path: ``run_serve`` on minitron_4b at full width
     (d_model 3072, 24/8 heads, vocab 256,000), its depth cut to
     MINITRON_LAYERS layers, counters zeroed just before and read just
     after, its graph tokens against eager ones, a new engine's generate,
     a warm one, steady decode through the graph, profiles of an eager and
     a replayed decode step, and its decode path's logits against a
     prefill of the same tokens; then a child process
     (``--capture-failure``) shows that a decode step that reads a value on
     the host cannot be captured and the engine raises;
 10. one JSON line of kernel numbers, the card's name and power limit, and
     a last JSON line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
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
SSM_REQUESTS = 8                   # mamba2_130m: 8 x 2048 + 32
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 8   # olmo_1b: 8 x 2048
# minitron_4b (GQA group 3) serves at full width, its depth cut from 32 to
# this many layers to keep the phase short
MINITRON_LAYERS = 4
GRAD_LAYERS, GRAD_BATCH = 2, 2     # the full-width gradient check
TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 kernel vs plain, element-wise
SSD_TOL = dict(rtol=2e-4, atol=2e-4)  # the reference's SSD tolerance, f32 math
# Decode attention averages ~2000 values, so its outputs are ~0.03: an
# absolute 2e-2 would hide a dropped split. Its limit is four bf16 ulps of
# the largest reference output instead.
DECODE_REL = 2.0 ** -6
SCALED_TOL_SMALL = 2e-2            # whole model, small config, bf16
TRAIN_ROW_REL = 2e-2               # training attention, each row's own scale
SCALED_TOL_FULL = 5e-2             # 40 bf16 layers, decode vs prefill path
# mamba2_130m at full depth with random weights amplifies bf16 rounding
# layer by layer (ROADMAP.md queue 3, "SSM"): the decode path (recurrence)
# and the teacher-forced forward (chunked scan) agree in layer 0's caches,
# then drift apart. Phase 7 reads that drift twice on the card, once with
# the scan through the kernel and once through its plain version
# (``plain_scan``), on SSM_SEEDS weight seeds and every sequence of the
# batch. On the H100, with the previous (CUDA-core f32) version of the SSD
# kernel (PERF.md §6), the deep readings, kernel / plain route, the
# largest over the seeds, were: logits 0.122 / 0.113, state handoff 0.148
# / 0.116, conv handoff 0.0952 / 0.0726 (ratios 1.08, 1.28, 1.31); seed 1
# read 0.148 / 0.116 on the state, so the earlier fixed limit of 0.1 was
# one reading, not a bound. What does not depend on depth was sharp on the
# kernel route: layer 0's state and conv handoff <= 1.5e-6, each layer
# alone's state and conv tail <= 4.1e-6 (the plain route read up to 8.6e-5
# there: its cumsum rounds otherwise). So the kernel route's layer 0
# handoff and each layer alone's state and conv tail are held within
# SSM_TIGHT; each layer alone's output within the repo's bf16 bound and
# greedy agreement at least 0.8 on both routes; and the deep readings
# relative to the plain route: the kernel route's largest over the seeds
# at most SSM_REL times the plain route's.
SSM_SEEDS = (SEED, SEED + 1, SEED + 2)
SSM_TIGHT = 1e-5
SSM_REL = 2.0

PRICE_ROWS, PRICE_TIMED_ROWS = 131072, 1 << 20
DRIFT_BAND = 1e-5                  # f32 pricing vs the f64 reference
# f32 pricing kernel vs its plain f32 version, relative, element-wise: the
# two differ only where the kernel contracts a product and a sum into an
# FMA; 2^-19 is 4 to 8 f32 ulps.
F32_PLAIN_REL = 2.0 ** -19
SMOKE_SCENARIOS = ("llm", "dlrm", "hpl", "fft", "moe", "mamba2", "serving")
PARALLEL_TIMEOUT_S = 600
# phase 4b: certified halving searches on dense grids of growing size
# (None: DenseGridSpec(), 864 cells; else DenseGridSpec.dense(size)); a
# size runs while its time, extrapolated from the last one, stays within
# SEARCH_LIMIT_S; the phase's watchdog is PHASE4B_TIMEOUT_S
SEARCH_LADDER = (None, 20_000, 50_000, 100_000)
SEARCH_LIMIT_S = 120
PHASE4B_TIMEOUT_S = 720
REPRICE_TURNS = 3


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
    cache flushed before each replay so every call reads device memory.

    The flush writes 256 MB (``zero_``), so the L2 holds dirty lines when
    the call starts, and a call that reads X bytes from device memory also
    makes the L2 write about X bytes back: a memory-bound kernel pays about
    twice its bytes. ``clean_l2=True`` flushes by reading the buffer
    instead, which leaves clean lines: the L2 a decode step inside the
    model finds (the weights it streams are read, not written)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def eager_ms(self, fn, iters: int) -> float:
        """CUDA events around each eager call (one that a graph cannot
        capture, such as autograd's backward), L2 flushed before each."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / iters

    def ms(self, fn, iters: int, clean_l2: bool = False) -> float:
        torch = self.torch
        flush = ((lambda: self.flush.max()) if clean_l2 else self.flush.zero_)
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
            flush()
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
                 "flash_attention_bwd" if "flash_bwd_" in name else
                 "ssd" if "ssd_chunk_kernel" in name else
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


def compare(torch, got, want, name: str, tol: dict = TOL) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max |kernel - plain| {err.max().item():.3g}"
                             f" outside rtol={tol['rtol']:g}, atol={tol['atol']:g}")
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


# A row's scale is its largest |plain| value, but at least this share of
# the tensor's: some rows are zero by cancellation (dq at query 0 of causal
# attention, where o = v_0 makes dS = 0), and the kernel's f32 rounding
# leaves ~1e-7 there.
ROW_SCALE_FLOOR = 1e-3


def row_scaled_errs(got, want) -> tuple[float, float]:
    """(max |got - want| / max |want| over the whole tensor, the same ratio
    taken row by row over the last dimension, each row's scale at least
    ROW_SCALE_FLOOR of the tensor's, maximised over rows). Causal
    attention's rows differ in size by two orders of magnitude (row 0 of o
    is one value of v, row 2047 a mean of 2048), so a limit scaled by the
    whole tensor's largest value may pass a kernel that drops a key or
    query tile deep in the sequence: the training kernels are held to the
    row ratio."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs()
    top = scale.max()
    whole = (err.max() / top).item()
    rows = (err.amax(-1) / scale.amax(-1).clamp_min(ROW_SCALE_FLOOR * top)
            ).max().item()
    return whole, rows


def sdpa(F, q, k, v, causal: bool):
    """The library yardstick for attention: one scaled_dot_product_attention
    call with grouped K/V (never called by the port)."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


# ------------------------------- phase 2 --------------------------------------
FLASH_KERNELS = {"flash_fwd_kernel": 0, "flash_bwd_dkv_kernel": 1,
                 "flash_bwd_dq_kernel": 2}


def ptxas_report(log: str, entry: str, label, extra=lambda m: {}) -> dict:
    """Registers and spilled bytes per kernel instantiation, from ``nvcc
    -Xptxas -v``: each entry function whose mangled name matches the regex
    ``entry``, keyed by ``label(match)``, with ``extra(match)`` beside."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?" + entry, line)
        if m:
            name = label(m)
            out[name] = extra(m)
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name]["spill_bytes"] = int(st) + int(ld)
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
            name = None
    return out


#: Mangled entry names of the SSD kernel: ssd_chunk_kernel<T, NP>.
SSD_ENTRY = r"ssd_chunk_kernelI(13__nv_bfloat16|f)Li(\d+)E"


#: Mangled entry names of the RMSNorm kernel: rmsnorm_kernel<VW, PER, GATE>.
RMSNORM_ENTRY = r"rmsnorm_kernelILi(\d+)ELi(\d+)ELb([01])E"
#: its instantiations: (VW, PER) = (8, 1), (8, 2), (8, 4) and (1, 4), each
#: with and without the gate but (8, 4)
RMSNORM_BUILDS = 7


def rmsnorm_label(m) -> str:
    return f"rmsnorm<vw {m.group(1)}, per {m.group(2)}{', gated' if m.group(3) == '1' else ''}>"


#: Mangled entry names of the decode kernel: decode_attention_kernel<HD, NREP>.
DECODE_ENTRY = r"decode_attention_kernelILi(\d+)ELi(\d+)E"


def decode_label(m) -> str:
    return f"decode<{m.group(1)}, {m.group(2)}>"


def decode_build_report(log: str) -> dict:
    """Per decode kernel instantiation (``decode<hd, nrep>``):
    :func:`ptxas_report` and the dynamic shared memory of a block."""
    return ptxas_report(log, DECODE_ENTRY, decode_label, lambda m: {
        "smem_bytes": decode_plan(1, int(m.group(2)), 1, int(m.group(1)))["smem_bytes"]})


def ssd_label(m) -> str:
    return f"ssd<{'bf16' if m.group(1) != 'f' else 'f32'}, {m.group(2)}>"


def flash_build_report(log: str) -> dict:
    """Per flash-attention kernel instantiation (``kernel<hd[, lse]>``):
    :func:`ptxas_report` (registers at entry: consumers get more through
    setmaxnreg) and the dynamic shared memory a launch takes, from the
    library."""
    import ctypes

    from repro_torch.kernels import _build

    smem = _build.bind("flash_attention", "flash_attention_smem_bytes",
                       [ctypes.c_int, ctypes.c_int])
    return ptxas_report(
        log, r"(" + "|".join(FLASH_KERNELS) + r")ILi(\d+)E(Lb(\d)E)?",
        lambda m: f"{m.group(1)}<{m.group(2)}{', lse' if m.group(4) == '1' else ''}>",
        lambda m: {"smem_bytes": smem(FLASH_KERNELS[m.group(1)], int(m.group(2)))})


def ssd_build_report(log: str) -> dict:
    """Per SSD kernel instantiation (``ssd<dtype, NP>``, NP the padded N):
    :func:`ptxas_report` and the dynamic shared memory a launch at P = 64
    takes, from the library."""
    import ctypes

    from repro_torch.kernels import _build

    smem = _build.bind("ssd", "ssd_smem_bytes", [ctypes.c_int] * 3)
    return ptxas_report(log, SSD_ENTRY, ssd_label, lambda m: {
        "smem_bytes_p64": smem(64, int(m.group(2)), int(m.group(1) != "f"))})


# ------------------------------- phase 3 --------------------------------------
def flash_cases(B, H, Hkv, S, hd):
    """The serving forward's cases, (label, (B, H, Hkv, Sq, Sk, hd, causal)):
    the mistral prefill, the minitron_4b prefill (GQA group 3), ragged
    lengths, and the edges of the kernel's 128-row blocks and 128-key tiles
    (127, 128, 129, 257), Sq > Sk causal, n_rep 4, hd 32, 64 and 128."""
    return (("serve", (B, H, Hkv, S, S, hd, True)),
            ("gqa3-minitron", (B, 24, 8, S, S, 128, True)),
            ("ragged-causal", (2, H, Hkv, 1000, 1000, hd, True)),
            ("ragged-full", (1, 8, 2, 70, 130, 64, False)),
            ("ragged-causal-sq>sk", (2, 4, 2, 130, 70, 32, True)),
            ("edge-127", (1, 8, 2, 127, 127, 128, True)),
            ("edge-128", (1, 8, 2, 128, 128, 64, True)),
            ("edge-129", (1, 8, 2, 129, 129, 32, True)),
            ("edge-257", (2, 8, 2, 257, 257, 128, True)),
            ("edge-257-full", (1, 8, 2, 257, 257, 64, False)),
            ("edge-sq>sk", (1, 8, 2, 300, 129, 128, True)))


# Decode attention's phase-3 cases, (label, (B, H, Hkv, S, hd, kv_len)): the
# serving cache of mistral_nemo_12b (B, S, Hkv, hd) = (4, 2081, 8, 128) read
# transposed at the last and the first decode step's kv_len, kv_len 0, 1 and
# S; ragged shapes; GQA group 3 (minitron_4b's 24/8 heads, compiled as it
# is) and 16 (qwen3_moe_235b's 64/4, in chunks of 8 heads).
def decode_cases() -> tuple:
    s = PROMPT_LEN + NEW_TOKENS + 1
    last = PROMPT_LEN + NEW_TOKENS - 1
    return (("serve", (REQUESTS, 32, 8, s, 128, last)),
            ("serve-first", (REQUESTS, 32, 8, s, 128, PROMPT_LEN + 1)),
            ("kv_len 0", (REQUESTS, 32, 8, s, 128, 0)),
            ("kv_len 1", (REQUESTS, 32, 8, s, 128, 1)),
            ("kv_len S", (REQUESTS, 32, 8, s, 128, s)),
            ("ragged", (3, 8, 2, 37, 64, 29)),
            ("ragged-mha", (2, 4, 4, 300, 32, 300)),
            ("gqa3-minitron", (REQUESTS, 24, 8, s, 128, last)),
            ("gqa16", (2, 64, 4, 600, 128, 577)))


#: the cases also run through one captured launch replayed at other kv_len
DECODE_REPLAYED = ("serve", "gqa3-minitron", "gqa16")
# Each decode output within one bf16 ulp of its f64 value, plus this share
# of the largest |o|: the kernel's f32 arithmetic is ~1e-7 of the largest
# output, its rounding to bf16 half an ulp; a P rounded once to bf16 moves
# an output by ~1e-3 of the typical one, many ulps of the small ones.
DECODE_ULP_FLOOR = 2.0 ** -14


def decode_inputs(torch, g, shape):
    """Seeded bf16 q (B, H, hd) and the cache (B, S, Hkv, hd) handed over as
    (B, Hkv, S, hd) views, as the model passes it."""
    b, h, hkv, s, hd, _ = shape

    def randn(*dims):
        return torch.randn(dims, generator=g, device="cuda").to(torch.bfloat16)
    return randn(b, h, hd), randn(b, s, hkv, hd).transpose(1, 2), \
        randn(b, s, hkv, hd).transpose(1, 2)


def decode_exact(torch, q, k, v, kv_len: int):
    """Decode attention over [0, kv_len) in float64: (o, lse)."""
    rep = q.shape[1] // k.shape[1]
    kk = k[:, :, :kv_len].double().repeat_interleave(rep, 1)
    vv = v[:, :, :kv_len].double().repeat_interleave(rep, 1)
    s = torch.einsum("bhd,bhkd->bhk", q.double(), kk) / q.shape[-1] ** 0.5
    lse = torch.logsumexp(s, -1)
    return torch.einsum("bhk,bhkd->bhd", torch.exp(s - lse[..., None]), vv), lse


def bf16_ulp(torch, x):
    """The bf16 unit in the last place at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def decode_check(torch, q, k, v, kv_len: int, o, lse, label: str,
                 check: bool = True) -> dict:
    """One decode call's outputs held: at kv_len 0, o = 0 and lse = -1e30;
    otherwise o within DECODE_REL x max |plain| of the plain version (f32)
    and element by element within one bf16 ulp + DECODE_ULP_FLOOR x max |o|
    of the f64 value, lse within 1e-3. Returns the readings; with ``check``
    raises on a failure."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    torch.cuda.synchronize()
    kv_len = max(0, min(kv_len, k.shape[2]))
    if kv_len == 0:
        zero = bool((o == 0).all()) and bool((lse == -1e30).all())
        if check and not zero:
            raise AssertionError(f"{label}: kv_len 0 must give o = 0, lse = -1e30")
        return {"o_err": 0.0 if zero else float("inf"), "lse_err": 0.0,
                "ulp_excess": 0.0 if zero else float("inf")}
    orf, lser = decode_attention_ref(q, k, v, kv_len, return_lse=True)
    o64, lse64 = decode_exact(torch, q, k, v, kv_len)
    finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
    err = (o.float() - orf.float()).abs().max().item()
    lim = DECODE_REL * orf.float().abs().max().item()
    lse_err = (lse.double() - lse64).abs().max().item()
    lse_lim = 1e-3 * max(1.0, lse64.abs().max().item())
    off = (o.double() - o64).abs()
    allowed = bf16_ulp(torch, o64) + DECODE_ULP_FLOOR * o64.abs().max()
    out = {"o_err": err if finite else float("inf"), "o_lim": lim,
           "lse_err": lse_err if finite else float("inf"),
           "ulp_excess": (off / allowed).max().item() if finite else float("inf"),
           "ulp_outside": int((off > allowed).sum())}
    if check:
        if not (finite and err <= lim):
            raise AssertionError(f"{label}: finite {finite}, max |kernel - plain| "
                                 f"{err:.3g} > {lim:.3g} ({DECODE_REL:g} x max |plain|)")
        if not lse_err <= lse_lim:
            raise AssertionError(f"{label}: lse error {lse_err:.3g}")
        if out["ulp_outside"]:
            raise AssertionError(
                f"{label}: {out['ulp_outside']} outputs further than one bf16 ulp + "
                f"{DECODE_ULP_FLOOR:g} x max |o| from the f64 value (worst "
                f"{out['ulp_excess']:.3g} x the allowance)")
    return out


def decode_replay_check(torch, fn, q, k, v, lens, label: str,
                        check: bool = True) -> dict:
    """``fn(q, k, v, kv_len)`` captured once into a CUDA graph with a device
    kv_len, then replayed with kv_len set on the device to each of ``lens``
    (clamped to [0, S] by the kernel); each replay held by
    :func:`decode_check`. Returns {kv_len: readings}."""
    kl = torch.zeros(1, dtype=torch.int32, device=q.device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the capture
        fn(q, k, v, kl)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, lse = fn(q, k, v, kl)
    out = {}
    for n in lens:
        kl.fill_(n)
        graph.replay()
        out[n] = decode_check(torch, q, k, v, n, o, lse, f"{label} at kv_len {n}",
                              check)
    return out


def decode_bound(b: int, h: int, hkv: int, hd: int, kv_len: int) -> tuple[float, str]:
    """Bytes: q and o (bf16), the kv_len valid K and V rows, the f32 lse;
    operations: two products of 2 hd flops per (head, position)."""
    nb = 2 * b * h * hd * 2 + 2 * b * hkv * kv_len * hd * 2 + b * h * 4
    return bound(nb, 4.0 * b * h * kv_len * hd, BF16_FLOP_PER_S)


def decode_plan(b: int, h: int, hkv: int, hd: int) -> dict:
    from repro_torch.kernels.decode_attention.ops import plan
    return plan(b, h, hkv, hd)


def check_kernels(torch, timer) -> dict:
    """Decode and flash attention against their plain versions at the
    serving shapes and at ragged ones; times at the heaviest serving
    shape."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg = get_config("mistral_nemo_12b")
    B, S = REQUESTS, PROMPT_LEN
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    out = {}

    # ---- decode attention: every phase-3 case (decode_cases), each called
    # eagerly with a device kv_len and through one captured launch replayed
    # with kv_len changed between replays; times at the serving shape
    errs, ulps = [], []
    for label, shape in decode_cases():
        q, k, v = decode_inputs(torch, g, shape)
        kv_len = shape[-1]
        o, lse = decode_attention(q, k, v, torch.full((1,), kv_len, dtype=torch.int32,
                                                      device=dev))
        r = decode_check(torch, q, k, v, kv_len, o, lse, f"decode {label}")
        errs.append(r["o_err"])
        ulps.append(r["ulp_excess"])
        say(f"  decode_attention {label} q {tuple(q.shape)} cache "
            f"{(shape[0], shape[3], shape[2], shape[4])} kv_len {kv_len}: {json.dumps(r)}")
        if label in DECODE_REPLAYED:
            lens = (0, 1, 17, kv_len // 2, kv_len, shape[3], shape[3] + 100)
            reps = decode_replay_check(torch, decode_attention, q, k, v, lens,
                                       f"decode {label} replayed")
            errs += [x["o_err"] for x in reps.values()]
            ulps += [x["ulp_excess"] for x in reps.values()]
            say(f"    one captured launch replayed at kv_len {lens}: max|err| o "
                f"{max(x['o_err'] for x in reps.values()):.3g}, lse "
                f"{max(x['lse_err'] for x in reps.values()):.3g}")
        if label == "serve":
            main = (q, k, v, kv_len)
        del q, k, v, o, lse
    q, k, v, kv_len = main
    b, h, hd = q.shape
    hkv = k.shape[1]
    kl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
    kc, vc = k[:, :, :kv_len], v[:, :, :kv_len]
    b_ms, b_by = decode_bound(b, h, hkv, hd, kv_len)

    def sdpa_decode():
        return sdpa(F, q[:, :, None], kc, vc, causal=False)
    out["decode_attention"] = dict(
        max_abs_err=max(errs), max_ulp_excess=max(ulps),
        ms=timer.ms(lambda: decode_attention(q, k, v, kl), 200),
        plain_ms=timer.ms(lambda: decode_attention_ref(q, k, v, kl,
                                                       return_lse=True), 20),
        library_ms=timer.ms(sdpa_decode, 200),
        bound_ms=b_ms, bound_by=b_by, plan=decode_plan(b, h, hkv, hd),
        clean_l2={"ms": timer.ms(lambda: decode_attention(q, k, v, kl), 200, True),
                  "library_ms": timer.ms(sdpa_decode, 200, True)},
        shape=[b, h, hkv, k.shape[2], hd, kv_len])
    say(f"  decode_attention serve {out['decode_attention']}")

    # ---- flash attention: the prefill's (B, S, H, hd) activations, read
    # transposed; ragged lengths and the 128-row / 128-key tile edges;
    # element-wise and each query row within TRAIN_ROW_REL of its largest
    # plain value (a whole-tensor scale would pass a dropped deep tile)
    errs, rows = [], []
    for label, (b, h, hkv, sq, sk, dh, causal) in flash_cases(B, H, Hkv, S, hd):
        qa, ka, va = randn(b, sq, h, dh), randn(b, sk, hkv, dh), randn(b, sk, hkv, dh)
        args = (qa.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2))
        o = flash_attention(*args, causal=causal)
        want = flash_attention_ref(*args, causal=causal)
        errs.append(compare(torch, o, want, f"flash {label}"))
        rows.append(row_scaled_errs(o, want)[1])
        if not rows[-1] <= TRAIN_ROW_REL:
            raise AssertionError(
                f"flash {label}: a row's max |kernel - plain| is {rows[-1]:.3g} x "
                f"its max |plain| (limit {TRAIN_ROW_REL:g})")
        say(f"  flash_attention {label} q {tuple(args[0].shape)} k "
            f"{tuple(args[1].shape)} causal {causal} max|err| {errs[-1]:.3g}, "
            f"worst row |err| / row max {rows[-1]:.3g}")
        if label == "serve":
            main = args
        del qa, ka, va, args, o, want
    qf, kf, vf = main
    pairs = S * (S + 1) / 2
    nb = (2 * qf.numel() + 2 * kf.numel()) * 2
    b_ms, b_by = bound(nb, 4.0 * B * H * hd * pairs, BF16_FLOP_PER_S)
    out["flash_attention"] = dict(
        max_abs_err=max(errs), max_row_scaled_err=max(rows),
        row_scaled_err_limit=TRAIN_ROW_REL,
        ms=timer.ms(lambda: flash_attention(qf, kf, vf, causal=True), 20),
        plain_ms=timer.ms(lambda: flash_attention_ref(qf, kf, vf, causal=True), 5),
        library_ms=timer.ms(lambda: sdpa(F, qf, kf, vf, causal=True), 20),
        bound_ms=b_ms, bound_by=b_by, shape=[B, H, Hkv, S, S, hd])
    say(f"  flash_attention serve {out['flash_attention']}")
    return out


# ------------------------------- phase 3: RMSNorm -----------------------------
#: Row 1 at the shapes the serving paths give it, (label, rows, d, kind):
#: kind "residual" (the block's add + norm), "plain" (the first norm, no
#: residual) or "gated" (Mamba2's rmsnorm(y * silu(z), w): y float32, z a
#: slice of in_proj's output read through its row stride).
RMSNORM_SHAPES = (("mistral decode", REQUESTS, 5120, "residual"),
                  ("mistral prefill", REQUESTS * PROMPT_LEN, 5120, "residual"),
                  ("mamba2 decode", SSM_REQUESTS, 768, "residual"),
                  ("mamba2 decode gated", SSM_REQUESTS, 1536, "gated"),
                  ("mamba2 prefill", SSM_REQUESTS * PROMPT_LEN, 768, "residual"),
                  ("mamba2 prefill gated", SSM_REQUESTS * PROMPT_LEN, 1536, "gated"))
#: further cases, checked and not timed: the first norm of a pass, widths
#: that take the scalar path, a gate whose rows do not start on 16 bytes
RMSNORM_EXTRA = (("mistral first norm", REQUESTS, 5120, "plain"),
                 ("ragged", 7, 100, "residual"), ("ragged gated", 7, 100, "gated"),
                 ("ragged", 3, 770, "residual"), ("ragged first norm", 3, 770, "plain"),
                 ("ragged gated", 3, 770, "gated"),
                 ("gated unaligned", SSM_REQUESTS, 1536, "gated-unaligned"))
#: launches a decode-shape timing graph holds, each on its own buffers: the
#: norms of one mistral_nemo_12b decode step (1 + 2 x 40)
GRAPH_LAUNCHES = 81
#: rows above which a shape is timed one launch a replay (a launch moves far
#: more than the L2 holds) instead of GRAPH_LAUNCHES
GRAPH_ROWS = 64
RMSNORM_EPS = 1e-6

#: A helper library for row 1's measurements, not a kernel of the port:
#: ``empty_launch`` launches an empty kernel with the geometry of a norm's
#: launch (the floor under its time); ``slow_copy`` triggers its dependents
#: at once, spins, then copies (the predecessor of the race check).
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void empty_kernel() {}
__global__ void slow_copy_kernel(const uint4* src, uint4* dst, long long n, long long spin) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long long t0 = clock64();
  while (clock64() - t0 < spin) {}
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = src[i];
}
extern "C" {
int empty_launch(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
int slow_copy(const void* src, void* dst, long long bytes, long long spin, void* stream) {
  slow_copy_kernel<<<132, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)dst, bytes / 16, spin);
  return (int)cudaGetLastError();
}
}
"""
#: the race check's predecessor spins this many SM cycles (~0.1 ms)
RACE_SPIN_CYCLES = 200_000


def probe_build_start():
    """Start ``nvcc`` on PROBE_SOURCE; :func:`probe_build_finish` loads it."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "rmsnorm-probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(PROBE_SOURCE)
    return out, subprocess.Popen(
        [_build.nvcc(), *_build.FLAGS, "-o", str(out / "libprobe.so"), str(out / "probe.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def probe_build_finish(started):
    import ctypes

    out, proc = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the measurement helper failed to build:\n{log}")
    lib = ctypes.CDLL(str(out / "libprobe.so"))
    lib.empty_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.slow_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_longlong, ctypes.c_void_p]
    return lib


def probe_library():
    return probe_build_finish(probe_build_start())


def rmsnorm_inputs(torch, g, rows: int, d: int, kind: str) -> dict:
    """Seeded inputs of one call: bf16 x (float32 when gated), bf16 r (for
    "residual"), f32 w in [0.5, 1.5); the gate z as the first d columns of a
    (rows, 2 d + 280) bf16 tensor, as the model slices it out of in_proj's
    output (one column further for "gated-unaligned")."""
    dev = torch.device("cuda")
    gated = kind.startswith("gated")
    inp = {"w": torch.rand(d, generator=g, device=dev) + 0.5, "r": None, "z": None}
    inp["x"] = torch.randn(rows, d, generator=g, device=dev)
    if not gated:
        inp["x"] = inp["x"].to(torch.bfloat16)
    if kind == "residual":
        inp["r"] = torch.randn(rows, d, generator=g, device=dev).to(torch.bfloat16)
    if gated:
        wide = (2 * torch.randn(rows, 2 * d + 280, generator=g, device=dev)).to(torch.bfloat16)
        lo = int(kind == "gated-unaligned")
        inp["z"] = wide[:, lo:lo + d]
    return inp


def rmsnorm_call(fn, inp):
    """``fn`` (fused_rmsnorm or a stand-in) on one case's inputs."""
    if inp["z"] is not None:
        return fn(inp["x"], inp["w"], gate=inp["z"], eps=RMSNORM_EPS)
    return fn(inp["x"], inp["w"], inp["r"], eps=RMSNORM_EPS)


def rmsnorm_chain(torch, inp):
    """The gated norm as the unfused chain computes it on the card: the cast,
    F.silu, the product and the norm, four launches."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    return fused_rmsnorm(inp["x"].to(torch.bfloat16) * F.silu(inp["z"]), inp["w"],
                         eps=RMSNORM_EPS)[0]


def rmsnorm_check(torch, inp, y, rout, label: str, check: bool = True) -> dict:
    """One call's outputs held: y within TOL of the plain version, and
    element by element within one bf16 ulp of its f64 value computed from
    the same inputs (gated: from the chain's g on the card); the new
    residual bit-identical to bf16(f32(x) + f32(r)) (x without a residual);
    gated, y within one bf16 ulp of the unfused chain (:func:`rmsnorm_chain`).
    A kernel that drops a warp's partial sum at d 5120 moves every y by
    ~2.6 %, inside TOL at |y| ~ 1 and several ulps off. Returns the
    readings; with ``check`` raises on a failure."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref

    torch.cuda.synchronize()
    gated = inp["z"] is not None
    yr = rmsnorm_call(fused_rmsnorm_ref, inp)[0]
    finite = bool(torch.isfinite(y.float()).all())
    err = (y.float() - yr.float()).abs()
    out = {"max_abs_err": err.max().item() if finite else float("inf"),
           "tol_outside": int((err > TOL["atol"] + TOL["rtol"] * yr.float().abs()).sum())}
    if gated:
        s = (inp["x"].to(torch.bfloat16) * F.silu(inp["z"])).double()
    else:
        s = inp["x"].double() + (inp["r"].double() if inp["r"] is not None else 0.0)
    y64 = s * torch.rsqrt((s * s).mean(-1, keepdim=True) + RMSNORM_EPS) * inp["w"].double()
    off = (y.double() - y64).abs() / bf16_ulp(torch, y64)
    out["ulp_excess"] = off.max().item() if finite else float("inf")
    out["ulp_outside"] = int((off > 1).sum()) if finite else y.numel()
    if gated:
        chain = rmsnorm_chain(torch, inp)
        gap = (y.double() - chain.double()).abs() / bf16_ulp(torch, chain.double())
        out["chain_ulp_excess"] = gap.max().item() if finite else float("inf")
        out["chain_identical_share"] = (y == chain).double().mean().item()
        out["residual_identical"] = rout is None
    else:
        want = (inp["x"].float() + (inp["r"].float() if inp["r"] is not None else 0.0))
        out["residual_identical"] = bool(torch.equal(rout, want.to(torch.bfloat16)))
    if check:
        bad = []
        if not finite or out["tol_outside"]:
            bad.append(f"max |kernel - plain| {out['max_abs_err']:.3g} outside "
                       f"rtol={TOL['rtol']:g}, atol={TOL['atol']:g} ({out['tol_outside']} outputs)")
        if out["ulp_outside"]:
            bad.append(f"{out['ulp_outside']} outputs further than one bf16 ulp from the f64 "
                       f"value (worst {out['ulp_excess']:.3g} ulps)")
        if not out["residual_identical"]:
            bad.append("the new residual is not bf16(f32(x) + f32(r)) bit for bit")
        if gated and not out["chain_ulp_excess"] <= 1:
            bad.append(f"the gated norm is {out['chain_ulp_excess']:.3g} ulps from the unfused chain")
        if bad:
            raise AssertionError(f"rmsnorm {label}: " + "; ".join(bad))
    return out


def rmsnorm_bound(rows: int, d: int, kind: str) -> tuple[float, str]:
    """Bytes: x (and r) read, y (and the new residual) written in bf16, w in
    f32; gated: the f32 y and the bf16 z read, the bf16 output written.
    Operations: ~5 an element (the add, the square, the scalings), ~15
    gated (the exp and the divide of the SiLU, its product)."""
    per = {"residual": 8, "plain": 6}.get(kind, 8)
    return bound(rows * d * per + d * 4, (15.0 if kind.startswith("gated") else 5.0) * rows * d,
                 F32_FLOP_PER_S)


def rmsnorm_times(torch, timer, probe, fn, g, rows: int, d: int, kind: str,
                  yardsticks: bool = True) -> dict:
    """Device time per launch of ``fn`` at one shape. Up to GRAPH_ROWS rows
    (decode): GRAPH_LAUNCHES launches, each on its own inputs and outputs,
    captured in one graph, replayed with the L2 flushed by a read, per
    launch; beside it the same graph of an empty kernel with the norm's
    launch geometry (``floor_ms``) and of the library yardstick. More rows
    (prefill): one launch a replay, with the L2 flushed by a read (``ms``)
    and by a write (``write_flush_ms``). The yardstick: F.rms_norm(x + r),
    or for the gated norm the four-kernel chain it replaces."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm.ops import plan

    n = GRAPH_LAUNCHES if rows <= GRAPH_ROWS else 1
    cases = [rmsnorm_inputs(torch, g, rows, d, kind) for _ in range(n)]
    pl = plan(rows, d, kind.startswith("gated"))
    stream = lambda: _build.stream_ptr(torch.device("cuda"))  # noqa: E731

    def graph(call, clean=True, iters=30 if n > 1 else 50):
        return timer.ms(lambda: [call(c) for c in cases], iters, clean) / n

    def empty(_):
        _build.check("rmsnorm", probe.empty_launch(pl["grid"], pl["threads"], stream()))

    def library(c):
        if c["z"] is not None:
            return rmsnorm_chain(torch, c)
        return F.rms_norm(c["x"] + c["r"], (d,), c["w"].to(torch.bfloat16), RMSNORM_EPS)
    b_ms, b_by = rmsnorm_bound(rows, d, kind)
    out = {"shape": [rows, d], "kind": kind, "launches_a_replay": n, "plan": pl,
           "ms": graph(lambda c: rmsnorm_call(fn, c)), "floor_ms": graph(empty),
           "bound_ms": b_ms, "bound_by": b_by}
    if yardsticks:
        out["library_ms"] = graph(library)
    if n == 1:
        out["write_flush_ms"] = graph(lambda c: rmsnorm_call(fn, c), clean=False)
        if yardsticks:
            out["library_write_flush_ms"] = graph(library, clean=False)
    out["bound_share"] = b_ms / out["ms"]
    return out


def rmsnorm_race_check(torch, probe, fn, check: bool = True, trials: int = 4) -> dict:
    """The norm reads x only after its predecessor is done: a predecessor
    that triggers its dependents at once, spins RACE_SPIN_CYCLES and only
    then copies new data into x is followed by the norm of x, eagerly and
    as one captured graph replayed with new data each time; every output
    must equal, bit for bit, the norm of the new data computed on its own.
    At the mistral and the gated mamba2 decode shapes. The port launches
    the norm plainly, so stream order alone holds this; launched as a
    programmatic dependent (``tools/rmsnorm_planted_faults.py``'s pdl_on
    and wait_after_x_loads), it holds only while the kernel waits before
    its first read of x. Returns the mismatching outputs per route; with
    ``check`` raises on any."""
    from repro_torch.kernels import _build

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = {}
    for label, rows, d, kind in (RMSNORM_SHAPES[0], RMSNORM_SHAPES[3]):
        inp = rmsnorm_inputs(torch, g, rows, d, kind)
        src = torch.empty_like(inp["x"])
        case = dict(inp, x=torch.zeros_like(inp["x"]))

        def step():
            _build.check("rmsnorm", probe.slow_copy(
                _build.ptr(src), _build.ptr(case["x"]), src.numel() * src.element_size(),
                RACE_SPIN_CYCLES, _build.stream_ptr(src.device)))
            return rmsnorm_call(fn, case)[0]

        def fresh():
            src.copy_(torch.randn(src.shape, generator=g, device="cuda").to(src.dtype))

        def wrong(y):
            torch.cuda.synchronize()
            want = rmsnorm_call(fn, dict(inp, x=src.clone()))[0]
            torch.cuda.synchronize()
            return int((y != want).sum())
        eager = []
        for _ in range(trials):
            fresh()
            eager.append(wrong(step()))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = step()
        replayed = []
        for _ in range(trials):
            fresh()
            graph.replay()
            replayed.append(wrong(y))
        out[label] = {"eager_wrong": eager, "replayed_wrong": replayed}
        if check and any(eager + replayed):
            raise AssertionError(f"rmsnorm race check {label}: outputs that are not the "
                                 f"norm of the new x: eager {eager}, replayed {replayed}")
        del graph
    return out


def check_rmsnorm(torch, timer, probe) -> dict:
    """Row 1: every case of RMSNORM_SHAPES and RMSNORM_EXTRA held by
    :func:`rmsnorm_check`, one launch counted per call; the race check; the
    six shapes timed (:func:`rmsnorm_times`). The top-level times are at the
    mistral prefill shape with the L2 flushed by a write, as every earlier
    reading of row 1 was taken and as row 2's are, the read flush's beside
    them (``clean_l2``)."""
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    checks = {}
    for label, rows, d, kind in RMSNORM_SHAPES + RMSNORM_EXTRA:
        inp = rmsnorm_inputs(torch, g, rows, d, kind)
        n = fused_rmsnorm.launches
        y, rout = rmsnorm_call(fused_rmsnorm, inp)
        if fused_rmsnorm.launches != n + 1:
            raise AssertionError(f"rmsnorm {label}: {fused_rmsnorm.launches - n} launches "
                                 f"counted for one call")
        key = f"{label} ({rows}, {d})"
        checks[key] = rmsnorm_check(torch, inp, y, rout, key)
        say(f"  rmsnorm {key} {kind}: {json.dumps(checks[key])}")
    race = rmsnorm_race_check(torch, probe, fused_rmsnorm)
    say(f"  rmsnorm race check (a predecessor that writes x last): {json.dumps(race)}")
    shapes = {}
    for label, rows, d, kind in RMSNORM_SHAPES:
        shapes[label] = rmsnorm_times(torch, timer, probe, fused_rmsnorm, g, rows, d, kind)
        say(f"  rmsnorm {label} {json.dumps(shapes[label])}")
    main = rmsnorm_inputs(torch, g, *RMSNORM_SHAPES[1][1:])
    top = shapes[RMSNORM_SHAPES[1][0]]
    return dict(max_abs_err=max(c["max_abs_err"] for c in checks.values()),
                max_ulp_excess=max(c["ulp_excess"] for c in checks.values()),
                ms=top["write_flush_ms"],
                plain_ms=timer.ms(lambda: rmsnorm_call(fused_rmsnorm_ref, main), 10),
                library_ms=top["library_write_flush_ms"],
                clean_l2={"ms": top["ms"], "library_ms": top["library_ms"]},
                bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], shape=top["shape"], shapes=shapes, race=race,
                checks=checks)


# ------------------------------- phase 3: SSD ---------------------------------
def ssd_work(b: int, s: int, h: int, p: int, n: int) -> int:
    """Multiply-adds of the chunked scan at the kernel's tile q, the causal
    half of each q x q product counted: C B^T once per (sequence, chunk),
    since B and C are shared by the heads; per (sequence, head, chunk) the
    masked scores times x dt, C h and B^T x dt."""
    from repro_torch.kernels.ssd.ref import CHUNK as q

    nc = -(-s // q)
    tri = q * (q + 1) // 2
    return b * nc * tri * n + b * h * nc * (tri * p + 2 * q * n * p)


def ssd_cases(torch, B, S, H, P, N):
    """(label, args, plain, (B, C) as stored) of every phase-3 SSD case: the
    serving shape of mamba2_130m in the model's layout, x, B and C slices of
    one convolution output and B/C shared by the heads (head stride 0), as
    ssm_layer passes them; B/C per head; the Pallas kernel's (BH, S, .)
    layout; ragged lengths (S = 100, S = 1, S = q + 1); P != N in f32; P = 40,
    N = 72 in bf16 and f32 (warps and N not filled); a strong decay."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd.ref import ssd_scan_ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    def model_case(b, s, h, p, n, dtype, shared=True, decay=0.5):
        # x, B and C as ssm_layer passes them: slices of one (b, s, h p + 2n)
        # convolution output, a position stride of h p + 2n (B/C per head:
        # h p + 2 h n)
        nbc = n if shared else h * n
        xbc = randn(b, s, h * p + 2 * nbc)
        xbc[..., h * p:] *= 0.3
        xs, Bm, Cm = torch.split(xbc.to(dtype), [h * p, nbc, nbc], dim=-1)
        x = xs.view(b, s, h, p)
        dt = F.softplus(randn(b, s, h))
        dA = dt * -torch.exp(randn(h, scale=decay))
        if shared:
            bc = (Bm[:, :, None].expand(b, s, h, n), Cm[:, :, None].expand(b, s, h, n))
        else:
            bc = (Bm.view(b, s, h, n), Cm.view(b, s, h, n))
        args = (x, dt, *bc, dA)

        def plain():
            y, st = ssd_scan_ref(*(t.transpose(1, 2) for t in args))
            return y.transpose(1, 2), st
        return args, plain, (Bm, Cm)

    def contract_case(bh, s, p, n):
        dt = F.softplus(randn(bh, s))
        args = (randn(bh, s, p), dt, randn(bh, s, n, scale=0.3),
                randn(bh, s, n, scale=0.3), -0.1 * dt)
        return args, lambda: ssd_scan_ref(*args), args[2:4]

    bf = torch.bfloat16
    return (("serve", *model_case(B, S, H, P, N, bf)),
            ("per-head B/C", *model_case(2, 300, 4, P, N, bf, shared=False)),
            ("contract", *contract_case(48, 512, P, N)),
            ("ragged", *model_case(2, 100, 3, P, N, bf)),
            ("S=1", *model_case(2, 1, 3, P, N, bf)),
            ("S=q+1", *model_case(2, 65, 3, P, N, bf)),
            ("P!=N", *model_case(2, 300, 4, 16, 32, torch.float32)),
            ("P=40,N=72", *model_case(2, 300, 4, 40, 72, bf)),
            ("P=40,N=72 f32", *model_case(2, 300, 4, 40, 72, torch.float32, shared=False)),
            ("strong decay", *model_case(2, 1024, 4, P, N, bf, decay=2.0)))


def ssd_bytes(args, bc) -> int:
    """Bytes the scan must move: x, dt, dA, B and C as stored, read once;
    y and the final state (f32) written once."""
    x, dt, _, _, dA = args
    b, s, h = dt.shape
    p, n = x.shape[-1], bc[0].shape[-1]
    return (x.numel() * x.element_size() + (dt.numel() + dA.numel()) * 4
            + sum(t.numel() * t.element_size() for t in bc)
            + x.numel() * 4 + b * h * p * n * 4)


def ssd_split_work(b: int, s: int, h: int, p: int, n: int) -> int:
    """Multiply-adds of the same scan on tensor cores at f32 accuracy from
    bf16 inputs: C B^T one exact bf16 product, the other three with one
    operand split into three bf16 terms (ssd.cu's header)."""
    from repro_torch.kernels.ssd.ref import CHUNK as q

    nc = -(-s // q)
    tri = q * (q + 1) // 2
    return b * nc * tri * n + 3 * b * h * nc * (tri * p + 2 * q * n * p)


def check_ssd(torch, timer) -> dict:
    """The SSD kernel against its plain version (f32 math, rtol = atol =
    2e-4 on y and the final state) on every case of :func:`ssd_cases`; two
    calls at the serving shape bit-identical; times at the serving shape.
    Two bounds: the f32 work on the CUDA cores (``f32_core_ms``, 67 TFLOP/s)
    and the same f32-accurate work on the bf16 tensor cores, the larger of
    its bytes and its split products at 989 TFLOP/s (``bound_ms``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd.ops import ssd_chunk

    cfg = get_config("mamba2_130m")
    d_in = cfg.ssm_expand * cfg.d_model
    B, S, H, P, N = SSM_REQUESTS, PROMPT_LEN, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    errs = []
    for label, args, plain, bc in ssd_cases(torch, B, S, H, P, N):
        y, st = ssd_chunk(*args)
        yr, sr = plain()
        errs += [compare(torch, y, yr, f"ssd {label} y", SSD_TOL),
                 compare(torch, st, sr, f"ssd {label} state", SSD_TOL)]
        say(f"  ssd {label} x {tuple(args[0].shape)} {str(args[0].dtype)[6:]} "
            f"strides {args[0].stride()} B strides {args[2].stride()} state "
            f"{tuple(st.shape)} max|err| y {errs[-2]:.3g} state {errs[-1]:.3g} "
            f"(max|y| {yr.abs().max().item():.3g})")
        if label == "serve":
            main = args, plain, bc, errs[-2]
            y2, st2 = ssd_chunk(*args)
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                raise AssertionError("ssd serve: two calls differ")
            say("  ssd serve: two calls bit-identical (y and state)")
        del y, st, yr, sr
    args, plain, bc, serve_err = main
    nb = ssd_bytes(args, bc)
    b_ms, b_by = bound(nb, 2.0 * ssd_split_work(B, S, H, P, N), BF16_FLOP_PER_S)
    f32_ms, _ = bound(nb, 2.0 * ssd_work(B, S, H, P, N), F32_FLOP_PER_S)
    out = dict(max_abs_err=max(errs), serve_max_abs_err_y=serve_err,
               ms=timer.ms(lambda: ssd_chunk(*args), 20),
               plain_ms=timer.ms(plain, 5), library_ms=None,
               bound_ms=b_ms, bound_by=b_by, f32_core_ms=f32_ms,
               shape=[B, S, H, P, N])
    say(f"  ssd serve {out}")
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


# ------------------------------- phase 3: training attention ------------------
def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes: all, or those with key <=
    query (top-left causal)."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


TRAIN_KERNELS = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")
# the training kernels' cases: (label, (B, H, Hkv, Sq, Sk, hd, causal))
TRAIN_CASES = (("train", (TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 128, True)),
               ("gqa-ragged", (2, 24, 8, 1000, 1000, 128, True)),
               ("hd64-full", (2, 8, 2, 700, 900, 64, False)),
               # the forward's 128-row / 128-key tile edges, n_rep 4
               ("edge-127", (1, 8, 2, 127, 127, 128, True)),
               ("edge-128-full", (1, 8, 2, 128, 128, 128, False)),
               ("edge-129", (1, 8, 2, 129, 129, 64, True)),
               ("edge-257", (1, 8, 2, 257, 257, 32, True)),
               ("edge-sq>sk", (1, 8, 2, 300, 129, 128, True)))


def training_inputs(torch, shape, seed: int = SEED + 3):
    """Seeded bf16 q, k, v, dO in the model's (B, S, heads, hd) layout,
    handed over as (B, heads, S, hd) views."""
    b, h, hkv, sq, sk, hd, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*dims):
        return torch.randn(dims, generator=g, device="cuda").bfloat16().transpose(1, 2)
    return (randn(b, sq, h, hd), randn(b, sk, hkv, hd), randn(b, sk, hkv, hd),
            randn(b, sq, h, hd))


def training_case(torch, q, k, v, do, causal: bool, label: str,
                  check: bool = True) -> dict:
    """Run the three training kernels once on (q, k, v, dO) and hold each
    output against its plain version: o, dq (per query row), dk, dv (per
    key row) within TRAIN_ROW_REL of their row's largest plain value, lse
    within 1e-3; with ``check``, a second call of each backward kernel must
    give the same bits (no atomics: one thread sums each output in one
    order). Returns, per output, the max abs error, the error over the
    whole tensor's max |plain| and the worst row's ratio. ``check=False``
    only measures (the planted-fault tool reads what would have failed)."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_fwd_lse)
    from repro_torch.kernels.flash_attention.ref import (
        attention_delta, flash_attention_bwd_dkv_ref,
        flash_attention_bwd_dq_ref, flash_attention_fwd_lse_ref)

    out = {}

    def held(name, got, want):
        torch.cuda.synchronize()
        whole, rows = row_scaled_errs(got, want)
        finite = bool(torch.isfinite(got.float()).all())
        out[name] = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                     "whole_scaled_err": whole, "row_scaled_err": rows,
                     "finite": finite}
        if check and not (finite and rows <= TRAIN_ROW_REL):
            raise AssertionError(
                f"{label} {name}: finite {finite}, a row's max |kernel - plain|"
                f" is {rows:.3g} x its max |plain| (limit {TRAIN_ROW_REL:g})")

    o, lse = flash_attention_fwd_lse(q, k, v, causal)
    orf, lser = flash_attention_fwd_lse_ref(q, k, v, causal)
    held("o", o, orf)
    lse_err = (lse - lser).abs().max().item()
    out["lse"] = {"max_abs_err": lse_err}
    if check and not lse_err <= 1e-3 * max(1.0, lser.abs().max().item()):
        raise AssertionError(f"fwd_lse {label}: lse error {lse_err:.3g}")
    del orf
    # the backward kernels take the plain forward's statistics, so that
    # each kernel is held alone
    dd = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
    dkr, dvr = flash_attention_bwd_dkv_ref(q, k, v, do, lser, dd, causal)
    held("dk", dk, dkr)
    held("dv", dv, dvr)
    del dkr, dvr
    dq = flash_attention_bwd_dq(q, k, v, do, lser, dd, causal)
    held("dq", dq, flash_attention_bwd_dq_ref(q, k, v, do, lser, dd, causal))
    if check:
        dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
        dq2 = flash_attention_bwd_dq(q, k, v, do, lser, dd, causal)
        out["bit_identical"] = all(bool(torch.equal(a, b)) for a, b in (
            (dk, dk2), (dv, dv2), (dq, dq2)))
        if not out["bit_identical"]:
            raise AssertionError(f"{label}: two calls of the backward kernels "
                                 f"gave different bits")
    out["inputs"] = (lse, dd)
    return out


def check_training_kernels(torch, timer) -> dict:
    """The forward with LSE and the dK/dV and dQ kernels against their plain
    versions (o and dq per query row, dk and dv per key row, within 2e-2 of
    the row's largest plain value; lse within 1e-3) at the olmo_1b training
    shape, a GQA ragged shape and hd 64 full attention, all in the model's
    (B, S, heads, hd) layout read transposed; times at the training shape.
    The library yardstick is scaled_dot_product_attention: its forward for
    the forward kernel; its backward (forward + backward through autograd,
    less the forward) does the work of both backward kernels together, so
    it stands beside their sum, not beside either one."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_fwd_lse)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
        flash_attention_fwd_lse_ref)

    cfg = get_config("olmo_1b")
    assert TRAIN_CASES[0][1][1:3] == (cfg.n_heads, cfg.n_kv_heads)
    assert TRAIN_CASES[0][1][5] == cfg.hd
    names = TRAIN_KERNELS
    errs = dict.fromkeys(names, 0.0)
    rel = dict.fromkeys(names, 0.0)
    of = {names[0]: ("o",), names[1]: ("dk", "dv"), names[2]: ("dq",)}
    for label, shape in TRAIN_CASES:
        q, k, v, do = training_inputs(torch, shape)
        causal = shape[-1]
        res = training_case(torch, q, k, v, do, causal, label)
        for name in names:
            errs[name] = max([errs[name]] + [res[x]["max_abs_err"] for x in of[name]])
            rel[name] = max([rel[name]] + [res[x]["row_scaled_err"] for x in of[name]])
        say(f"  training attention {label} q {tuple(q.shape)} k "
            f"{tuple(k.shape)} causal {causal}: worst row |err| / row max "
            + ", ".join(f"{x} {res[x]['row_scaled_err']:.3g}"
                        for x in ("o", "dk", "dv", "dq"))
            + f"; lse max|err| {res['lse']['max_abs_err']:.3g}; backward "
            f"bit-identical across two calls {res['bit_identical']}")
        if label == "train":
            main = (q, k, v, do, *res["inputs"])
        del res
        torch.cuda.empty_cache()

    q, k, v, do, lse, dd = main
    b, h, s, hd = q.shape
    pairs = attention_pairs(s, s, True)
    mm = 2.0 * b * h * hd * pairs          # flops of one (S, S) x hd product
    qb = q.numel() * 2                     # bytes of one bf16 (B, H, S, hd)
    kb = k.numel() * 2
    rows = lse.numel() * 4
    work = {names[0]: (2 * qb + 2 * kb + rows, 2 * mm),
            names[1]: (2 * qb + 4 * kb + 2 * rows, 4 * mm),
            names[2]: (3 * qb + 2 * kb + 2 * rows, 3 * mm)}
    calls = {names[0]: (lambda: flash_attention_fwd_lse(q, k, v, True),
                        lambda: flash_attention_fwd_lse_ref(q, k, v, True)),
             names[1]: (lambda: flash_attention_bwd_dkv(q, k, v, do, lse, dd, True),
                        lambda: flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd, True)),
             names[2]: (lambda: flash_attention_bwd_dq(q, k, v, do, lse, dd, True),
                        lambda: flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, True))}
    # the kernels first, then the library, then the plain versions: a kernel
    # timed right after a plain version (GBs of f32 temporaries) can read
    # slower (dQ right after the plain dK/dV read 12 % slower on an H100)
    kernel_ms = {name: timer.ms(calls[name][0], 20) for name in names}
    lib_fwd = timer.ms(lambda: sdpa(F, q, k, v, causal=True), 20)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa_fwd_bwd():
        for t in leaves:
            t.grad = None
        sdpa(F, *leaves, causal=True).backward(do)
    lib_fwd_bwd = timer.eager_ms(sdpa_fwd_bwd, 20)
    del leaves
    out = {}
    for name in names:
        plain = calls[name][1]
        nb, fl = work[name]
        b_ms, b_by = bound(nb, fl, BF16_FLOP_PER_S)
        # no one library call computes dK/dV or dQ alone: SDPA's backward
        # is both kernels' work, and is given as the pair's yardstick
        lib = (dict(library_ms=lib_fwd) if name == names[0] else
               dict(library_ms=None,
                    library_bwd_pair_ms=lib_fwd_bwd - lib_fwd,
                    library_note="SDPA backward (forward + backward through "
                                 "autograd less the forward): the work of "
                                 "dK/dV and dQ together"))
        out[name] = dict(max_abs_err=errs[name], max_row_scaled_err=rel[name],
                         row_scaled_err_limit=TRAIN_ROW_REL,
                         ms=kernel_ms[name],
                         plain_ms=timer.ms(plain, 3), **lib,
                         bound_ms=b_ms, bound_by=b_by, gflop=fl / 1e9,
                         shape=[b, h, k.shape[1], s, s, hd])
    pair = out[names[1]]["ms"] + out[names[2]]["ms"]
    for name in names[1:]:
        out[name]["bwd_pair_ms"] = pair
    for name in names:
        say(f"  {name} train {out[name]}")
    return out


# ------------------------------- phase 4 --------------------------------------
def exact_rows(rows: list[dict]) -> list[dict]:
    """Sweep rows with every float spelled exactly (``float.hex``)."""
    return [{k: v.hex() if isinstance(v, float) else v for k, v in r.items()}
            for r in rows]


def _timed_out(what: str, seconds: float = PARALLEL_TIMEOUT_S) -> None:
    print(f"chip_smoke: FAILED: {what} did not finish in {seconds} s",
          file=sys.stderr, flush=True)
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
                                 f"counters {c}; profiled device events "
                                 f"{split['events']}")
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


def profiler_recheck(torch, kernels) -> dict:
    """``reprice_grid`` once more on the kernel backend under a fresh
    profiler, after the serving paths' profiles: the pricing-kernel and
    kernel-launch events it recorded beside the launch counter. Reported,
    not checked: once, after serving profiles, the profiler recorded no
    pricing-kernel event while the counter saw the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.core import DSEEngine
    from repro_torch.search import DenseGridSpec
    from repro_torch.workloads.scenarios import get_scenario

    engine = DSEEngine(parallel=False, pricing_backend="kernel")
    spec = DenseGridSpec.dense(100_000).spec()
    work = get_scenario("llm", smoke=True).work_fn
    engine.reprice_grid(work, spec)                 # warm the plan
    kernels.reset_launches()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        engine.reprice_grid(work, spec)
        torch.cuda.synchronize()
    seen = {}
    for e in prof.key_averages():
        if "pricing_kernel" in e.key or "LaunchKernel" in e.key:
            on = "device" if getattr(e, "device_type", None) == DeviceType.CUDA else "host"
            seen[f"{e.key[:40]} ({on})"] = e.count
    return {"counter": kernels.launches()["pricing"], "profiler": seen}


# ------------------------------- phase 4b -------------------------------------
def _search_policy(search, name: str, n: int):
    """A shipped policy and its certification budget: random and surrogate
    walk the whole grid, halving runs on a quarter of it."""
    if name == "random":
        return search.RandomSearch(seed=0, batch_size=8), n
    if name == "halving":
        return search.SuccessiveHalving(eta=4), max(1, -(-n // 4))
    return search.SurrogateSearch(seed=0, batch_size=6, min_train=6), n


def _search_key(res) -> tuple:
    return (res.evals_used, res.cheap_evals, res.best_index, res.oracle_index)


def check_dse_features(kernels) -> dict[str, int]:
    """Phase 4b: the learned rank stage, budgeted search and the DSE service
    daemon on the card, each against the numpy backend in this process.
    Every step is fatal; the launch counters are zeroed just before each
    step and read just after. Returns the pricing launches summed."""
    import warnings

    from repro_torch import learned, search
    from repro_torch.core import DSEEngine, clear_caches
    from repro_torch.search import DenseGridSpec
    from repro_torch.service import DSEClient, DSEService
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

    def launched(backend: str, c: dict) -> int:
        key = "pricing_f32" if backend == "kernel-f32" else "pricing"
        n = c[key] if backend != "torch" else 0
        if backend in ("kernel", "kernel-f32") and not n:
            raise AssertionError(f"{backend}: no pricing launch")
        return n

    # 1. the ranker: fitted from the smoke sweeps' harvest on the card and
    # on numpy, then every scenario rank on against rank off
    t0 = time.perf_counter()
    models = {}
    for backend in ("kernel", "numpy"):
        clear_caches()
        eng = DSEEngine(parallel=False, pricing_backend=backend, prune="on")
        _, c = counted(lambda: [eng.sweep_scenario(n, smoke=True)
                                for n in SMOKE_SCENARIOS])
        launched(backend, c)
        models[backend] = learned.fit_ranker()
    got, want = models["kernel"], models["numpy"]
    fields = ("n_train", "n_groups", "keep_frac", "recall")
    say(f"  ranker from the seven smoke sweeps on kernel: "
        + ", ".join(f"{f} {getattr(got, f)!r}" for f in fields)
        + f" (recall target {got.recall_target}); numpy: "
        + ", ".join(f"{f} {getattr(want, f)!r}" for f in fields))
    if got.recall < got.recall_target:
        raise AssertionError(f"ranker recall {got.recall} < {got.recall_target}")
    if ([getattr(got, f) for f in fields] != [getattr(want, f) for f in fields]
            or got.fingerprint != want.fingerprint):
        raise AssertionError("the ranker fitted on kernel differs from numpy's")
    for name in SMOKE_SCENARIOS:
        ref = DSEEngine(parallel=False, pricing_backend="numpy", prune="on",
                        rank="on")
        rows = exact_rows(ref.sweep_scenario(name, smoke=True).rows())
        want = ref.last_plan_stats
        off = exact_rows(DSEEngine(parallel=False, pricing_backend="numpy",
                                   prune="on").sweep_scenario(
            name, smoke=True).rows())
        if rows != off or not want["rank"]:
            raise AssertionError(f"{name}: numpy rank on differs from off")
        note = []
        for backend in ("kernel", "kernel-f32", "torch"):
            for rank in ("on", "off"):
                eng = DSEEngine(parallel=False, pricing_backend=backend,
                                prune="on", rank=rank)
                res, c = counted(lambda: eng.sweep_scenario(name, smoke=True))
                st = eng.last_plan_stats
                if exact_rows(res.rows()) != rows:
                    raise AssertionError(f"{name} {backend} rank {rank}: "
                                         f"rows differ from numpy's")
                if rank == "on" and (not st["rank"] or any(
                        st[k] != want[k] for k in ("survived", "rank_survived",
                                                   "priced"))):
                    raise AssertionError(f"{name} {backend}: rank stats {st} "
                                         f"against numpy's {want}")
                note.append(f"{backend}/{rank} {launched(backend, c)}")
        say(f"  {name}: rank on prices {want['rank_survived']} of "
            f"{want['survived']} dominance survivors; rows identical to numpy "
            f"rank on and off; launches {', '.join(note)}")
    say(f"  ranker step in {time.perf_counter() - t0:.1f} s")

    # 2. reprice_grid with rank on at 100,224 cells: the grid's rank-off pass
    # first (it fills the harvest, so every rank-on engine below fits the
    # same model), then numpy's rank-on report as the reference
    t0 = time.perf_counter()
    spec = DenseGridSpec.dense(100_000).spec()
    work = get_scenario("llm", smoke=True).work_fn
    keys = ("cells", "enumerated", "survived", "rank_survived", "priced_rows",
            "chunks")
    DSEEngine(parallel=False, pricing_backend="numpy").reprice_grid(work, spec)
    ref = DSEEngine(parallel=False, pricing_backend="numpy",
                    rank="on").reprice_grid(work, spec)
    say(f"  reprice_grid numpy rank on: "
        + ", ".join(f"{k} {ref[k]}" for k in keys + ("rank", "rank_keep_frac")))
    if not ref["rank"] or ref["rank_survived"] >= ref["survived"]:
        raise AssertionError(f"reprice_grid numpy: the rank stage did not run: {ref}")
    for backend in ("kernel", "kernel-f32"):
        engines = {rank: DSEEngine(parallel=False, pricing_backend=backend,
                                   rank=rank) for rank in ("off", "on")}
        for eng in engines.values():
            eng.reprice_grid(work, spec)                      # warm the plan
        price_s = {"off": [], "on": []}
        rows = {}
        for _ in range(REPRICE_TURNS):                        # in turns
            for rank, eng in engines.items():
                rep, c = counted(lambda: eng.reprice_grid(work, spec))
                n = launched(backend, c)
                if n != rep["chunks"] or not rep["winners_identical"]:
                    raise AssertionError(
                        f"reprice_grid {backend} rank {rank}: {n} launches "
                        f"for {rep['chunks']} chunks")
                if rank == "on" and {k: rep[k] for k in keys} != {
                        k: ref[k] for k in keys}:
                    raise AssertionError(f"reprice_grid {backend} rank on: "
                                         f"{rep} against numpy's {ref}")
                price_s[rank].append(rep["price_s"])
                rows[rank] = (rep["priced_rows"], rep["drift"]["repriced"]
                              if rep["drift"] else 0)
        say(f"  reprice_grid {backend}: winners identical to numpy, one "
            f"launch a pass; price_s in turns, rank on ({rows['on'][0]} "
            f"rows, {rows['on'][1]} re-priced exactly) "
            + ", ".join(f"{t:.6f}" for t in price_s["on"])
            + f" s against rank off ({rows['off'][0]} rows, "
            f"{rows['off'][1]} re-priced exactly) "
            + ", ".join(f"{t:.6f}" for t in price_s["off"]) + " s")
    say(f"  reprice step in {time.perf_counter() - t0:.1f} s")

    # 3. certified searches on the card against numpy's
    t0 = time.perf_counter()
    sc = get_scenario("llm", smoke=True)

    def run_search(backend, work_fn, spec, make):
        eng = DSEEngine(parallel=False, pricing_backend=backend)
        pol, budget = make()
        t = time.perf_counter()
        res, c = counted(lambda: eng.search(work_fn, spec, policy=pol,
                                            budget=budget))
        secs = time.perf_counter() - t
        if not res.certified or res.best_index != res.oracle_index:
            raise AssertionError(f"search {res.policy} on {backend}: "
                                 f"not certified ({res.best_index}, "
                                 f"{res.oracle_index})")
        return res, launched(backend, c), secs

    def both(label, work_fn, spec, make):
        got, n, secs = run_search("kernel", work_fn, spec, make)
        want, _, _ = run_search("numpy", work_fn, spec, make)
        if _search_key(got) != _search_key(want):
            raise AssertionError(f"search {label}: {_search_key(got)} against "
                                 f"numpy's {_search_key(want)}")
        say(f"  search {label}: certified, best {got.best_index} = oracle, "
            f"{got.evals_used} full evaluations of {len(spec.grid())} cells, "
            f"{got.cheap_evals} cheap bounds, identical to numpy; "
            f"{n} launches; {secs:.2f} s on kernel")
        return secs

    n = len(sc.spec.grid())
    for policy in ("random", "halving", "surrogate"):
        both(f"{policy} llm smoke", sc.work_fn, sc.spec,
             lambda: _search_policy(search, policy, n))
    largest, secs, cells = None, 0.0, 0
    for size in SEARCH_LADDER:
        spec = (DenseGridSpec() if size is None
                else DenseGridSpec.dense(size)).spec()
        n = len(spec.grid())
        if cells and secs * n / cells > SEARCH_LIMIT_S:
            say(f"  search halving: dense({size}) ({n} cells) skipped, "
                f"predicted {secs * n / cells:.0f} s > {SEARCH_LIMIT_S} s")
            break
        secs = both(f"halving dense {n}", work, spec,
                    lambda: (search.SuccessiveHalving(eta=8), max(1, n // 5)))
        cells = n
        if secs <= SEARCH_LIMIT_S:
            largest = (n, secs)
    if largest is None:
        raise AssertionError(f"no dense search finished within "
                             f"{SEARCH_LIMIT_S} s")
    say(f"  largest dense grid searched (halving, certified) within "
        f"{SEARCH_LIMIT_S} s on the card: {largest[0]} cells in "
        f"{largest[1]:.2f} s")
    say(f"  search step in {time.perf_counter() - t0:.1f} s")

    # 4. the daemon: started after CUDA is initialized, its warm pool by
    # forkserver; two clients with 6 overlapping cells, a search, a reprice
    t0 = time.perf_counter()
    sc = get_scenario("llm", smoke=True)
    grid = sc.spec.grid()
    want = {it.index: (None if it.point is None else exact_rows([it.point.row()])[0])
            for it in DSEEngine(parallel=False, pricing_backend="numpy")
            .sweep_cells_iter(sc.work_fn, grid, sc.spec)}
    n = len(grid)
    a_cells, b_cells = list(range(0, 2 * n // 3)), list(range(n // 3, n))
    overlap = len(set(a_cells) & set(b_cells))
    svc = DSEService(max_workers=2, shared_cache=True,
                     pricing_backend="kernel", rank="on")
    method = svc.engine._start_method()
    if method != "forkserver":
        raise AssertionError(f"CUDA is initialized but the daemon's pool "
                             f"starts by {method}")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="warm session pool unavailable")
        svc.start()
    try:
        pool = svc.engine._session_pool
        if pool is None:
            raise AssertionError("the daemon has no warm pool")
        workers = list(pool._processes.values())
        replies: dict = {}

        def client(name, cells):
            with DSEClient(svc.path) as cli:
                replies[name] = cli.sweep(scenario="llm", smoke=True,
                                          cells=cells, client=name)

        kernels.reset_launches()
        t = time.perf_counter()
        threads = [threading.Thread(target=client, args=("A", a_cells)),
                   threading.Thread(target=client, args=("B", b_cells))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        cold_s = time.perf_counter() - t
        with DSEClient(svc.path) as cli:
            sched = cli.stats()["scheduler"]
            t = time.perf_counter()
            warm = cli.sweep(scenario="llm", smoke=True)
            warm_s = time.perf_counter() - t
            found = cli.search(scenario="llm", smoke=True, policy="halving")
            rep = cli.reprice(scenario="llm", smoke=True)
            # a scenario no request has planned yet, on the warm workers
            t = time.perf_counter()
            other = cli.sweep(scenario="dlrm", smoke=True)
            other_s = time.perf_counter() - t
            stats = cli.stats()
        c = kernels.launches()
        for k in total:
            total[k] += c[k]
        for name, cells in (("A", a_cells), ("B", b_cells)):
            r = replies.get(name)
            got = {i: None if p is None else exact_rows([p.row()])[0]
                   for i, p in zip(r.indices, r.points)} if r else {}
            if got != {i: want[i] for i in cells}:
                raise AssertionError(f"daemon client {name}: rows differ from "
                                     f"the numpy engine's")
        if exact_rows(warm.rows()) != [want[i] for i in range(n) if want[i]]:
            raise AssertionError("daemon warm sweep: rows differ")
        if exact_rows(other.rows()) != exact_rows(
                p.row() for p in DSEEngine(parallel=False,
                                           pricing_backend="numpy")
                .sweep_scenario("dlrm", smoke=True).points):
            raise AssertionError("daemon dlrm sweep: rows differ")
        if sched["dedup_hits"] != overlap or sched["cells_priced"] != n:
            raise AssertionError(f"daemon dedup: {sched}, overlap {overlap}")
        ref = DSEEngine(parallel=False, pricing_backend="numpy").search(
            sc.work_fn, sc.spec, policy=search.SuccessiveHalving(), budget=n)
        s = found.summary
        if (not s["certified"] or (s["evals_used"], s["cheap_evals"],
                                   s["best_index"], s["oracle_index"])
                != _search_key(ref)):
            raise AssertionError(f"daemon search: {s} against numpy's "
                                 f"{_search_key(ref)}")
        if not rep["winners_identical"] or rep["backend"] != "kernel":
            raise AssertionError(f"daemon reprice: {rep}")
        if not c["pricing"]:
            raise AssertionError(f"daemon: no pricing launch during the "
                                 f"requests ({c})")
        say(f"  daemon (forkserver pool of 2, mmap store, rank on): cold "
            f"request (two clients, {overlap} overlapping of {n} cells) "
            f"{cold_s:.4f} s, warm repeat {warm_s:.4f} s, a new scenario "
            f"(dlrm, 18 cells) on the warm workers {other_s:.4f} s; rows "
            f"identical to "
            f"numpy; {sched['dedup_hits']} dedup hits, {sched['cells_priced']} "
            f"cells priced; search halving certified, best "
            f"{s['best_index']}, {s['evals_used']} evaluations; reprice "
            f"winners identical; {c['pricing']} pricing launches; "
            f"ranker fitted {stats['engine']['rank_model']}; store "
            f"{json.dumps(stats['shared_store_delta'])}")
    finally:
        svc.close()
    if os.path.exists(svc.path) or svc.engine._session_pool is not None:
        raise AssertionError("the daemon left its socket or its pool")
    for p in workers:
        p.join(timeout=10)
    alive = [p.pid for p in workers if p.is_alive()]
    if alive:
        raise AssertionError(f"daemon pool workers still alive: {alive}")
    # what a fresh pool worker pays before its first plan: the import of
    # the scenario registry a request's work_fn lives in (reported only)
    probe = subprocess.run(
        [sys.executable, "-c", "import time; t = time.perf_counter(); "
         "import repro_torch.workloads.scenarios; "
         "print(time.perf_counter() - t)"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    say(f"  daemon step in {time.perf_counter() - t0:.1f} s (shut down: "
        f"socket gone, {len(workers)} workers gone); importing "
        f"repro_torch.workloads.scenarios in a fresh process: "
        f"{probe.stdout.strip() or probe.stderr[-300:]} s")
    return total


# ------------------------------- phases 5-7 -----------------------------------
def scaled_err(got, want) -> float:
    """Largest difference over the largest reference value."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def check_small_model(torch, arch: str) -> dict:
    """The kernels' model on the card against the plain versions on the CPU:
    the SMOKE config of ``arch`` in bf16, same weights, prefill plus 4
    teacher-forced decode steps; logits of every step and the final cache,
    within 2e-2 of their largest value."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill, to_device

    cfg = get_config(arch, smoke=True)
    cpu = init_params(cfg, seed=SEED, device="cpu")
    g = torch.Generator().manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=g)
    s, steps = 16, 4

    def run(params, dev):
        with torch.no_grad():
            lg, cache = prefill(cfg, params, toks[:, :s].to(dev), max_len=s + steps)
            outs = [lg]
            for i in range(steps):
                lg, cache = decode_step(cfg, params, cache,
                                        toks[:, s + i].to(dev), s + i)
                outs.append(lg)
        return [o.cpu() for o in outs], {k: v.cpu() for k, v in cache.items()}

    want, want_cache = run(cpu, "cpu")
    got, got_cache = run(to_device(cpu, "cuda"), "cuda")
    out = {"scaled_err": max(scaled_err(a, w) for a, w in zip(got, want)),
           "cache_scaled_err": max(scaled_err(got_cache[k], want_cache[k])
                                   for k in want_cache)}
    if not max(out.values()) <= SCALED_TOL_SMALL:
        raise AssertionError(f"small model {arch}: card vs CPU {out}")
    return out


def seq_scaled_err(got, want) -> float:
    """The largest of each sequence's scaled error (leading dimension)."""
    g, w = got.float().flatten(1), want.float().flatten(1)
    return ((g - w).abs().amax(1) / w.abs().amax(1)).max().item()


def full_model_readings(torch, cfg, params, prompts, tokens) -> dict:
    """At full size: the decode path's logits (cache and ``decode_step``:
    the decode kernel, or the SSM recurrence) for the generated tokens
    against one forward pass (the flash kernel, or the chunked scan) over
    the prompt and those tokens, the largest of each sequence's scaled
    error; and the greedy tokens against that pass's argmax. For an SSM
    config also the state handoff: the cache after the prompt's prefill and
    the decode steps against the cache of one prefill over the same tokens,
    layer by layer, the largest of each sequence's scaled error, and each
    layer alone (:func:`ssm_layers_alone`). Reads, checks nothing."""
    from repro_torch.models import decode_step, forward, prefill

    gen = torch.tensor(tokens, device=prompts.device).t()  # (B, n)
    n, s = gen.shape[1], prompts.shape[1]
    seq = torch.cat([prompts, gen[:, :-1]], 1)
    with torch.no_grad():
        full = forward(cfg, params, seq)
        teacher = full[:, s - 1:]                           # (B, n, V)
        if not bool(torch.isfinite(teacher.float()).all()):
            raise AssertionError("full model: non-finite logits")
        agree = (teacher.argmax(-1) == gen).float().mean().item()
        del full
        _, cache = prefill(cfg, params, prompts, max_len=s + n)
        worst = 0.0
        for i in range(n - 1):
            lg, cache = decode_step(cfg, params, cache, gen[:, i], s + i)
            worst = max(worst, seq_scaled_err(lg, teacher[:, i + 1]))
        del teacher
        out = {"decode_vs_prefill_scaled_err": worst, "greedy_agreement": agree}
        if not cfg.attention_free:
            return out
        _, whole = prefill(cfg, params, seq)
        for k in ("ssm", "conv"):
            out[f"{k}_handoff_scaled_err_by_layer"] = [
                float(f"{seq_scaled_err(cache[k][b], whole[k][b]):.3g}")
                for b in range(cfg.n_blocks)]
        del cache, whole
        out["layer_alone_scaled_err_by_layer"] = ssm_layers_alone(
            torch, cfg, params, seq, s)
    return out


def check_full_model(torch, cfg, params, prompts, tokens) -> dict:
    """A dense config's :func:`full_model_readings`: decode vs prefill
    within SCALED_TOL_FULL and greedy agreement at least 0.8."""
    out = full_model_readings(torch, cfg, params, prompts, tokens)
    if not (out["decode_vs_prefill_scaled_err"] <= SCALED_TOL_FULL
            and out["greedy_agreement"] >= 0.8):
        raise AssertionError(f"full model: decode vs prefill beyond "
                             f"{SCALED_TOL_FULL:g} or greedy agreement "
                             f"under 0.8: {out}")
    return out


@contextlib.contextmanager
def plain_scan():
    """The model's scan through ``ssd_scan_ref`` on the card, for the
    comparison route of phase 7 only: ``models.layers.ssd_chunk`` is
    replaced by the plain version, with the layout transposes the wrapper
    makes for CPU tensors, and restored on exit."""
    from repro_torch.kernels.ssd.ref import ssd_scan_ref
    from repro_torch.models import layers

    kernel = layers.ssd_chunk

    def plain(x, dt, B, C, dA):
        y, h = ssd_scan_ref(*(t.transpose(1, 2) for t in (x, dt, B, C, dA)))
        return y.transpose(1, 2).contiguous(), h

    layers.ssd_chunk = plain
    try:
        yield
    finally:
        layers.ssd_chunk = kernel


def serve_inputs(torch, cfg, requests: int, seed: int):
    """The weights and prompts ``run_serve`` makes from ``seed``."""
    from repro_torch.models import init_params

    params = init_params(cfg, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (requests, PROMPT_LEN),
                            generator=gen, device="cuda")
    return params, prompts


def ssm_summary(r: dict) -> dict:
    """The readings phase 7 holds to a limit, from one route and seed."""
    ssm, conv = r["ssm_handoff_scaled_err_by_layer"], r["conv_handoff_scaled_err_by_layer"]
    alone = r["layer_alone_scaled_err_by_layer"]
    return {"logits": r["decode_vs_prefill_scaled_err"],
            "greedy": r["greedy_agreement"],
            "ssm": max(ssm), "ssm_layer": ssm.index(max(ssm)),
            "conv": max(conv), "conv_layer": conv.index(max(conv)),
            "first": max(ssm[0], conv[0]),
            "alone_out": max(e[0] for e in alone),
            "alone_state_conv": max(max(e[1:]) for e in alone)}


def ssm_model_readings(torch, cfg, requests: int, served_tokens,
                       routes=("kernel", "plain")) -> dict:
    """:func:`full_model_readings` of ``cfg`` for every seed of SSM_SEEDS
    and route: the served seed with the tokens ``run_serve`` generated,
    every other seed with the greedy tokens the kernel route generates
    from that seed's weights; both routes see the same tokens. Returns
    {route: {seed: readings}}."""
    from repro_torch.serve import ServeEngine

    out = {route: {} for route in routes}
    for seed in SSM_SEEDS:
        params, prompts = serve_inputs(torch, cfg, requests, seed)
        tokens = served_tokens
        if seed != SEED or tokens is None:
            engine = ServeEngine(cfg, params, max_batch=requests,
                                 max_len=PROMPT_LEN + NEW_TOKENS + 1,
                                 device=prompts.device)
            tokens = engine.generate(prompts, n_tokens=NEW_TOKENS).tokens
            del engine
        for route in routes:
            with plain_scan() if route == "plain" else contextlib.nullcontext():
                out[route][seed] = full_model_readings(torch, cfg, params,
                                                       prompts, tokens)
        del params
        torch.cuda.empty_cache()
    return out


def ssm_verdict(readings: dict) -> list[str]:
    """The limits of phase 7 (see SSM_TIGHT, SSM_REL) on
    :func:`ssm_model_readings`' result; returns the limits broken."""
    broken = []
    for route, by_seed in readings.items():
        for seed, r in by_seed.items():
            s = ssm_summary(r)
            tight = route == "kernel"
            for key, ok in (("greedy", s["greedy"] >= 0.8),
                            ("alone_out", s["alone_out"] <= SCALED_TOL_SMALL),
                            ("first", not tight or s["first"] <= SSM_TIGHT),
                            ("alone_state_conv", not tight
                             or s["alone_state_conv"] <= SSM_TIGHT)):
                if not ok:
                    broken.append(f"{route} seed {seed}: {key} {s[key]:.3g}")
    if {"kernel", "plain"} <= set(readings):
        for key in ("logits", "ssm", "conv"):
            got, base = (max(ssm_summary(r)[key] for r in readings[route].values())
                         for route in ("kernel", "plain"))
            if not got <= SSM_REL * base:
                broken.append(f"deep {key}: kernel {got:.3g} > {SSM_REL:g} x "
                              f"plain {base:.3g}")
    return broken


def check_ssm_model(torch, cfg, requests: int, served_tokens) -> dict:
    """Phase 7's whole-model check: :func:`ssm_model_readings` on both
    routes, printed per seed and route, then :func:`ssm_verdict`."""
    readings = ssm_model_readings(torch, cfg, requests, served_tokens)
    for route, by_seed in readings.items():
        for seed, r in by_seed.items():
            summary = {k: float(f"{v:.3g}") for k, v in ssm_summary(r).items()}
            say(f"    {route} route, seed {seed}: {json.dumps(summary)}")
            say(f"      ssm handoff by layer {r['ssm_handoff_scaled_err_by_layer']}")
            say(f"      conv handoff by layer {r['conv_handoff_scaled_err_by_layer']}")
    broken = ssm_verdict(readings)
    if broken:
        raise AssertionError(f"full model (mamba2): limits broken: {broken}")
    return {route: {seed: ssm_summary(r) for seed, r in by_seed.items()}
            for route, by_seed in readings.items()}


def ssm_layers_alone(torch, cfg, params, seq, s: int) -> list[float]:
    """Each SSM layer alone, on the inputs the teacher-forced forward gives
    it: its outputs at the positions after the first ``s``, from a prefill
    of the layer over those s positions (the chunked scan) and then its
    decode recurrence token by token from the state and conv tail that
    prefill left, against its outputs from one chunked scan over the whole
    sequence; and the state and conv tail the recurrence ends with against
    those of that scan. Depth amplifies nothing here. Scaled errors
    [output, state, conv tail], per layer."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _run_stack

    errs = []

    def mix(blk, slot, lp, h):
        p = lp["ssm"]
        whole, whole_state, whole_tail = L.ssm_layer(p, h, cfg)
        _, state, tail = L.ssm_layer(p, h[:, :s], cfg)
        tail = tail.contiguous()
        steps = [L.ssm_decode_step(p, h[:, t:t + 1], state, tail, cfg)[0]
                 for t in range(s, h.shape[1])]
        errs.append([float(f"{scaled_err(a, b):.3g}") for a, b in (
            (torch.cat(steps, 1), whole[:, s:]), (state, whole_state),
            (tail, whole_tail))])
        return whole

    with torch.no_grad():
        _run_stack(cfg, params, params["embed"][seq].to(torch.bfloat16), mix)
    return errs


def graph_vs_eager(torch, cfg, params, prompts, served=None) -> dict:
    """The engine's decode path (the first step eager, then the captured
    step replayed) against ``decode_step`` called eagerly, greedy, over all
    NEW_TOKENS - 1 decode steps from the same prompts: the tokens must be
    identical, to each other and to ``served`` (``run_serve``'s, where
    given), and the largest logit difference is reported (expected 0: the
    same kernels on the same inputs). Also the engine's capture count and
    time."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import ServeEngine

    b, s = prompts.shape
    engine = ServeEngine(cfg, params, max_batch=b, max_len=s + NEW_TOKENS + 1)
    with torch.no_grad():
        logits, slot = engine._prefill(prompts)
        graph_toks, graph_logits = [logits[:, -1].argmax(-1)], []
        for i in range(NEW_TOKENS - 1):
            lg = engine._decode(slot, graph_toks[-1], s + i)
            graph_logits.append(lg.clone())
            graph_toks.append(lg.argmax(-1))
        captures, capture_s = engine.captures, engine.capture_s
        del engine, slot
        logits, cache = prefill(cfg, params, prompts, max_len=s + NEW_TOKENS + 1)
        eager_toks, diff = [logits[:, -1].argmax(-1)], 0.0
        for i in range(NEW_TOKENS - 1):
            lg, cache = decode_step(cfg, params, cache, eager_toks[-1], s + i)
            diff = max(diff, (lg.float() - graph_logits[i].float()).abs().max().item())
            eager_toks.append(lg.argmax(-1))
        del cache, graph_logits
    graph_toks = [t.tolist() for t in graph_toks]
    eager_toks = [t.tolist() for t in eager_toks]
    out = {"steps": NEW_TOKENS - 1, "tokens_identical": graph_toks == eager_toks,
           "served_identical": served is None or graph_toks == served,
           "max_logit_diff": diff, "captures": captures, "capture_s": capture_s}
    if not (out["tokens_identical"] and out["served_identical"] and captures == 1):
        raise AssertionError(f"{cfg.name}: the captured decode step differs from "
                             f"the eager one, or captured other than once: {out}")
    return out


def capture_failure_raises() -> int:
    """Child process of phase 9: a decode step that reads a value on the
    host (as a step still taking its position as a Python int would) cannot
    be captured; the engine must raise, not decode eagerly."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine, engine as engine_mod

    cfg = get_config("mistral_nemo_12b", smoke=True)
    step = engine_mod.decode_step

    def host_reading_step(cfg, params, cache, token, pos):
        if torch.cuda.is_current_stream_capturing():
            int(pos.sum())
        return step(cfg, params, cache, token, pos)

    engine_mod.decode_step = host_reading_step
    engine = ServeEngine(cfg, init_params(cfg, seed=SEED), max_batch=2, max_len=16)
    prompts = torch.zeros((2, 8), dtype=torch.int64, device="cuda")
    try:
        engine.generate(prompts, n_tokens=4)
    except RuntimeError as e:
        if "does not decode eagerly" in str(e):
            cause = " ".join(str(e.__cause__).split())
            print(f"capture failure raised: {str(e)[:160]} (from "
                  f"{type(e.__cause__).__name__}: {cause[:160]})")
            return 0
        raise
    print("capture failure: generate returned", file=sys.stderr)
    return 1


def check_serving(torch, kernels, arch: str, requests: int,
                  want: dict[str, int], phase: int, cfg=None,
                  short: bool = False) -> dict[str, int]:
    """The serving path of ``arch`` (or of ``cfg``, a cut of it) at full
    size (phase N), then steady state and correctness (phase N + 1 for the
    dense path unless ``short``, the same phase for the SSM one). ``short``
    leaves out the small config (a cut config has none the kernels take).
    Returns the launch counts of the ``run_serve`` call."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch) if cfg is None else cfg
    say(f"[{phase}] run_serve {cfg.name}: {requests} requests x {PROMPT_LEN} "
        f"prompt tokens x {NEW_TOKENS} new tokens, seed {SEED}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = run_serve(cfg, requests=requests, prompt_len=PROMPT_LEN,
                    tokens=NEW_TOKENS, seed=SEED)
    counts = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in counts} | want
    say(f"    TTFT {res.ttft * 1e3:.3f} ms, TPOT {res.tpot * 1e3:.4f} ms, "
        f"{res.tokens_per_s:.2f} tokens/s, peak memory "
        f"{peak / 2**30:.3f} GiB; launches {counts}")
    if counts != want:
        raise AssertionError(f"{arch}: launch counts {counts} != {want}")
    if len(res.tokens) != NEW_TOKENS or any(
            len(t) != requests or not all(0 <= x < cfg.vocab for x in t)
            for t in res.tokens):
        raise AssertionError(f"{arch}: generated tokens malformed")

    params, prompts = serve_inputs(torch, cfg, requests, SEED)
    say(f"    graph vs eager decode: {json.dumps(graph_vs_eager(torch, cfg, params, prompts, res.tokens))}")
    engine = ServeEngine(cfg, params, max_batch=requests,
                         max_len=PROMPT_LEN + NEW_TOKENS + 1)
    cold = engine.generate(prompts, n_tokens=NEW_TOKENS)
    captures = engine.captures
    warm = engine.generate(prompts, n_tokens=NEW_TOKENS)
    if warm.tokens != res.tokens or cold.tokens != res.tokens:
        raise AssertionError(f"{arch}: a second run from the same seed gave "
                             f"other tokens")
    if captures != 1 or engine.captures != 1:
        raise AssertionError(f"{arch}: captures {captures} in a new engine's "
                             f"generate, {engine.captures} after a warm one")
    steady = engine.decode_steady(prompts, n_steps=16, warmup=2)
    if not (cfg.attention_free or short):
        phase += 1
    say(f"[{phase}] new engine's generate (captures the step once, "
        f"{engine.capture_s * 1e3:.3f} ms): TTFT {cold.ttft * 1e3:.3f} ms, TPOT "
        f"{cold.tpot * 1e3:.4f} ms")
    say(f"    warm generate (captures nothing): TTFT {warm.ttft * 1e3:.3f} ms, "
        f"TPOT {warm.tpot * 1e3:.4f} ms, {warm.tokens_per_s:.2f} tokens/s")
    say(f"    decode_steady through the graph: TPOT mean {steady.tpot * 1e3:.4f} "
        f"ms, min {min(steady.step_times) * 1e3:.4f}, max "
        f"{max(steady.step_times) * 1e3:.4f} over {len(steady.step_times)} "
        f"steps; {steady.tokens_per_s:.2f} tokens/s")
    if cfg.attention_free:
        say(f"    whole model, decode vs prefill, kernel and plain scan, seeds "
            f"{SSM_SEEDS}:")
        check_ssm_model(torch, cfg, requests, res.tokens)
    else:
        full = check_full_model(torch, cfg, params, prompts, res.tokens)
        say(f"    full-size consistency: {full}")
    with torch.no_grad():
        logits, cache = prefill(cfg, params, prompts, max_len=PROMPT_LEN + 2)
        tok = logits[:, -1].argmax(-1)
        decode_step(cfg, params, cache, tok, PROMPT_LEN)      # warm
        say(f"    profile of one eager decode step: {profile(torch, lambda: decode_step(cfg, params, cache, tok, PROMPT_LEN))}")
        del logits, cache
        logits, slot = engine._prefill(prompts)
        tok = logits[:, -1].argmax(-1)
        engine._decode(slot, tok, PROMPT_LEN)                 # a replay, warm
        say(f"    profile of one replayed decode step (token and position "
            f"writes, the graph): {profile(torch, lambda: engine._decode(slot, tok, PROMPT_LEN + 1))}")
        del logits, slot, engine
        say(f"    profile of one prefill: {profile(torch, lambda: prefill(cfg, params, prompts))}")
    del params
    torch.cuda.empty_cache()
    if not short:
        small = check_small_model(torch, arch)
        say(f"    small config, card vs CPU plain: {small}")
    return counts


# ------------------------------- phase 8: training ----------------------------
def leaf_grads(torch, cfg, params, batch):
    """(loss, [gradient per leaf]) of ``loss_fn`` through autograd."""
    from repro_torch.models import loss_fn
    from repro_torch.train.optimizer import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), list(grads)


def check_train_grads(torch, kernels) -> dict:
    """olmo_1b at full width with 2 layers, batch 2 x 2048: loss and every
    parameter gradient through the kernels (flash_attention_train) against
    the same model whose attention is the plain forward under autograd,
    swapped in here for the comparison."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import init_params, layers, param_dtype, synth_batch

    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=GRAD_LAYERS)
    params = init_params(cfg, seed=SEED, dtype=param_dtype(cfg))
    batch = synth_batch(cfg, GRAD_BATCH, TRAIN_SEQ,
                        torch.Generator(device="cuda").manual_seed(SEED + 4))
    kernels.reset_launches()
    loss, grads = leaf_grads(torch, cfg, params, batch)
    counts = kernels.launches()
    kernel_attention = layers.flash_attention_train
    layers.flash_attention_train = flash_attention_ref
    try:
        kernels.reset_launches()
        want_loss, want = leaf_grads(torch, cfg, params, batch)
        if any(kernels.launches().values()):
            raise AssertionError(f"the plain model launched kernels: "
                                 f"{kernels.launches()}")
    finally:
        layers.flash_attention_train = kernel_attention
    # tree_leaves order: dict keys sorted (empty norm trees hold no leaf)
    names = ["embed", *[f"l{i}.{w}" for i in range(GRAD_LAYERS)
                        for w in ("wk", "wo", "wq", "wv", "mlp.wi", "mlp.wo")]]
    errs = [scaled_err(g, w) for g, w in zip(grads, want)]
    by_name = dict(zip(names, grads))
    attn_norms = {f"l{i}.{w}": by_name[f"l{i}.{w}"].norm().item()
                  for i in range(GRAD_LAYERS) for w in ("wq", "wk", "wv")}
    out = {"loss": loss.item(), "plain_loss": want_loss.item(),
           "max_scaled_err": max(errs), "launches": counts,
           "attn_grad_norms": attn_norms, "n_leaves": len(grads),
           "scaled_err_by_leaf": {k: float(f"{e:.3g}") for k, e in zip(names, errs)}}
    if len(grads) != len(names):
        raise AssertionError(f"gradient check: {len(grads)} leaves")
    n = cfg.n_layers
    if counts != {**dict.fromkeys(counts, 0), "flash_attention_fwd_lse": 2 * n,
                  "flash_attention_bwd_dkv": n, "flash_attention_bwd_dq": n}:
        raise AssertionError(f"gradient check: launches {counts}")
    if not (abs(out["loss"] - out["plain_loss"]) <= SCALED_TOL_SMALL * out["plain_loss"]
            and max(errs) <= SCALED_TOL_SMALL and min(attn_norms.values()) > 0
            and all(bool(torch.isfinite(g).all()) for g in grads)):
        raise AssertionError(f"gradient check beyond {SCALED_TOL_SMALL:g}, "
                             f"or a zero attention gradient: {out}")
    del params, grads, want
    torch.cuda.empty_cache()
    return out


def check_smoke_training(torch) -> dict:
    """The SMOKE config's 3 train steps on the card against the same steps
    on the CPU (plain versions): losses within 2e-2, parameters at the
    reference's rtol 2e-2, atol 2e-3 (lr 1e-4, so that Adam's sign on a
    near-zero gradient moves a weight by at most 3 x 2e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_dtype, to_device
    from repro_torch.train import AdamWConfig, SyntheticTokens, adamw_init, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config("olmo_1b", smoke=True)
    cpu = init_params(cfg, seed=SEED, device="cpu", dtype=param_dtype(cfg))
    gpu = to_device(cpu, "cuda")
    step = make_train_step(cfg, AdamWConfig(lr=1e-4))
    data = iter(SyntheticTokens(cfg.vocab, 4, 64, seed=SEED))
    out = {"loss_cpu": [], "loss_card": []}
    opt_cpu, opt_gpu = adamw_init(cpu), adamw_init(gpu)
    for _ in range(3):
        b = next(data)
        _, _, m = step(cpu, opt_cpu, b)
        out["loss_cpu"].append(float(m["loss"]))
        _, _, m = step(gpu, opt_gpu, {k: v.cuda() for k, v in b.items()})
        out["loss_card"].append(float(m["loss"]))
    rel = max(abs(a - b) / b for a, b in zip(out["loss_card"], out["loss_cpu"]))
    worst = max(((a.cpu() - b).abs() - 2e-2 * b.abs()).max().item()
                for a, b in zip(tree_leaves(gpu), tree_leaves(cpu)))
    out.update(loss_rel_diff=rel, param_excess_over_rtol=worst)
    if not (rel <= 2e-2 and worst <= 2e-3):
        raise AssertionError(f"SMOKE training card vs CPU: {out}")
    return out


def train_flops(cfg, n_params: int, batch: int, seq: int) -> dict:
    """FLOPs of one step. Model FLOPs (the MFU numerator): 6 N T for the
    matmul weights (tied head included) plus 3x the causal attention
    forward (4 B H hd pairs per layer), no recomputation. Executed: adds
    remat's second forward (2 N T + the attention forward) and counts the
    backward kernels' seven (S, S) x hd products per layer."""
    n_mm = n_params                     # every leaf is a matmul weight here
    t = batch * seq
    attn_fwd = cfg.n_layers * 4.0 * batch * cfg.n_heads * cfg.hd * \
        attention_pairs(seq, seq, True)
    model = 6.0 * n_mm * t + 3 * attn_fwd
    executed = 8.0 * n_mm * t + attn_fwd * (2 + 3.5)
    return {"model_flops": model, "executed_flops": executed}


def check_training(torch, kernels) -> dict[str, int]:
    """``run_train`` on the full olmo_1b, 8 x 2048, on one repeated batch,
    launch counters zeroed just before and read just after; then one full
    step under the profiler. Returns the launch counts of the run."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_train
    from repro_torch.models import init_params, param_dtype
    from repro_torch.train import AdamWConfig, SyntheticTokens, adamw_init, make_train_step

    cfg = get_config("olmo_1b")
    say(f"[8] run_train {cfg.name}: {TRAIN_STEPS} steps x {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens on one repeated batch, seed {SEED}, remat "
        f"{cfg.remat}")
    kernels.reset_launches()
    res = run_train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    seed=SEED, repeat=True)
    counts = kernels.launches()
    n = cfg.n_layers * TRAIN_STEPS
    want = {**dict.fromkeys(counts, 0), "flash_attention_fwd_lse": 2 * n,
            "flash_attention_bwd_dkv": n, "flash_attention_bwd_dq": n}
    steady = res.step_times[1:]
    fl = train_flops(cfg, res.n_params, TRAIN_BATCH, TRAIN_SEQ)
    mean = sum(steady) / len(steady)
    say(f"    {res.n_params:,} params; losses {[round(x, 4) for x in res.losses]}")
    say(f"    step times (s) {[round(x, 4) for x in res.step_times]}; steady "
        f"mean {mean:.4f} s, min {min(steady):.4f} s; {res.tokens_per_s:.1f} "
        f"tokens/s; peak memory {res.peak_memory_bytes / 2**30:.3f} GiB")
    say(f"    FLOPs per step: model {fl['model_flops']:.4g} (6 N T + 3 x "
        f"attention forward), executed {fl['executed_flops']:.4g} (remat "
        f"and the 7-product backward); share of {BF16_FLOP_PER_S:.3g} "
        f"FLOP/s at the steady mean: MFU "
        f"{fl['model_flops'] / mean / BF16_FLOP_PER_S:.4f}, executed "
        f"{fl['executed_flops'] / mean / BF16_FLOP_PER_S:.4f}; floor "
        f"{fl['executed_flops'] / BF16_FLOP_PER_S:.4f} s")
    say(f"    launches {counts}")
    if counts != want:
        raise AssertionError(f"training: launch counts {counts} != {want}")
    first, last = res.losses[0], res.losses[-1]
    expect = math.log(cfg.vocab) + 0.5
    if not (all(math.isfinite(x) for x in res.losses)
            and abs(first - expect) <= 0.5 and last < first):
        raise AssertionError(f"training: losses {res.losses} (step 0 should "
                             f"be near {expect:.3f}, the last below it)")

    params = init_params(cfg, seed=SEED, dtype=param_dtype(cfg))
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig())
    batch = next(iter(SyntheticTokens(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=SEED, device="cuda")))
    step(params, opt, batch)                         # warm
    say(f"    profile of one train step: "
        f"{profile(torch, lambda: float(step(params, opt, batch)[2]['loss']))}")
    del params, opt
    torch.cuda.empty_cache()
    return counts


# ------------------------------- main -----------------------------------------
def main() -> int:
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        return fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

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
    probe_started = probe_build_start()
    logs = _build.build_all(verbose=True)
    probe = probe_build_finish(probe_started)
    say(f"[2] built {len(logs)} kernels for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "smem", "error", "warning")):
                say(f"    {name}: {line.strip()}")
    rmsnorm_build = ptxas_report(logs["rmsnorm"], RMSNORM_ENTRY, rmsnorm_label)
    say(f"    rmsnorm kernels (registers, spilled bytes, static shared memory): "
        f"{json.dumps(rmsnorm_build)}")
    spilled = [k for k, v in rmsnorm_build.items() if v.get("spill_bytes", 1)]
    if len(rmsnorm_build) != RMSNORM_BUILDS or spilled:
        return fail(f"rmsnorm build: {len(rmsnorm_build)} kernels, spills in {spilled}")
    flash_build = flash_build_report(logs["flash_attention"])
    say(f"    flash-attention kernels (registers at entry, spilled bytes, "
        f"dynamic shared memory): {json.dumps(flash_build)}")
    spilled = [k for k, v in flash_build.items() if v.get("spill_bytes", 1)]
    if len(flash_build) != 12 or spilled:
        return fail(f"flash-attention build: {len(flash_build)} kernels, "
                    f"spills in {spilled}")
    decode_build = decode_build_report(logs["decode_attention"])
    say(f"    decode kernels (registers, spilled bytes, dynamic shared memory): "
        f"{json.dumps(decode_build)}")
    spilled = [k for k, v in decode_build.items() if v.get("spill_bytes", 1)]
    if len(decode_build) != 15 or spilled:
        return fail(f"decode build: {len(decode_build)} kernels, spills in {spilled}")
    ssd_build = ssd_build_report(logs["ssd"])
    say(f"    SSD kernels (registers, spilled bytes, dynamic shared memory "
        f"at P = 64): {json.dumps(ssd_build)}")
    spilled = [k for k, v in ssd_build.items() if v.get("spill_bytes", 1)]
    if len(ssd_build) != 4 or spilled:
        return fail(f"SSD build: {len(ssd_build)} kernels, spills in {spilled}")

    # 3. kernels vs plain
    say("[3] kernels against their plain versions (bf16, rtol=atol=2e-2; "
        "rmsnorm also within one bf16 ulp of f64, the residual bit for bit; "
        f"decode o within {DECODE_REL:g} x max|plain|, lse within 1e-3; "
        "ssd rtol=atol=2e-4; training attention each row within "
        f"{TRAIN_ROW_REL:g} of its max|plain|; "
        f"pricing f64 bit for bit, f32 within {DRIFT_BAND:g} of f64)")
    timer = Timer(torch)
    numbers = {"rmsnorm": check_rmsnorm(torch, timer, probe) | {"build": rmsnorm_build}}
    numbers.update(check_kernels(torch, timer))
    numbers["decode_attention"]["build"] = decode_build
    numbers["ssd"] = check_ssd(torch, timer) | {"build": ssd_build}
    numbers.update(check_training_kernels(torch, timer))
    for name, kernel in (("flash_attention", "flash_fwd_kernel<128>"),
                         ("flash_attention_fwd_lse", "flash_fwd_kernel<128, lse>"),
                         ("flash_attention_bwd_dkv", "flash_bwd_dkv_kernel<128>"),
                         ("flash_attention_bwd_dq", "flash_bwd_dq_kernel<128>")):
        numbers[name]["build_hd128"] = flash_build[kernel]
    numbers.update(check_pricing(torch, timer))
    del timer
    torch.cuda.empty_cache()

    # 4. the DSE path
    say("[4] DSE price phase: sweeps, a parallel sweep and reprice_grid on "
        "the kernel backends against numpy")
    t0 = time.perf_counter()
    dse = check_dse(kernels)
    say(f"    DSE path in {time.perf_counter() - t0:.1f} s; pricing launches "
        f"{dse['pricing']}, pricing_f32 launches {dse['pricing_f32']}")

    # 4b. the learned rank stage, budgeted search and the service daemon
    say("[4b] DSE rank stage, certified searches and the service daemon on "
        "the kernel backends against numpy")
    t0 = time.perf_counter()
    watchdog = threading.Timer(PHASE4B_TIMEOUT_S, _timed_out,
                               ("phase 4b", PHASE4B_TIMEOUT_S))
    watchdog.daemon = True
    watchdog.start()
    try:
        features = check_dse_features(kernels)
    finally:
        watchdog.cancel()
    say(f"    phase 4b in {time.perf_counter() - t0:.1f} s; pricing launches "
        f"{features['pricing']}, pricing_f32 launches "
        f"{features['pricing_f32']}")

    # 5.-7. the serving paths
    cfg = get_config("mistral_nemo_12b")
    dense = check_serving(torch, kernels, "mistral_nemo_12b", REQUESTS, {
        "flash_attention": cfg.n_layers,
        "decode_attention": cfg.n_layers * (NEW_TOKENS - 1),
        "rmsnorm": (1 + 2 * cfg.n_layers) * NEW_TOKENS}, phase=5)
    # an SSM layer has no MLP: per pass 1 + L residual norms and L gated
    # norms; the scan runs in prefill only, the decode step is a recurrence
    cfg = get_config("mamba2_130m")
    ssm = check_serving(torch, kernels, "mamba2_130m", SSM_REQUESTS, {
        "ssd": cfg.n_layers,
        "rmsnorm": (1 + 2 * cfg.n_layers) * NEW_TOKENS}, phase=7)
    say(f"    pricing events profiled after the serving profiles: "
        f"{profiler_recheck(torch, kernels)}")
    torch.cuda.empty_cache()

    # 8. the training path
    say("[8] training olmo_1b: full-width gradients against the plain "
        "attention, SMOKE steps against the CPU, then run_train")
    t0 = time.perf_counter()
    say(f"    2-layer olmo_1b, {GRAD_BATCH} x {TRAIN_SEQ}: "
        f"{check_train_grads(torch, kernels)}")
    say(f"    SMOKE, 3 steps, card vs CPU: {check_smoke_training(torch)}")
    train = check_training(torch, kernels)
    say(f"    training phase in {time.perf_counter() - t0:.1f} s")

    # 9. a GQA group-3 serving path: minitron_4b at full width, depth cut
    full = get_config("minitron_4b")
    cfg = dataclasses.replace(full, n_layers=MINITRON_LAYERS)
    say(f"[9] minitron_4b serving, GQA {cfg.n_heads}/{cfg.n_kv_heads} (group "
        f"{cfg.n_heads // cfg.n_kv_heads}), d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}; depth cut from {full.n_layers} to {cfg.n_layers} layers")
    gqa3 = check_serving(torch, kernels, "minitron_4b", REQUESTS, {
        "flash_attention": cfg.n_layers,
        "decode_attention": cfg.n_layers * (NEW_TOKENS - 1)}, phase=9,
        cfg=cfg, short=True)
    child = subprocess.run([sys.executable, __file__, "--capture-failure"],
                           capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        return fail(f"a decode step that cannot be captured did not raise: "
                    f"{child.stdout[-500:]} {child.stderr[-2000:]}")
    say(f"    {child.stdout.strip().splitlines()[-1]}")
    by_path = {"mistral_nemo_12b": dense, "mamba2_130m": ssm, "dse": dse,
               "dse_rank_search_service": features,
               "olmo_1b_train": train, "minitron_4b": gqa3}
    counts = {name: sum(c.get(name, 0) for c in by_path.values())
              for name in dense}

    # 10. result
    fa = "src/repro/kernels/flash_attention"
    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:43",
                "decode_attention": "src/repro/kernels/decode_attention/kernel.py:89",
                "flash_attention": f"{fa}/kernel.py:112",
                "flash_attention_fwd_lse": f"{fa}/backward.py:109",
                "flash_attention_bwd_dkv": f"{fa}/backward.py:252",
                "flash_attention_bwd_dq": f"{fa}/backward.py:283",
                "pricing": "src/repro/kernels/pricing/kernel.py:165",
                "pricing_f32": "src/repro/kernels/pricing/kernel.py:235",
                "ssd": "src/repro/kernels/ssd/kernel.py:86"}
    sources = {"flash_attention_fwd_lse": "flash_attention",
               "flash_attention_bwd_dkv": "flash_attention",
               "flash_attention_bwd_dq": "flash_attention",
               "pricing_f32": "pricing"}
    line = []
    for name, n in numbers.items():
        src = sources.get(name, name)
        line.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/{src}/csrc/{src}.cu",
                     "replaces": replaces[name], "launches": counts[name],
                     "launches_by_path": {p: c[name] for p, c in by_path.items()
                                          if c.get(name)},
                     **n})
    say(f"    total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": line}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--capture-failure"]:
        sys.path.insert(0, str(ROOT / "src"))
        sys.exit(capture_failure_raises())
    sys.exit(main())
