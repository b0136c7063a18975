"""Measurement channels of the validation loop (the reference's
``validation/measure.py`` on the port).

Two channels, different trust models:

* **dry-run** — one eager ``decode_step`` of the twin, counted by
  :mod:`.opcount` (FLOPs, bytes, collective link bytes). Deterministic and
  meaningful on the CPU (the plain route) as on the card (the kernels'
  route): this is the channel the gate *requires*.
* **wall-clock** — the twin run for real on a ``ServeEngine`` and its
  steady-state decode steps timed (warmup discarded, per-step sync,
  trimmed mean). Only meaningful where the machine is quiet; the gate
  applies generous declared bands and records exact ratios.

The reference's protocol knobs are keyword arguments here (``repeats``,
``warmup``) with its defaults. Everything runs on the CUDA card unless
``device`` says otherwise.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from ..device import resolve_device, synchronize
from ..models import decode_step, init_cache, init_params
from ..serve.engine import ServeEngine
from .cases import CASE_NAMES, ValidationCase, build_case, predict_case
from .opcount import count_ops
from .report import (DEFAULT_BAND, DEFAULT_BYTES_FACTOR, DEFAULT_WALL_BAND,
                     build_case_report)

DEFAULT_REPEATS = 16
DEFAULT_WARMUP = 2


def _int_in_range(name: str, val: int, lo: int, hi: int) -> int:
    if isinstance(val, bool) or int(val) != val:
        raise ValueError(f"{name} must be an integer, got {val!r}")
    if not (lo <= val <= hi):
        raise ValueError(f"{name} must lie in [{lo}, {hi}], got {val}")
    return int(val)


def validation_repeats(repeats: int = DEFAULT_REPEATS) -> int:
    """Timed steady-state decode steps per case, checked to lie in
    [1, 10000]."""
    return _int_in_range("repeats", repeats, 1, 10_000)


def validation_warmup(warmup: int = DEFAULT_WARMUP) -> int:
    """Discarded decode steps before timing starts, checked to lie in
    [0, 10000]."""
    return _int_in_range("warmup", warmup, 0, 10_000)


def trimmed_mean(xs: list[float], trim: float = 0.2) -> float:
    """Mean of the central (1 − 2·trim) fraction — the repeat protocol's
    noise-robust location estimate (GC pauses and scheduler preemption
    land in the discarded tails)."""
    if not xs:
        raise ValueError("trimmed_mean of an empty sample")
    ordered = sorted(xs)
    k = int(len(ordered) * trim)
    kept = ordered[k:len(ordered) - k] or ordered
    return sum(kept) / len(kept)


# --- dry-run channel ---------------------------------------------------------
def measure_dryrun(case: ValidationCase, device=None, seed: int = 0) -> dict:
    """One decode step of the twin, counted (:func:`.opcount.count_ops`).

    The step runs at the cache's last position (``kv_len - 1``), so its
    attention covers every cache slot, as the analytical case prices it;
    weights are random from ``seed``. A first step, not counted, builds
    the kernels on the card. Per-decode-step quantities; ``route`` says
    whether the kernels or their plain versions ran."""
    device = resolve_device(device)
    twin = case.twin
    cfg = twin.cfg
    params = init_params(cfg, seed=seed, device=device)
    cache = init_cache(cfg, twin.batch, twin.kv_len, device)
    tok = torch.zeros(twin.batch, dtype=torch.int64, device=device)
    pos = torch.full((1,), twin.kv_len - 1, dtype=torch.int64, device=device)
    with torch.no_grad():
        decode_step(cfg, params, cache, tok, pos)
    synchronize(device)
    return count_ops(lambda: decode_step(cfg, params, cache, tok, pos), device)


# --- host calibration --------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HostCalibration:
    """Measured effective rates of the device running the wall-clock
    channel — the roofline constants of the one-chip system. ``flop_rate``
    and ``mem_bw`` follow the reference's protocol (host clock, synced);
    on the card the same calls are also read with CUDA events
    (``event_*``), printed beside them, never substituted."""

    flop_rate: float             # effective bf16 matmul FLOP/s
    mem_bw: float                # effective stream bandwidth, bytes/s
    event_flop_rate: float | None = None
    event_mem_bw: float | None = None


_CALIBRATION: dict[torch.device, HostCalibration] = {}


def _best_of(fn, device, n: int = 5) -> tuple[float, float | None]:
    """(best host-clock seconds, best CUDA-event seconds or None) of
    ``fn()`` over ``n`` synced calls after one warm-up call."""
    card = device.type == "cuda"
    fn()
    synchronize(device)
    host, events = math.inf, math.inf
    for _ in range(n):
        if card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
        t0 = time.perf_counter()
        fn()
        if card:
            end.record()
        synchronize(device)
        host = min(host, time.perf_counter() - t0)
        if card:
            events = min(events, start.elapsed_time(end) / 1e3)
    return host, (events if card else None)


def calibrate_host(force: bool = False, device=None) -> HostCalibration:
    """Measure the device's effective matmul FLOP/s (a bf16 2048³ product)
    and stream bandwidth (a 256 MB f32 scale, read + write), best of 5,
    synced, on the host clock. Cached per device and process."""
    device = resolve_device(device)
    if device in _CALIBRATION and not force:
        return _CALIBRATION[device]
    n = 2048
    a = torch.ones((n, n), dtype=torch.bfloat16, device=device)
    b = torch.ones((n, n), dtype=torch.bfloat16, device=device)
    mm_host, mm_events = _best_of(lambda: a @ b, device)
    big = torch.ones(64 * 1024 * 1024, dtype=torch.float32, device=device)
    st_host, st_events = _best_of(lambda: big * 1.000001, device)
    nbytes = 2.0 * big.numel() * big.element_size()       # read + write
    flop = 2.0 * n ** 3
    cal = HostCalibration(
        flop_rate=flop / mm_host, mem_bw=nbytes / st_host,
        event_flop_rate=None if mm_events is None else flop / mm_events,
        event_mem_bw=None if st_events is None else nbytes / st_events)
    _CALIBRATION[device] = cal
    return cal


# --- wall-clock channel ------------------------------------------------------
def measure_wallclock(case: ValidationCase, repeats: int = DEFAULT_REPEATS,
                      warmup: int = DEFAULT_WARMUP, seed: int = 0,
                      device=None) -> dict:
    """Run the twin on a ``ServeEngine`` and time steady-state decode.

    Protocol: prefill once, discard ``warmup`` decode steps, then time
    ``repeats`` individually-synced steps; TPOT is the 20 %-trimmed mean.
    The engine's cache is ``kv_len`` slots. The reference's attention runs
    over every cache slot at every step; the port's decode kernel reads
    only the ``pos + 1`` valid ones, so the prompt fills the cache up to
    the measurement window and the timed steps attend over about
    ``kv_len`` keys, as the analytical case prices them. The window guard
    is the reference's: the twin's measurement prompt (``prompt_len``)
    plus the steps must fit the cache."""
    repeats = validation_repeats(repeats)
    warmup = validation_warmup(warmup)
    device = resolve_device(device)
    twin = case.twin
    window = twin.prompt_len + warmup + repeats + 1
    if window > twin.kv_len:
        raise ValueError(
            f"case {case.name!r}: measurement window {window} exceeds the "
            f"twin's kv_len {twin.kv_len}; lower repeats/warmup")
    prompt_len = twin.kv_len - (warmup + repeats + 1)
    params = init_params(twin.cfg, seed=seed, device=device)
    engine = ServeEngine(twin.cfg, params, max_batch=twin.batch,
                         max_len=twin.kv_len, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    prompts = torch.randint(0, twin.cfg.vocab, (twin.batch, prompt_len),
                            generator=gen, device=device)
    timing = engine.decode_steady(prompts, n_steps=repeats, warmup=warmup)
    tpot = trimmed_mean(timing.step_times)
    return {
        "tpot": tpot,
        "tpot_mean": timing.tpot,
        "ttft": timing.ttft,
        "tokens_per_s": twin.batch / tpot,
        "repeats": repeats,
        "warmup": warmup,
        "prompt_len": prompt_len,
        "step_time_min": min(timing.step_times),
        "step_time_max": max(timing.step_times),
    }


# --- every case --------------------------------------------------------------
def card_refusal(case: ValidationCase) -> str | None:
    """Why the card's kernels do not take the twin's decode step (None if
    they do): the SSD kernel's P, N. (The attention kernels take every
    head dim and group of the repo's configs.) The kernels raise on such a
    shape rather than fall back."""
    from ..kernels.ssd.ops import MAX_N, MAX_P

    cfg = case.twin.cfg
    if cfg.attention_free and (cfg.ssm_head_dim > MAX_P or cfg.ssm_state > MAX_N):
        return f"the SSD kernel takes P, N <= {MAX_P}"
    return None


def measure_cases(device=None, repeats: int = DEFAULT_REPEATS,
                  warmup: int = DEFAULT_WARMUP, log=print) -> dict:
    """Measure every case on ``device`` (default the card) and assemble
    the report: calibration, then per case its certified twin, the
    prediction at the calibrated rates, the dry run and the wall clock.
    On the card a case whose shape the kernels do not take
    (:func:`card_refusal`) gets its dry run on the plain route (the CPU)
    and no wall clock, its row saying why in ``wallclock_absent``."""
    device = resolve_device(device)
    cal = calibrate_host(device=device)
    calibration = {"flop_rate": cal.flop_rate, "mem_bw": cal.mem_bw}
    log(f"  calibration ({device.type}): {cal.flop_rate / 1e12:.4g} TFLOP/s "
        f"bf16 matmul, {cal.mem_bw / 1e9:.6g} GB/s stream (host clock)"
        + ("" if cal.event_flop_rate is None else
           f"; CUDA events {cal.event_flop_rate / 1e12:.4g} TFLOP/s, "
           f"{cal.event_mem_bw / 1e9:.6g} GB/s"))
    rows = []
    for name in CASE_NAMES:
        case = build_case(name)          # certifies the twin
        predicted = predict_case(case, cal.flop_rate, cal.mem_bw)
        refusal = card_refusal(case) if device.type == "cuda" else None
        dry = measure_dryrun(case, device="cpu" if refusal else device)
        wall = None if refusal else measure_wallclock(
            case, repeats=repeats, warmup=warmup, device=device)
        row = build_case_report(name, predicted, dry, wall, calibration,
                                case.twin.wall_gate)
        if refusal:
            row["wallclock_absent"] = refusal
        rows.append(row)
    return {"bands": {"band": DEFAULT_BAND, "bytes_factor": DEFAULT_BYTES_FACTOR,
                      "wall_band": DEFAULT_WALL_BAND},
            "calibration": calibration | {
                "event_flop_rate": cal.event_flop_rate,
                "event_mem_bw": cal.event_mem_bw},
            "cases": rows}
