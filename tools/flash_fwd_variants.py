#!/usr/bin/env python3
"""Time variants of the flash-attention forward kernel, to see where its
time goes.

    python3 tools/flash_fwd_variants.py                  # every variant
    python3 tools/flash_fwd_variants.py as-is no-products

Needs a CUDA card and nvcc. Each variant is the current
``flash_attention.cu`` with a few lines edited, written to and built in
``build/fwd_variants/`` (the checkout's source is never touched). Every
variant's ``flash_attention_fwd`` is timed like ``chip_smoke.py`` times a
kernel (CUDA-graph replays, L2 flushed) at the mistral_nemo_12b prefill
shape (4, 32/8, 2048, 128) causal, the olmo_1b training shape (8, 16,
2048, 128) causal and a long full-attention shape (1, 32/8, 8192, 128),
next to ``scaled_dot_product_attention`` on the same inputs. Variants that
remove work give wrong outputs on purpose; their error against SDPA is
printed beside their time. One line per shape and variant, then a JSON
summary.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
OUT = ROOT / "build" / "fwd_variants"
SHAPES = ((4, 32, 8, 2048, 128, True), (8, 16, 16, 2048, 128, True),
          (1, 32, 8, 8192, 128, False))

QK = "        qk_product<HD, LSE>(s, q_base, k_base + sk * C::KV_BYTES);\n"
PV = "        pv_product<HD, LSE>(oacc, pa, v_base + sv * C::KV_BYTES);\n"
EXP = "        s[i] = ex2_ftz(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));"
LOAD = """  mbar_expect_tx(bar, C::NC * ROWS * C::SW);
#pragma unroll
  for (int c = 0; c < C::NC; ++c)"""
TURNS = ("        turn_sync(my_turn);\n", "        turn_arrive(their_turn);\n",
         "    if (wg == 1) turn_arrive(1);\n", "    if (wg == 0) turn_sync(1);\n",
         "    if (wg == WG - 1) turn_arrive(1);\n")
#: the forward's last sync on the issue ring (its softmax ring's stays)
LAST_TURN = "      turn_sync(1);\n      if (C::SOFTMAX_TURNS)"

#: name -> (edits as (text, replacement), what it shows)
VARIANTS = {
    "as-is": ([], "the kernel as committed"),
    "exp2f": ([(EXP, EXP.replace("ex2_ftz(", "exp2f("))],
              "exp2f (range fixes around MUFU.EX2) in place of ex2.approx.ftz"),
    "no-pingpong": ([(t, "") for t in TURNS] + [(LAST_TURN, "      if (C::SOFTMAX_TURNS)")],
                    "the warpgroups issue their products without taking turns"),
    **{f"l2-group-{mb}mb": ([("(int)(40.0 * (1 << 20) / per_head)",
                              f"(int)({mb}.0 * (1 << 20) / per_head)")],
                            f"heads grouped by {mb} MB of K/V instead of 40 MB")
       for mb in (8, 16, 24, 32)},
    "no-products": ([(QK, ""), (PV, "")],
                    "loads, barriers and softmax only (no wgmma)"),
    "softmax-only": ([(QK, ""), (PV, ""),
                      (LOAD, "  mbar_arrive(bar);\n  if (C::NC == 0)\n"
                             "  for (int c = 0; c < C::NC; ++c)")],
                     "barriers and softmax only (no wgmma, no data loaded)"),
}


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    return text


def build(names) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in names:
        cu = OUT / f"{n}.cu"
        cu.write_text(variant_source(n))
        procs[n] = subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-o", str(OUT / f"lib{n}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {n} failed to build:\n{log}")
        f = ctypes.CDLL(str(OUT / f"lib{n}.so")).flash_attention_fwd
        f.argtypes = [*[ctypes.c_void_p] * 4, *[ctypes.c_int] * 7, ctypes.c_float,
                      ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[n] = f
    return fns


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    names = sys.argv[1:] or list(VARIANTS)
    fns = build(names)
    from repro_torch.kernels.cost import attention_pairs
    timer = chip_smoke.Timer(torch)
    summary = []
    for b, h, hkv, s, hd, causal in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        q, k, v = (torch.randn(b, s, n, hd, generator=g, device="cuda").bfloat16()
                   .transpose(1, 2) for n in (h, hkv, hkv))
        want = chip_smoke.sdpa(F, q, k, v, causal)
        lib_ms = timer.ms(lambda: chip_smoke.sdpa(F, q, k, v, causal), 20)
        flop = 4.0 * b * h * hd * attention_pairs(s, s, causal)
        for n, f in fns.items():
            o = torch.empty(b, s, h, hd, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
            st = (ctypes.c_int64 * 12)(*[x for t in (q, k, v, o) for x in t.stride()[:3]])

            def call():
                err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, hkv,
                        s, s, hd, int(causal), math.log2(math.e) / math.sqrt(hd), st,
                        torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{n}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            err = (o.float() - want.float()).abs().max().item()
            ms = timer.ms(call, 20)
            row = dict(variant=n, shape=[b, h, hkv, s, hd, causal], ms=ms,
                       tflops=flop / ms / 1e9, sdpa_ms=lib_ms, vs_sdpa=ms / lib_ms,
                       max_abs_err_vs_sdpa=err)
            summary.append(row)
            print(f"{n:14s} {(b, h, hkv, s, hd, causal)} {ms:.4f} ms "
                  f"{row['tflops']:.0f} TFLOP/s, {row['vs_sdpa']:.3f} x SDPA "
                  f"({lib_ms:.4f} ms), max|o - SDPA| {err:.3g}  # {VARIANTS[n][1]}",
                  flush=True)
    print(json.dumps({"card": chip_smoke.nvidia_smi("name,power.limit"),
                      "runs": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
