#!/usr/bin/env python3
"""Time variants of the flash-attention backward kernels (dK/dV and dQ)
side by side, to see which design choices pay on the card.

    python3 tools/flash_bwd_variants.py                  # every variant
    python3 tools/flash_bwd_variants.py as-is pingpong-dq

Needs a CUDA card and nvcc. Each variant is the current
``flash_attention.cu`` with a few lines edited, written to and built in
``build/bwd_variants/`` (the checkout's source is never touched; the
copies build in parallel, each with ``-Xptxas -v``, and the bytes ptxas
spills in the backward kernels are reported). Every variant's
``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq`` run at the
olmo_1b training shape (8, 16, 2048, 128), causal, on the inputs
``chip_smoke.py`` uses, and each output is held row by row against the
plain versions (the worst row's error over that row's largest plain
value, as ``chip_smoke.py`` checks it). Each kernel is timed as
``chip_smoke.py`` times one (CUDA-graph replays, L2 flushed), in two
rounds: every variant in order, then in reverse order. SDPA's backward
on the same inputs is timed once for scale. Prints one line per variant
and round, then a JSON summary.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
OUT = ROOT / "build" / "bwd_variants"

# ---- anchors: text that occurs exactly once in flash_attention.cu
# (tests/test_torch_planted_faults.py holds them to that)
DKV_ST = "static constexpr int ST = HD == 128 ? 3 : 4;  // ring stages (Q, dO and row statistics)"
DQ_ST = "static constexpr int ST = 4;    // ring stages (K and V tile pairs)"
DKV_SDP = """      wgmma_fence();
      kmajor_product<HD, BQ>(s, k_base, C::KV_CHUNK, qt, C::Q_CHUNK);
      kmajor_product<HD, BQ>(dp, v_base, C::KV_CHUNK, dot, C::Q_CHUNK);
      wgmma_commit();
      turn_arrive(their_turn);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
"""
DKV_ELEM = """          s[x] = pv;
          dp[x] = pv * (dp[x] - ((e & 1) ? d2.y : d2.x));
        }
      }
      pack_a<BQ>(pa, s);
      pack_a<BQ>(da, dp);
      // dV += P^T dO, dK += dS^T Q (the k dimension is the query)
      turn_sync(my_turn);
      wgmma_fence();
      mn_product<HD, BQ>(dva, pa, dot, C::Q_CHUNK);
      mn_product<HD, BQ>(dka, da, qt, C::Q_CHUNK);
      wgmma_commit();
"""
# dS^T from P^T (in s) and dP^T, once dP^T's product is done
_DS = """      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(Dc + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
"""
SDP_SPLIT = (DKV_SDP, """      wgmma_fence();
      kmajor_product<HD, BQ>(s, k_base, C::KV_CHUNK, qt, C::Q_CHUNK);
      wgmma_commit();
      kmajor_product<HD, BQ>(dp, v_base, C::KV_CHUNK, dot, C::Q_CHUNK);
      wgmma_commit();
      turn_arrive(their_turn);
      wgmma_wait<1>();
      fence_regs(s);
""")

# ping-pong: the two consumer warpgroups take turns to issue their products
# (named barriers 1 and 2), as many turns each; dK/dV has it, dQ not (the
# edits below, applied to dK/dV's code without it, give the committed code)
_TURN_VARS = "    const int my_turn = 1 + wg, their_turn = 2 - wg;\n    if (wg == 1) turn_arrive(1);\n"
PINGPONG_DQ = [
    ("    mbar_wait(full_q, 0, stuck);\n", "    mbar_wait(full_q, 0, stuck);\n" + _TURN_VARS),
    ("      mbar_wait(full, 0, stuck);\n      wgmma_fence();\n",
     "      mbar_wait(full, 0, stuck);\n      __syncwarp();\n      turn_sync(my_turn);\n"
     "      wgmma_fence();\n"),
    ("      kmajor_product<HD, BN>(dp, do_base, C::Q_CHUNK, kv_base + C::KV_BYTES, C::KV_CHUNK);\n"
     "      wgmma_commit();\n",
     "      kmajor_product<HD, BN>(dp, do_base, C::Q_CHUNK, kv_base + C::KV_BYTES, C::KV_CHUNK);\n"
     "      wgmma_commit();\n      turn_arrive(their_turn);\n"),
    ("      mbar_wait(full + st, (j / ST) & 1, stuck);\n      wgmma_fence();\n",
     "      mbar_wait(full + st, (j / ST) & 1, stuck);\n      __syncwarp();\n"
     "      turn_sync(my_turn);\n      wgmma_fence();\n"),
    ("      wgmma_commit();\n      wgmma_wait<1>();  // S_j and dP_j are done\n",
     "      wgmma_commit();\n      turn_arrive(their_turn);\n"
     "      wgmma_wait<1>();  // S_j and dP_j are done\n"),
    ("      wgmma_fence();\n      mn_product<HD, BN>(dqa, da, kv_base + ls * 2 * C::KV_BYTES, "
     "C::KV_CHUNK);\n      wgmma_commit();\n",
     "      __syncwarp();\n      turn_sync(my_turn);\n      wgmma_fence();\n"
     "      mn_product<HD, BN>(dqa, da, kv_base + ls * 2 * C::KV_BYTES, C::KV_CHUNK);\n"
     "      wgmma_commit();\n      turn_arrive(their_turn);\n"),
    ("    const float mul = *stuck ? NAN : scale;",
     "    if (wg == 0) turn_sync(1);\n    const float mul = *stuck ? NAN : scale;"),
]
PINGPONG_DKV = [
    ("    mbar_wait(full_kv, 0, stuck);\n", "    mbar_wait(full_kv, 0, stuck);\n" + _TURN_VARS),
    ("      mbar_wait(full + st, (i / ST) & 1, stuck);\n",
     "      mbar_wait(full + st, (i / ST) & 1, stuck);\n      __syncwarp();\n"
     "      turn_sync(my_turn);\n"),
    ("      kmajor_product<HD, BQ>(dp, v_base, C::KV_CHUNK, dot, C::Q_CHUNK);\n"
     "      wgmma_commit();\n",
     "      kmajor_product<HD, BQ>(dp, v_base, C::KV_CHUNK, dot, C::Q_CHUNK);\n"
     "      wgmma_commit();\n      turn_arrive(their_turn);\n"),
    ("      // dV += P^T dO, dK += dS^T Q (the k dimension is the query)\n      wgmma_fence();\n",
     "      // dV += P^T dO, dK += dS^T Q (the k dimension is the query)\n"
     "      turn_sync(my_turn);\n      wgmma_fence();\n"),
    ("      wgmma_commit();\n      wgmma_wait<0>();\n      fence_regs(dva);\n",
     "      wgmma_commit();\n      turn_arrive(their_turn);\n      wgmma_wait<0>();\n"
     "      fence_regs(dva);\n"),
    ("      if (lane == 0) mbar_arrive(empty + st);\n    }\n    const bool bad = *stuck != 0;",
     "      if (lane == 0) mbar_arrive(empty + st);\n    }\n    if (wg == 0) turn_sync(1);\n"
     "    const bool bad = *stuck != 0;"),
]

#: name -> (edits as (text, replacement), what it tries)
VARIANTS = {
    "as-is": ([], "the kernels as committed"),
    "p-under-dp": ([SDP_SPLIT, (DKV_ELEM, DKV_ELEM.replace(
        "          dp[x] = pv * (dp[x] - ((e & 1) ? d2.y : d2.x));\n", "").replace(
        "      }\n      pack_a<BQ>(pa, s);\n", "      }\n" + _DS + "      pack_a<BQ>(pa, s);\n"))],
                   "dK/dV: S^T and dP^T in two commit groups, P^T computed while dP^T's product runs"),
    "dv-before-ds": ([SDP_SPLIT, (DKV_ELEM, """          s[x] = pv;
        }
      }
      pack_a<BQ>(pa, s);
      turn_sync(my_turn);
      wgmma_fence();
      mn_product<HD, BQ>(dva, pa, dot, C::Q_CHUNK);
      wgmma_commit();
""" + _DS.replace("wgmma_wait<0>();", "wgmma_wait<1>();") + """      pack_a<BQ>(da, dp);
      wgmma_fence();
      mn_product<HD, BQ>(dka, da, qt, C::Q_CHUNK);
      wgmma_commit();
""")], "dK/dV: also dV += P^T dO in flight while dS^T is computed"),
    "pingpong-dq": (PINGPONG_DQ, "dQ: the two warpgroups take turns to issue their products"),
    "no-pingpong-dkv": ([(new, old) for old, new in PINGPONG_DKV],
                        "dK/dV: the two warpgroups issue their products without taking turns"),
    "dkv-2-stages": ([(DKV_ST, "static constexpr int ST = 2;")],
                     "dK/dV: two Q/dO ring stages instead of three (hd 128)"),
    "dq-3-stages": ([(DQ_ST, "static constexpr int ST = 3;")],
                    "dQ: three K/V ring stages instead of four"),
}


def variant_source(name: str, text: str | None = None) -> str:
    """The source of variant ``name``: each edit's text must occur once."""
    text = SOURCE.read_text() if text is None else text
    for old, new in VARIANTS[name][0]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old[:60]!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(names) -> tuple[dict, dict]:
    """Build every variant in parallel; (its two entry points, the bytes
    ptxas spilled in its backward kernels)."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in names:
        cu = OUT / f"{n}.cu"
        cu.write_text(variant_source(n))
        procs[n] = subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o", str(OUT / f"lib{n}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, spills = {}, {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {n} failed to build:\n{log}")
        spills[n], kernel = 0, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = "flash_bwd_" in line
            elif kernel and "spill stores" in line:
                spills[n] += sum(map(int, re.findall(r"(\d+) bytes spill", line)))
        lib = ctypes.CDLL(str(OUT / f"lib{n}.so"))
        dkv, dq = lib.flash_attention_bwd_dkv, lib.flash_attention_bwd_dq
        dkv.argtypes = [*[ctypes.c_void_p] * 8, *[ctypes.c_int] * 7, ctypes.c_float,
                        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
        dq.argtypes = [*[ctypes.c_void_p] * 7, *[ctypes.c_int] * 7, ctypes.c_float,
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
        dkv.restype = dq.restype = ctypes.c_int
        fns[n] = (dkv, dq)
    return fns, spills


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels.flash_attention.ref import (
        attention_delta, flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
        flash_attention_fwd_lse_ref)

    names = sys.argv[1:] or list(VARIANTS)
    fns, spills = build(names)
    shape = chip_smoke.TRAIN_CASES[0][1]
    b, h, hkv, sq, sk, hd, causal = shape
    q, k, v, do = chip_smoke.training_inputs(torch, shape)
    o, lse = flash_attention_fwd_lse_ref(q, k, v, causal)
    dd = attention_delta(o, do)
    want = (*flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd, causal),
            flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, causal))
    del o
    outs = [torch.empty(b, s, n, hd, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
            for s, n in ((sk, hkv), (sk, hkv), (sq, h))]
    dk, dv, dq = outs
    st_kv = (ctypes.c_int64 * 18)(*[x for t in (q, k, v, do, dk, dv) for x in t.stride()[:3]])
    st_q = (ctypes.c_int64 * 15)(*[x for t in (q, k, v, do, dq) for x in t.stride()[:3]])
    ptr = [t.data_ptr() for t in (q, k, v, do, lse, dd)]

    def calls(n):
        f_kv, f_q = fns[n]

        def dkv():
            err = f_kv(*ptr, dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, sk, hd, int(causal),
                       1.0 / math.sqrt(hd), st_kv, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{n}: dK/dV CUDA error {err}")

        def dqf():
            err = f_q(*ptr, dq.data_ptr(), b, h, hkv, sq, sk, hd, int(causal),
                      1.0 / math.sqrt(hd), st_q, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{n}: dQ CUDA error {err}")
        return dkv, dqf

    timer = chip_smoke.Timer(torch)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa_fwd_bwd():
        for t in leaves:
            t.grad = None
        chip_smoke.sdpa(F, *leaves, causal=True).backward(do)
    sdpa_bwd = (timer.eager_ms(sdpa_fwd_bwd, 20)
                - timer.ms(lambda: chip_smoke.sdpa(F, q, k, v, True), 20))
    del leaves
    runs = []
    for rnd, order in enumerate((names, names[::-1])):
        for n in order:
            dkv, dqf = calls(n)
            dkv()
            dqf()
            torch.cuda.synchronize()
            rows = {x: chip_smoke.row_scaled_errs(got, w)[1]
                    for x, got, w in zip(("dk", "dv", "dq"), outs, want)}
            row = dict(variant=n, round=rnd, dkv_ms=timer.ms(dkv, 20),
                       dq_ms=timer.ms(dqf, 20), sdpa_bwd_ms=sdpa_bwd,
                       spill_bytes=spills[n],
                       worst_row_err={x: round(r, 5) for x, r in rows.items()})
            row["pair_vs_sdpa"] = (row["dkv_ms"] + row["dq_ms"]) / sdpa_bwd
            runs.append(row)
            print(f"{n:17s} round {rnd}: dK/dV {row['dkv_ms']:.4f} ms, dQ "
                  f"{row['dq_ms']:.4f} ms, pair {row['pair_vs_sdpa']:.3f} x SDPA's "
                  f"backward ({sdpa_bwd:.4f} ms); spilled {spills[n]} B; worst rows "
                  f"{row['worst_row_err']}  # {VARIANTS[n][1]}", flush=True)
    print(json.dumps({"card": chip_smoke.nvidia_smi("name,power.limit"),
                      "shape": list(shape), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
