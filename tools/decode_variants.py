#!/usr/bin/env python3
"""Time variants of the decode-attention kernel, to see where its time goes.

    python3 tools/decode_variants.py                         # every variant
    python3 tools/decode_variants.py as-is counter-merge
    python3 tools/decode_variants.py as-is --legacy old=path/to/decode_attention.cu

Needs a CUDA card and nvcc. Each variant is the current
``decode_attention.cu`` with a few lines edited (``--source NAME=PATH``: another
whole source with the same C interface; ``--legacy NAME=PATH``: a source with
the previous two-pass interface, a host-side kv_len, a split pass and a merge
pass),
written to and built in ``build/decode_variants/`` with ``-Xptxas -v`` (the
checkout's source is never touched). Every variant runs the phase-3 decode
cases of ``chip_smoke.py`` (a variant that leaves work out is expected to
fail them and is labelled so) and is timed like ``chip_smoke.py`` times a
kernel (CUDA-graph replays, L2 flushed by a write, and again by a read:
``Timer.ms(clean_l2=True)``) at the mistral_nemo_12b serving shape (4, 32/8
heads, cache 2081, hd 128, kv_len 2079), with SDPA beside it. One
line per variant, then a JSON summary with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
OUT = ROOT / "build" / "decode_variants"

NTILES = "    return split < tiles ? (tiles - split + n_split - 1) / n_split : 0;"
ROWS = "      if (*stuck) break;\n      const int rows = min(TK, kv_len - tile_key(i));"
PV = "      pv_tile<HD, NREP>(acc, pb, kt + G::TILE, rows, lane);\n"
MERGE = "constexpr bool CLUSTER_MERGE = true;"
RING = "constexpr int ST = 4; "
WARPS = "constexpr int NCW = 4; "
CROSS = "    for (int i = lo + threadIdx.x; i < hi; i += THREADS)\n"
SPLIT = "constexpr int MAX_SPLIT = CLUSTER_MERGE ? 8 : 32;"
EARLY = ("      for (; i < ST && tile_key(i) < p.S; ++i) issue(i);\n"
         "      const int ntiles = count_tiles();\n")
OUTSIDE = "expected to fail the checks"

#: name -> (edits as (text, replacement), what it shows). A variant whose
#: description ends in OUTSIDE leaves work out on purpose. A variant may not
#: leave a product's result unused: ptxas then deletes the product too. The
#: ring depth stays a multiple of the consumer warps (the source asserts it).
VARIANTS = {
    "as-is": ([], "the kernel as committed"),
    "merge-alone": ([(NTILES, "    return 0;"), (EARLY, "      const int ntiles = count_tiles();\n")],
                    f"every block's part empty, no early loads: launch, prologue and the "
                    f"merge; {OUTSIDE}"),
    "loads-alone": ([(ROWS, ROWS.replace(
        "break;\n", "break;\n      if (lane == 0) mbar_arrive(empty + s);\n      continue;\n"))],
                    f"the producer streams every tile, the consumers release them "
                    f"unread; {OUTSIDE}"),
    "no-pv": ([(PV, "")], f"Q K^T and the softmax, no P V; {OUTSIDE}"),
    "no-cross-merge": ([(CROSS, CROSS.replace("i < hi", "i < lo"))],
                       f"the cluster barriers without the merge reads and writes; {OUTSIDE}"),
    "no-early-loads": ([(EARLY, "      const int ntiles = count_tiles();\n"
                                "      for (; i < ST && i < ntiles; ++i) issue(i);\n")],
                       "the producer waits for kv_len before its first loads"),
    "counter-merge": ([(MERGE, MERGE.replace("true", "false"))],
                      "the last block of a head group merges (global scratch and counter)"),
    "ring-8": ([(RING, RING.replace("4", "8"))], "8 ring stages, not 4"),
    "ring-12": ([(RING, RING.replace("4", "12"))], "12 ring stages, not 4"),
    "consumers-2": ([(WARPS, WARPS.replace("4", "2"))], "2 consumer warps, not 4"),
    "consumers-2-ring-2": ([(WARPS, WARPS.replace("4", "2")), (RING, RING.replace("4", "2"))],
                           "2 consumer warps and 2 ring stages"),
    "consumers-8-ring-8": ([(WARPS, WARPS.replace("4", "8")), (RING, RING.replace("4", "8"))],
                           "8 consumer warps and 8 ring stages"),
    "split-16": ([(SPLIT, SPLIT.replace("? 8 :", "? 16 :"))],
                 "up to 16 blocks a head group (a non-portable cluster size)"),
    "split-16-ring-8": ([(SPLIT, SPLIT.replace("? 8 :", "? 16 :")),
                         (RING, RING.replace("4", "8"))],
                        "up to 16 blocks a head group and 8 ring stages"),
}


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name][0]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(sources: dict[str, str]) -> dict:
    """Build every source in parallel; returns name -> (library, ptxas)."""
    import chip_smoke
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, text in sources.items():
        cu = OUT / f"{n}.cu"
        cu.write_text(text)
        procs[n] = subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o", str(OUT / f"lib{n}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {n} failed to build:\n{log}")
        libs[n] = (ctypes.CDLL(str(OUT / f"lib{n}.so")),
                   chip_smoke.ptxas_report(log, chip_smoke.DECODE_ENTRY,
                                           chip_smoke.decode_label))
    return libs


def legacy_call(lib):
    """A decode_attention(q, k, v, kv_len) over a two-pass source: kv_len an
    int (read on the host), split pass and merge pass, partials in scratch
    allocated per call as that wrapper did."""
    import torch

    from repro_torch.kernels import _build

    f = lib.decode_attention_fwd
    f.argtypes = [*[ctypes.c_void_p] * 7, *[ctypes.c_int] * 6,
                  ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int

    def call(q, k, v, kv_len):
        b, h, hd = q.shape
        _, hkv, s, _ = k.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
        part_acc = torch.empty(b * h * 64 * hd, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(b * h * 64 * 2, dtype=torch.float32, device=q.device)
        st = (ctypes.c_int64 * 8)(q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3])
        err = f(*(_build.ptr(t) for t in (q, k, v, o, lse, part_acc, part_ml)), b, h, hkv,
                hd, max(0, min(int(kv_len), s)), 64, st, math.log2(math.e) / math.sqrt(hd),
                _build.stream_ptr(q.device))
        _build.check("decode_attention", err)
        return o, lse
    return call


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import _build, cost
    from repro_torch.kernels.decode_attention import ops

    names, extra, legacy, argv = [], {}, set(), sys.argv[1:]
    while argv:
        a = argv.pop(0)
        if a in ("--source", "--legacy"):
            n, path = argv.pop(0).split("=", 1)
            extra[n] = Path(path).read_text()
            if a == "--legacy":
                legacy.add(n)
        else:
            names.append(a)
    names = names or ([] if extra else list(VARIANTS))
    libs = build({n: variant_source(n) for n in names} | extra)
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = chip_smoke.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    cases = [(label, shape, chip_smoke.decode_inputs(torch, g, shape))
             for label, shape in chip_smoke.decode_cases()]
    q, k, v = cases[0][2]
    kv_len = cases[0][1][-1]
    kl = torch.full((1,), kv_len, dtype=torch.int32, device="cuda")
    kc, vc = k[:, :, :kv_len], v[:, :, :kv_len]
    sdpa_ms = timer.ms(lambda: chip_smoke.sdpa(F, q[:, :, None], kc, vc, False), 200)
    sdpa_clean_ms = timer.ms(lambda: chip_smoke.sdpa(F, q[:, :, None], kc, vc, False), 200,
                             clean_l2=True)
    bound_ms, _ = cost.decode_attention(*q.shape[:2], k.shape[1], q.shape[2],
                                        kv_len).bound_ms()
    summary = []
    for n, (lib, ptxas) in libs.items():
        if n in legacy:
            fn = legacy_call(lib)
        else:
            # the wrapper binds its C functions from this library
            _build._libs["decode_attention"] = lib
            _build._bound.clear()
            ops._plans.clear()
            fn = ops.decode_attention
        failed, worst = [], {"o_err": 0.0, "ulp_excess": 0.0, "lse_err": 0.0}
        for label, shape, (cq, ck, cv) in cases:
            readings = {shape[-1]: chip_smoke.decode_check(
                torch, cq, ck, cv, shape[-1], *fn(cq, ck, cv, shape[-1]), label, check=False)}
            if label in chip_smoke.DECODE_REPLAYED and n not in legacy:
                readings |= chip_smoke.decode_replay_check(
                    torch, fn, cq, ck, cv, (0, 1, 17, shape[-1]), label, check=False)
            for L, r in readings.items():
                for key in worst:
                    worst[key] = max(worst[key], r[key])
                if not (r["o_err"] <= r.get("o_lim", 0.0) and r["lse_err"] <= 1e-3
                        and r["ulp_excess"] <= 1.0):
                    failed.append(f"{label} at {L}")
        ms = timer.ms(lambda: fn(q, k, v, kv_len if n in legacy else kl), 200)
        clean_ms = timer.ms(lambda: fn(q, k, v, kv_len if n in legacy else kl), 200,
                            clean_l2=True)
        what = VARIANTS[n][1] if n in VARIANTS else (
            "the previous two-pass interface (host kv_len, split + merge)" if n in legacy else
            "the source given")
        row = dict(variant=n, ms=ms, bound_share=bound_ms / ms, clean_l2_ms=clean_ms, **worst,
                   cases_failed=failed, ptxas=ptxas,
                   plan=None if n in legacy else ops.plan(4, 32, 8, 128), what=what)
        summary.append(row)
        print(f"{n:16s} {ms:.5f} ms ({bound_ms / ms:.1%} of the bound; clean L2 "
              f"{clean_ms:.5f} ms)  o err "
              f"{worst['o_err']:.3g}  ulp excess {worst['ulp_excess']:.3g}  failed: "
              f"{failed or 'none'}  # {what}", flush=True)
    _build._libs.pop("decode_attention", None)
    _build._bound.clear()
    ops._plans.clear()
    print(json.dumps({"card": chip_smoke.nvidia_smi("name,power.limit"),
                      "sdpa_ms": sdpa_ms, "sdpa_clean_l2_ms": sdpa_clean_ms, "bound_ms": bound_ms,
                      "shape": list(cases[0][1]), "runs": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
