#!/usr/bin/env python3
"""Time variants of the SSD chunk-scan kernel, to see where its time goes.

    python3 tools/ssd_variants.py                         # every variant
    python3 tools/ssd_variants.py as-is two-terms
    python3 tools/ssd_variants.py as-is --source old=path/to/ssd.cu

Needs a CUDA card and nvcc. Each variant is the current ``ssd.cu`` with a
few lines edited (or, with ``--source NAME=PATH``, another whole source,
such as a parent commit's), written to and built in ``build/ssd_variants/``
with ``-Xptxas -v`` (the checkout's source is never touched). Every variant
runs the phase-3 SSD cases of ``chip_smoke.py`` against the plain version
(rtol = atol = 2e-4; a variant that leaves work out is expected outside
that and is labelled so) and is timed like ``chip_smoke.py`` times a kernel
(CUDA-graph replays, L2 flushed) at the mamba2_130m serving shape (8, 2048,
24, 64, 128), strided as the model passes it. One line per variant, then a
JSON summary with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/ssd/csrc/ssd.cu"
OUT = ROOT / "build" / "ssd_variants"

CBT = "          mma_terms<TI, TI>(acc[h2], af, b2);\n"
NEXT = "      if (c + 1 < nc) ld.chunk(a, pl, smem + (st ^ 1) * pl.stage, c0 + Q);\n"
KEEP = "constexpr int KEEP = 2;"
CH = "            mma_terms<3, TI>(yacc[2 * n2 + h2], ah, b2);\n"
GRID = "<<<dim3(a.nh, nb), 32 * pl.warps, pl.total, stream>>>"
YST = "          if (p < a.P && i < rows) yc[i * a.sy.s + p] = yacc[ni][e];"
OUTSIDE = "expected outside 2e-4"

#: name -> (edits as (text, replacement), what it shows). A variant whose
#: description ends in OUTSIDE leaves work out on purpose. A variant may not
#: leave a product's result unused: ptxas then deletes the product too.
VARIANTS = {
    "as-is": ([], "the kernel as committed"),
    "no-cbt": ([(CBT, "")], f"no C B^T products (the masked scores are 0); {OUTSIDE}"),
    "first-chunks-only": ([(NEXT, NEXT.replace("c + 1 < nc", "c + 1 < 2"))],
                          f"loads chunks 0 and 1 only, later chunks reuse them; {OUTSIDE}"),
    "two-terms": ([(KEEP, KEEP.replace("2", "1"))],
                  f"split operands keep two bf16 terms (hi, mid), not three; {OUTSIDE}"),
    "no-state-products": ([(CH, "")],
                          f"no C h products (y without the carried state); {OUTSIDE}"),
    "one-term": ([(KEEP, KEEP.replace("2", "0"))],
                 f"split operands keep their hi term only; {OUTSIDE}"),
    "y-one-row": ([(YST, YST.replace("yc[i * a.sy.s + p]", "yc[p]"))],
                  f"every y store goes to the chunk's first row (same stores, little traffic); {OUTSIDE}"),
    "half-grid": ([(GRID, GRID.replace("dim3(a.nh, nb)", "dim3(a.nh, (nb + 1) / 2)"))],
                  f"only the first half of the sequences (one block per SM); {OUTSIDE}"),
}


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name][0]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(sources: dict[str, str]) -> dict:
    """Build every source in parallel; returns name -> (C function, ptxas)."""
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
    fns = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {n} failed to build:\n{log}")
        f = ctypes.CDLL(str(OUT / f"lib{n}.so")).ssd_chunk_fwd
        f.argtypes = [*[ctypes.c_void_p] * 7, *[ctypes.c_int] * 6,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[n] = (f, chip_smoke.ptxas_report(log, chip_smoke.SSD_ENTRY, chip_smoke.ssd_label))
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd.ops import ssd_chunk

    names, extra, argv = [], {}, sys.argv[1:]
    while argv:
        a = argv.pop(0)
        if a == "--source":
            n, path = argv.pop(0).split("=", 1)
            extra[n] = Path(path).read_text()
        else:
            names.append(a)
    names = names or ([] if extra else list(VARIANTS))
    sources = {n: variant_source(n) for n in names} | extra
    fns = build(sources)
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = chip_smoke.Timer(torch)
    shape = (chip_smoke.SSM_REQUESTS, chip_smoke.PROMPT_LEN, 24, 64, 128)
    cases = chip_smoke.ssd_cases(torch, *shape)
    summary = []
    for n, (f, ptxas) in fns.items():
        # the wrapper looks its C function up in this table first
        _build._bound[("ssd", "ssd_chunk_fwd")] = f
        worst, failed, serve = 0.0, [], None
        for label, args, plain, _ in cases:
            y, st = ssd_chunk(*args)
            yr, sr = plain()
            torch.cuda.synchronize()
            for got, want, what in ((y, yr, "y"), (st, sr, "state")):
                err = (got - want).abs()
                bad = ~torch.isfinite(got) | (err > 2e-4 + 2e-4 * want.abs())
                e = err.max().item()
                worst = max(worst, e if e == e else float("inf"))
                if bool(bad.any()):
                    failed.append(f"{label} {what}")
                if label == "serve" and what == "y":
                    serve = e
        args = cases[0][1]
        y1, s1 = ssd_chunk(*args)
        y2, s2 = ssd_chunk(*args)
        same = bool(torch.equal(y1, y2) and torch.equal(s1, s2))
        ms = timer.ms(lambda: ssd_chunk(*args), 20)
        what = VARIANTS[n][1] if n in VARIANTS else "the source given"
        row = dict(variant=n, ms=ms, serve_max_abs_err_y=serve, max_abs_err=worst,
                   cases_outside_tol=failed, bit_identical=same, ptxas=ptxas, what=what)
        summary.append(row)
        print(f"{n:18s} {ms:.4f} ms  serve y err {serve:.3g}  worst {worst:.3g}  "
              f"outside 2e-4: {failed or 'none'}  bit-identical {same}  {ptxas}  # {what}",
              flush=True)
    _build._bound.pop(("ssd", "ssd_chunk_fwd"), None)
    print(json.dumps({"card": chip_smoke.nvidia_smi("name,power.limit"),
                      "shape": shape, "runs": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
