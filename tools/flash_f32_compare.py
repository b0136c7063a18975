#!/usr/bin/env python3
"""Time the float32 flash-attention kernels against other sources of them,
in one call on one card.

    python3 tools/flash_f32_compare.py
    python3 tools/flash_f32_compare.py --source pr28=local/pr28/flash_attention_f32.cu
    python3 tools/flash_f32_compare.py cvt trunc one-chain dq-cw4

Needs a CUDA card and nvcc. Builds, in parallel with ``-Xptxas -v`` into
``build/flash_f32_compare/``, the committed ``flash_attention_f32.cu``
("new"), each ``--source NAME=PATH`` (another whole source with the same C
interface, such as a parent commit's, written out with ``git show
<commit>:src/repro_torch/kernels/flash_attention/csrc/flash_attention_f32.cu``
into a git-ignored directory) and each variant named (the committed source
with a few lines edited; the checkout's source is never touched):

* ``cvt``: TF32 rounding by the ``cvt.rna.tf32.f32`` instruction in place
  of the integer form (the same value: the outputs must be the same bits);
* ``trunc``: hi and lo rounded toward zero (one AND each): a cheaper split
  whose error is 2^-20 |a| where rna's is 2^-22 |a|, not the kernels'
  arithmetic;
* ``one-chain``: O, dK and dV summed in one chain of tensor-core
  accumulations over every key (query) tile, not tile by tile in fresh
  accumulators;
* ``dkv-cw2``, ``dkv-cw8``: dK/dV's fresh accumulators 2 or 8 column blocks
  of 8 at a time, not 4 (registers: ptxas's spills);
* ``dq-cw4``, ``dq-cw8``: dQ's fresh accumulators 4 or 8 column blocks of 8
  at a time, not all of them.

Each build prints the registers and spills of its forward, dK/dV and dQ
instantiations. Each source is held against the plain versions (the
forward with LSE at F32_TOL 2e-5, dK/dV and dQ at F32_BWD_TOL 2e-4, as
``chip_smoke.py`` phase 3; the backward's bits the same across two calls)
at olmo_1b's float32 training shape (4, 16/16, 2048, 128), a GQA-4 shape
at hd 64 and a ragged GQA-3 one at hd 16; the committed source must pass,
the others are reported, with whether their forward and dK/dV outputs are
the committed source's bits (``bits_as_new``; dQ's apart, ``dq_bits_as_new``).
Then every source is timed like ``chip_smoke.py`` times a kernel
(CUDA-graph replays, L2 flushed by a write) in the order given, then again
in reverse, at the paths' shapes: the serving forward at mistral_nemo_12b's
float32 prefill (1, 32/8, 2048, 128), the forward with LSE, dK/dV and dQ at
olmo_1b's, and the four at hd 16 and 32 at the SMOKE configs' (4, 8/2,
2048). One line per reading, then a JSON summary with the card's name and
power limit.
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
SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention_f32.cu"
OUT = ROOT / "build" / "flash_f32_compare"

RNA = "  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;"
ZERO = "      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;"
CHAIN = "      for (int i = 0; i < CW; ++i) mma3(part[i], a[j],"
ADD = "        acc[i0 + i][e] = fmaf(acc[i0 + i][e], alpha[e / 2], part[i][e]);"
CW = "  static constexpr int CW = HD / 8 < 4 ? HD / 8 : 4;"
DQ_CW = "  static constexpr int CW = HD / 8;                // 8-column blocks of dQ a chunk: all"
#: name -> edits of the committed source as (text, replacement)
VARIANTS = {
    "cvt": [(RNA, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));\n'
                  "  return r;")],
    "trunc": [(RNA, "  return __float_as_uint(a) & 0xffffe000u;")],
    "one-chain": [(ZERO, ZERO.replace("= 0.f;", "= 0.f, acc[i0 + i][e] *= alpha[e / 2];")),
                  (CHAIN, CHAIN.replace("part[i]", "acc[i0 + i]")),
                  (ADD, "        (void)part;")],
    "dkv-cw2": [(CW, CW.replace("4 ? HD / 8 : 4", "2 ? HD / 8 : 2"))],
    "dkv-cw8": [(CW, CW.replace("4 ? HD / 8 : 4", "8 ? HD / 8 : 8"))],
    "dq-cw4": [(DQ_CW, DQ_CW.replace("HD / 8;", "HD / 8 < 4 ? HD / 8 : 4;"))],
    "dq-cw8": [(DQ_CW, DQ_CW.replace("HD / 8;", "HD / 8 < 8 ? HD / 8 : 8;"))],
}
#: (label, hd, (B, H, Hkv, S)) held against the plain versions, causal
CHECKS = (("olmo f32", 128, (4, 16, 16, 2048)), ("gqa4", 64, (4, 8, 2, 2048)),
          ("ragged gqa3", 16, (2, 6, 2, 1000)))
#: (hd, serving forward's (B, H, Hkv, S), training kernels' (B, H, Hkv, S))
TIMED = ((128, (1, 32, 8, 2048), (4, 16, 16, 2048)),
         (16, (4, 8, 2, 2048), (4, 8, 2, 2048)),
         (32, (4, 8, 2, 2048), (4, 8, 2, 2048)))


def build(sources: dict[str, str]) -> dict:
    """Build every source in parallel; returns name -> the loaded library,
    after printing its forward, dK/dV and dQ instantiations' registers and
    spills."""
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o", str(OUT / f"lib{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        kernel, spill = None, 0
        for line in log.splitlines():
            m = re.search(r"(flash_(?:fwd|bwd_dkv|bwd_dq)_f32_kernel)ILi(\d+)E(Lb(\d)E)?", line)
            if "Compiling entry" in line:
                kernel = m and f"{m.group(1)}<{m.group(2)}{', lse' if m.group(4) == '1' else ''}>"
            elif kernel and "spill stores" in line:
                spill = sum(map(int, re.findall(r"(\d+) bytes spill", line)))
            elif kernel and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"{name}: {kernel} {regs} registers, {spill} bytes spilled", flush=True)
                kernel = None
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        p, i, f, st = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int64)
        for fn, n_ptr in (("fwd", 4), ("fwd_lse", 5), ("bwd_dkv", 8), ("bwd_dq", 7)):
            c = getattr(lib, f"flash_attention_f32_{fn}")
            c.argtypes = [p] * n_ptr + [i] * 7 + [f, st, p]
            c.restype = ctypes.c_int
        libs[name] = lib
    return libs


class Calls:
    """The four entry points of one library on torch tensors, outputs
    allocated as the wrappers allocate them; a refused launch raises."""

    def __init__(self, torch, lib):
        self.torch, self.lib = torch, lib

    def _run(self, fn, ptrs, q, k, scale, *strided):
        b, h, sq, hd = q.shape
        err = getattr(self.lib, f"flash_attention_f32_{fn}")(
            *[t.data_ptr() for t in ptrs], b, h, k.shape[1], sq, k.shape[2], hd, 1, scale,
            (ctypes.c_int64 * (3 * len(strided)))(*[s for t in strided for s in t.stride()[:3]]),
            self.torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_f32_{fn}: CUDA error {err}")

    def fwd(self, q, k, v, o, lse=None):
        scale = math.log2(math.e) / math.sqrt(q.shape[-1])
        if lse is None:
            self._run("fwd", (q, k, v, o), q, k, scale, q, k, v, o)
        else:
            self._run("fwd_lse", (q, k, v, o, lse), q, k, scale, q, k, v, o)

    def dkv(self, q, k, v, do, lse, dd, dk, dv):
        self._run("bwd_dkv", (q, k, v, do, lse, dd, dk, dv), q, k, 1 / math.sqrt(q.shape[-1]),
                  q, k, v, do, dk, dv)

    def dq(self, q, k, v, do, lse, dd, dq):
        self._run("bwd_dq", (q, k, v, do, lse, dd, dq), q, k, 1 / math.sqrt(q.shape[-1]),
                  q, k, v, do, dq)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.ops import _like_model
    from repro_torch.kernels.flash_attention.ref import (
        attention_delta, flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
        flash_attention_fwd_lse_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    text = SOURCE.read_text()
    sources, order = {"new": text}, []
    args = iter(argv)
    for a in args:
        if a == "--source":
            name, path = next(args).split("=", 1)
            sources[name] = (ROOT / path).read_text()
            order.append(name)
        else:
            edited = text
            for old, new in VARIANTS[a]:
                if old not in edited:
                    raise SystemExit(f"variant {a}: anchor not in the source: {old!r}")
                edited = edited.replace(old, new)
            sources[a] = edited
            order.append(a)
    order = order + ["new"]
    calls = {n: Calls(torch, lib) for n, lib in build(sources).items()}
    g = torch.Generator(device="cuda").manual_seed(28)

    def inp(b, h, s, hd):
        return cs.contract_inputs(torch, g, b, h, s, hd, torch.float32)

    def scaled(got, want, tol):
        torch.cuda.synchronize()
        d = (got - want).abs() / (tol + tol * want.abs())
        return round(d.max().item(), 4)

    summary, failed = {"card": card, "checks": {}, "ms": {}}, []
    for label, hd, (b, h, hkv, s) in CHECKS:
        q, k, v, do = inp(b, h, s, hd), inp(b, hkv, s, hd), inp(b, hkv, s, hd), inp(b, h, s, hd)
        orf, lser = flash_attention_fwd_lse_ref(q, k, v, True)
        dd = attention_delta(orf, do)
        dkr, dvr = flash_attention_bwd_dkv_ref(q, k, v, do, lser, dd, True)
        dqr = flash_attention_bwd_dq_ref(q, k, v, do, lser, dd, True)
        first = None
        for name, c in calls.items():
            o = _like_model(b, h, s, hd, q)
            lse = torch.empty((b, h, s), device="cuda")
            c.fwd(q, k, v, o, lse)
            dk, dv = _like_model(b, hkv, s, hd, k), _like_model(b, hkv, s, hd, k)
            c.dkv(q, k, v, do, lser, dd, dk, dv)
            dk2, dv2 = _like_model(b, hkv, s, hd, k), _like_model(b, hkv, s, hd, k)
            c.dkv(q, k, v, do, lser, dd, dk2, dv2)
            dq, dq2 = _like_model(b, h, s, hd, q), _like_model(b, h, s, hd, q)
            c.dq(q, k, v, do, lser, dd, dq)
            c.dq(q, k, v, do, lser, dd, dq2)
            got = dict(o=scaled(o, orf, 2e-5), lse=scaled(lse, lser, 2e-5),
                       dk=scaled(dk, dkr, 2e-4), dv=scaled(dv, dvr, 2e-4),
                       dq=scaled(dq, dqr, 2e-4),
                       same_bits_twice=bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)
                                            and torch.equal(dq, dq2)))
            if first is None:
                first = (o, lse, dk, dv, dq)
            else:
                got["bits_as_new"] = all(bool(torch.equal(x, y))
                                         for x, y in zip(first[:4], (o, lse, dk, dv)))
                got["dq_bits_as_new"] = bool(torch.equal(first[4], dq))
            ok = (max(got[x] for x in ("o", "lse", "dk", "dv", "dq")) <= 1
                  and got["same_bits_twice"])
            if name == "new" and not ok:
                failed.append(label)
            summary["checks"][f"{name} {label}"] = got
            print(f"check {name} {label} (hd {hd}, {b} x {h}/{hkv} x {s}, max |err| / "
                  f"(tol + tol |plain|), 1 passes): {json.dumps(got)}", flush=True)
        del q, k, v, do, orf, lser, dd, dkr, dvr, dqr
        torch.cuda.empty_cache()

    timer = cs.Timer(torch)
    turns = order + order[::-1]
    for hd, (fb, fh, fhkv, fs), (tb, th, thkv, ts) in TIMED:
        q, k, v = inp(fb, fh, fs, hd), inp(fb, fhkv, fs, hd), inp(fb, fhkv, fs, hd)
        o = _like_model(fb, fh, fs, hd, q)
        runs = {"fwd": (lambda c: lambda: c.fwd(q, k, v, o), (fb, fh, fhkv, fs))}
        tq, tk, tv, tdo = inp(tb, th, ts, hd), inp(tb, thkv, ts, hd), inp(tb, thkv, ts, hd), \
            inp(tb, th, ts, hd)
        to, tlse = _like_model(tb, th, ts, hd, tq), torch.empty((tb, th, ts), device="cuda")
        calls["new"].fwd(tq, tk, tv, to, tlse)
        tdd = attention_delta(to, tdo)
        dk, dv = _like_model(tb, thkv, ts, hd, tk), _like_model(tb, thkv, ts, hd, tk)
        dq = _like_model(tb, th, ts, hd, tq)
        runs["fwd_lse"] = (lambda c: lambda: c.fwd(tq, tk, tv, to, tlse), (tb, th, thkv, ts))
        runs["dkv"] = (lambda c: lambda: c.dkv(tq, tk, tv, tdo, tlse, tdd, dk, dv),
                       (tb, th, thkv, ts))
        runs["dq"] = (lambda c: lambda: c.dq(tq, tk, tv, tdo, tlse, tdd, dq),
                      (tb, th, thkv, ts))
        for kernel, (make, shape) in runs.items():
            ms = [(name, timer.ms(make(calls[name]), 10)) for name in turns]
            key = f"{kernel} hd{hd} {list(shape)}"
            summary["ms"][key] = ms
            print(f"{key}: " + ", ".join(f"{n} {t:.4f}" for n, t in ms), flush=True)
        del q, k, v, o, tq, tk, tv, tdo, to, tlse, tdd, dk, dv, dq
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    if failed:
        print(f"the committed source failed the checks: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
