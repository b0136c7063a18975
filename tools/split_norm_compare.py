#!/usr/bin/env python3
"""Hold and time the split-row gated RMSNorm's four launches (the
statistic and apply launches of its forward and backward) against other
sources of them, in one call on one card.

    python3 tools/split_norm_compare.py
    python3 tools/split_norm_compare.py --source pr29=local/pr29/rmsnorm.cu
    python3 tools/split_norm_compare.py --source pr29=local/pr29/rmsnorm.cu \\
        no-prefetch no-stream stat-per-1 apply-per-4 block-256 no-few-rows decode-vector \\
        decode-scalar decode-per narrow-gate

Needs a CUDA card and nvcc. Builds, in parallel with ``-Xptxas -v`` into
``build/split_norm_compare/``, the committed ``rmsnorm_split.cu`` ("new"),
each ``--source NAME=PATH`` (a whole ``rmsnorm.cu`` with the previous
interface, whose ``rmsnorm_fwd_split`` and ``rmsnorm_bwd_split`` take one
``vec`` for every tensor, as the port had them before they got kernels of
their own; write a parent's out with ``git show
<commit>:src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu`` into a
git-ignored directory) and each variant named (the committed source with a
line edited; the checkout's source is never touched):

* ``no-prefetch``: the apply launches load a row only after the previous
  row's stores (PREFETCH false);
* ``no-stream``: the statistic launches read their rows through the L2 as
  other lines (ld.global.cg), not evicted first (ld.global.cs);
* ``stat-per-1``: one chunk a thread in the forward statistic, not two;
* ``apply-per-4``: four chunks a thread in both bf16 apply launches, not
  two (one warp a row at 768);
* ``block-256``: blocks of 256 threads where a block holds several rows,
  not 128;
* ``no-few-rows``: decode rows take the prefill plan (the narrowest team,
  several rows a block), not one row a block;
* ``decode-vector``, ``decode-scalar``: every decode row on the vector
  path, or every one on the scalar path (an element a thread), not the
  scalar path only where a row has fewer than 256 chunks (Mamba2's);
* ``decode-per``: a decode row's team as narrow as at prefill (PER chunks
  a thread), not as wide as the launch bound allows;
* ``narrow-gate``: the committed build with the gate read an element a
  load (2 bytes) where the other tensors take 16-byte vectors: what the
  gate's own width buys.

Each build prints its instantiations' registers and spills. Every source
is held against the plain versions over ``chip_smoke.py``'s split-row
cases (RMSNORM_SPLIT_SHAPES and RMSNORM_SPLIT_EXTRA, bf16 gates on 2, 4, 8
and 16 bytes) and float32 gates on 4, 8 and 16 bytes: the row sums within
SPLIT_SUM_REL of the terms' magnitudes, the outputs within one bf16 ulp
(apply) and RMSNORM_GATED_ULPS (backward apply) of the plain version's, dw
within 1e-4 of its largest value (float32: 2e-5 and 2e-4 of the largest
value); the committed source must pass and give dw's bits twice, the others
are reported. Each ``--source``'s one-launch norm and backward (row 1,
``rmsnorm_fwd`` / ``rmsnorm_bwd`` in bf16 over phase 3's RMSNorm cases)
are held to the committed ``rmsnorm.cu``'s bits (``row1_bits``: the
split-row kernels left that source, row 1's arithmetic did not change).
Then at the four serving shapes (rank 0's block of
RMSNORM_SPLIT_SHAPES) every source's four launches are timed like
``chip_smoke.py`` times a kernel (CUDA-graph replays, the L2 flushed by a
write before each, and by a read: a clean L2) in the order given, then
again in reverse, beside the bound of ``kernels/cost.py``. A flush by a
write leaves ~50 MB of dirty lines that the launch's reads evict to
device memory, so there a launch moves its bytes and ~50 MB more. At the
decode shapes, whose bytes take nanoseconds, each launch is also timed as
one of DECODE_GRAPH launches captured in one graph (the L2 warm: the
latency a decode step's graph sees, without the flush's noise). One line
per reading, then a JSON summary with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_split.cu"
OUT = ROOT / "build" / "split_norm_compare"

PREFETCH = "constexpr bool PREFETCH = true;"
PER_STAT = "constexpr int PER_STAT = 2;"
PER_APPLY = "constexpr int PER_APPLY = 2;"
BLOCK = "constexpr int BLOCK = 128;"
FEW_ROWS = "constexpr int FEW_ROWS = 128;"
STREAM = "constexpr Cache STAT_LOADS = LD_CS;"
SCALAR_BELOW = "constexpr int DECODE_SCALAR_BELOW = 256;"
WIDEST = "    pl->tpr = round_warp(nvec) < most ? round_warp(nvec) : most;\n"
#: name -> edits of the committed source as (text, replacement)
VARIANTS = {
    "no-prefetch": [(PREFETCH, PREFETCH.replace("true", "false"))],
    "no-stream": [(STREAM, STREAM.replace("LD_CS", "LD_CG"))],
    "stat-per-1": [(PER_STAT, PER_STAT.replace("2", "1"))],
    "apply-per-4": [(PER_APPLY, PER_APPLY.replace("2", "4"))],
    "block-256": [(BLOCK, BLOCK.replace("128", "256"))],
    "no-few-rows": [(FEW_ROWS, FEW_ROWS.replace("128", "0"))],
    "decode-vector": [(SCALAR_BELOW, SCALAR_BELOW.replace("256", "0"))],
    "decode-scalar": [(SCALAR_BELOW, SCALAR_BELOW.replace("256", "4096"))],
    "decode-per": [(WIDEST, "")],
}
#: runs of the committed build with the gate's loads narrowed to an element
NARROW = ("narrow-gate",)
#: float32 gates held besides chip_smoke's bf16 cases: (label, rows, d, dn,
#: ranks, in_proj row width), the gate's rows on 16, 8 and 4 bytes
F32_CASES = (("f32 gate on 16 bytes", 300, 768, 1536, 2, 1804),
             ("f32 gate on 8 bytes", 300, 768, 1536, 2, 1802),
             ("f32 gate on 4 bytes", 37, 768, 1536, 2, 1801))
LAUNCHES = ("stat", "apply", "bwd_stat", "bwd_apply")
#: launches of one graph at a decode shape, and the graph's replays timed
DECODE_GRAPH, DECODE_REPLAYS = 64, 20


def graph_ms(torch, fn) -> float:
    """The time of one launch of ``fn`` among DECODE_GRAPH captured in one
    CUDA graph, over DECODE_REPLAYS replays (CUDA events around each)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(DECODE_GRAPH):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(DECODE_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (DECODE_REPLAYS * DECODE_GRAPH)


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(sources: dict[str, str]) -> dict:
    """Build every source in parallel; returns name -> the loaded library,
    after printing its split-row instantiations' registers and spills."""
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
        kernel, spill, seen = None, 0, []
        for line in log.splitlines():
            m = re.search(r"(split_\w*?kernel|rmsnorm_(?:bwd_)?kernel)I(13__nv_bfloat16|f)"
                          r"Li(\d+)ELi(\d+)E(?:Lb([01])E)?", line)
            if "Compiling entry" in line:
                kernel, spill = (None, 0) if not m or m.group(5) == "0" else (
                    f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}, "
                    f"{m.group(3)}, {m.group(4)}>", 0)
            elif kernel and "spill stores" in line:
                spill = sum(map(int, re.findall(r"(\d+) bytes spill", line)))
            elif kernel and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                smem = re.search(r"(\d+) bytes smem", line)
                seen.append(f"{kernel} {regs} regs, {smem.group(1) if smem else 0} B smem"
                            f"{f', {spill} B spilled' if spill else ''}")
                kernel = None
        print(f"{name}: {'; '.join(sorted(seen))}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


class Launches:
    """The four launches of one library, outputs allocated as the wrappers
    allocate them; a refused launch raises. ``new``: the committed
    interface (the contiguous tensors' vectors and the gate's load apart;
    ``narrow`` reads the gate an element a load); else the previous one
    (one ``vec`` for every tensor)."""

    def __init__(self, torch, lib, new: bool, narrow: bool = False):
        self.torch, self.new, self.narrow = torch, new, narrow
        self.fwd = {dt: getattr(lib, f"rmsnorm_fwd_split{sfx}")
                    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32"))}
        self.bwd = {dt: getattr(lib, f"rmsnorm_bwd_split{sfx}")
                    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32"))}
        extra = [ctypes.c_int] if new else []
        for fn in self.fwd.values():
            fn.argtypes = [*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 3, ctypes.c_longlong,
                           ctypes.c_float, ctypes.c_int, *extra, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in self.bwd.values():
            fn.argtypes = [*[ctypes.c_void_p] * 10, *[ctypes.c_int] * 3, ctypes.c_longlong,
                           ctypes.c_float, ctypes.c_int, *extra, ctypes.c_void_p]
            fn.restype = ctypes.c_int

    def widths(self, y, z, w, dh):
        from repro_torch.kernels import _build
        from repro_torch.kernels.rmsnorm import ops
        if not self.new:
            vec = y.shape[1] % 8 == 0 and w.data_ptr() % 16 == 0 and all(
                _build.rows_aligned(u) for u in (y, z, dh))
            return [int(vec)]
        wd = ops.split_widths(y, z, w, dh)
        return [int(wd["y"] == 16), z.element_size() if self.narrow else wd["gate"]]

    def _run(self, fn, *args):
        err = fn(*args, self.torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"split-row launch: CUDA error {err}")

    def stat(self, y, z, w, dh):
        out = self.torch.empty(y.shape[0], dtype=self.torch.float32, device=y.device)
        self._run(self.fwd[z.dtype], y.data_ptr(), z.data_ptr(), w.data_ptr(), None,
                  out.data_ptr(), None, *y.shape, y.shape[1], z.stride(0), 0.0,
                  *self.widths(y, z, w, dh))
        return out

    def apply(self, y, z, w, dh, stats, dn, eps=1e-6):
        out = self.torch.empty(y.shape, dtype=z.dtype, device=y.device)
        self._run(self.fwd[z.dtype], y.data_ptr(), z.data_ptr(), w.data_ptr(), out.data_ptr(),
                  None, stats.data_ptr(), *y.shape, dn, z.stride(0), eps,
                  *self.widths(y, z, w, dh))
        return out

    def bwd_stat(self, y, z, w, dh):
        out = self.torch.empty(y.shape[0], 2, dtype=self.torch.float32, device=y.device)
        self._run(self.bwd[z.dtype], dh.data_ptr(), y.data_ptr(), z.data_ptr(), w.data_ptr(),
                  None, None, None, None, out.data_ptr(), None, *y.shape, y.shape[1],
                  z.stride(0), 0.0, *self.widths(y, z, w, dh))
        return out

    def bwd_apply(self, y, z, w, dh, stats, dn, eps=1e-6):
        torch = self.torch
        t, d = y.shape
        dx = torch.empty(t, d, dtype=torch.float32, device=y.device)
        dz = torch.empty(t, d, dtype=z.dtype, device=y.device)
        part = torch.empty(min(t, 1024), d, dtype=torch.float32, device=y.device)
        dw = torch.empty(d, dtype=torch.float32, device=y.device)
        self._run(self.bwd[z.dtype], dh.data_ptr(), y.data_ptr(), z.data_ptr(), w.data_ptr(),
                  dx.data_ptr(), dz.data_ptr(), part.data_ptr(), dw.data_ptr(), None,
                  stats.data_ptr(), t, d, dn, z.stride(0), eps, *self.widths(y, z, w, dh))
        return dx, dz, dw


def row1(torch, lib):
    """(forward, backward) of row 1's one-launch norm through ``lib``'s
    bf16 entry points, outputs allocated and ``vec`` chosen as the
    wrappers do; each returns its outputs."""
    from repro_torch.kernels import _build
    fwd, bwd = lib.rmsnorm_fwd, lib.rmsnorm_bwd
    fwd.argtypes = [*[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    bwd.argtypes = [*[ctypes.c_void_p] * 10, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    ptr = lambda u: None if u is None else u.data_ptr()

    def vec(w, *rows):
        return int(w.shape[0] % 8 == 0 and w.data_ptr() % 16 == 0 and all(
            _build.rows_aligned(u) for u in rows if u is not None))

    def forward(x, r, z, w, eps):
        t, d = x.shape
        y = torch.empty(t, d, dtype=torch.bfloat16, device=x.device)
        rout = None if z is not None else torch.empty_like(x)
        err = fwd(ptr(x), ptr(r), ptr(z), ptr(w), ptr(y), ptr(rout), t, d,
                  0 if z is None else z.stride(0), eps, vec(w, x, r, z, y, rout),
                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rmsnorm_fwd: CUDA error {err}")
        return [u for u in (y, rout) if u is not None]

    def backward(dh, dr, x, r, z, w, eps):
        t, d = x.shape
        dx = torch.empty_like(x)
        dz = None if z is None else torch.empty(t, d, dtype=z.dtype, device=x.device)
        part = torch.empty(min(t, 1024), d, dtype=torch.float32, device=x.device)
        dw = torch.empty(d, dtype=torch.float32, device=x.device)
        err = bwd(ptr(dh), ptr(dr), ptr(x), ptr(r), ptr(z), ptr(w), ptr(dx), ptr(dz),
                  ptr(part), ptr(dw), t, d, 0 if z is None else z.stride(0), eps,
                  vec(w, x, r, z, dh, dr, dx, dz), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rmsnorm_bwd: CUDA error {err}")
        return [u for u in (dx, dz, dw) if u is not None]
    return forward, backward


def row1_bits(torch, cs, lib) -> dict:
    """Whether ``lib``'s one-launch norm and backward give the committed
    ``rmsnorm.cu``'s bits over phase 3's RMSNorm cases, by case."""
    from repro_torch.kernels import _build
    mine, theirs = row1(torch, _build.load("rmsnorm")), row1(torch, lib)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    out = {}
    for label, rows, d, kind in cs.RMSNORM_SHAPES + cs.RMSNORM_EXTRA:
        inp = cs.rmsnorm_inputs(torch, g, rows, d, kind)
        args = (inp["x"], inp["r"], inp["z"], inp["w"], cs.RMSNORM_EPS)
        out[f"forward {label} ({rows}, {d})"] = all(
            torch.equal(a, b) for a, b in zip(mine[0](*args), theirs[0](*args)))
    for label, rows, d, kind in cs.RMSNORM_BWD_SHAPES + cs.RMSNORM_BWD_EXTRA:
        inp = cs.rmsnorm_bwd_inputs(torch, g, rows, d, kind)
        args = (inp["dh"], inp["dr"], inp["x"], inp["r"], inp["z"], inp["w"], cs.RMSNORM_EPS)
        out[f"backward {label} ({rows}, {d})"] = all(
            torch.equal(a, b) for a, b in zip(mine[1](*args), theirs[1](*args)))
    return out


def f32_inputs(torch, g, rows, d, dn, ranks, width):
    """chip_smoke.split_inputs with float32 gates and dh."""
    y = torch.randn(rows, dn, generator=g, device="cuda")
    zs = [torch.randn(rows, width, generator=g, device="cuda")[:, :d] for _ in range(ranks)]
    w = torch.rand(dn, generator=g, device="cuda") + 0.5
    dh = torch.randn(rows, dn, generator=g, device="cuda")
    return {"y": y, "zs": zs, "z": torch.cat(zs, 1), "w": w, "dh": dh,
            "blocks": [slice(r * d, (r + 1) * d) for r in range(ranks)]}


def check(torch, cs, run: Launches, inp, dn: int) -> dict:
    """Each launch on every block against its plain version (the limits of
    the module docstring); returns the worst of each, and whether dw gave
    the same bits twice."""
    from repro_torch.kernels.rmsnorm import ref
    f32 = inp["zs"][0].dtype == torch.float32
    errs = dict.fromkeys(LAUNCHES, 0.0) | {"dw": 0.0, "dw_bits_twice": True}
    stats = bstats = 0
    for c in inp["blocks"]:
        y, z, w, dh = cs.split_blocks(inp, c)
        got, want = run.stat(y, z, w, dh), ref.gated_norm_stat_ref(y, z)
        scale = ref.gated_norm_stat_ref(y.abs(), z).clamp_min(1e-30)
        errs["stat"] = max(errs["stat"], float(((got - want).abs() / scale).max()))
        stats = stats + got
        got, want = run.bwd_stat(y, z, w, dh), ref.gated_norm_bwd_stat_ref(dh, y, z, w)
        g_abs = (y.to(z.dtype).float() * torch.nn.functional.silu(z).float()).abs()
        scale = torch.stack([(g_abs * g_abs).sum(-1),
                             (dh.float().abs() * w * g_abs).sum(-1)], -1).clamp_min(1e-30)
        errs["bwd_stat"] = max(errs["bwd_stat"], float(((got - want).abs() / scale).max()))
        bstats = bstats + got
    for c in inp["blocks"]:
        y, z, w, dh = cs.split_blocks(inp, c)
        got = run.apply(y, z, w, dh, stats, dn)
        want = ref.gated_norm_apply_ref(y, z, w, stats, dn)
        got_b = run.bwd_apply(y, z, w, dh, bstats, dn)
        want_b = ref.gated_norm_bwd_apply_ref(dh, y, z, w, bstats, dn)
        if f32:
            rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            errs["apply"] = max(errs["apply"], rel(got, want))
            errs["bwd_apply"] = max(errs["bwd_apply"], *(rel(a, b) for a, b in
                                                         zip(got_b[:2], want_b[:2])))
        else:
            errs["apply"] = max(errs["apply"], cs.bf16_ulps_over(torch, got, want))
            errs["bwd_apply"] = max(errs["bwd_apply"], *(cs.bf16_ulps_over(torch, a, b)
                                                         for a, b in zip(got_b[:2], want_b[:2])))
        errs["dw"] = max(errs["dw"], float((got_b[2] - want_b[2]).abs().max()
                                           / want_b[2].abs().max().clamp_min(1e-30)))
        again = run.bwd_apply(y, z, w, dh, bstats, dn)[2]
        errs["dw_bits_twice"] &= bool(torch.equal(again, got_b[2]))
    return errs


def held(cs, errs: dict, f32: bool) -> bool:
    limits = ({"stat": cs.SPLIT_SUM_REL, "bwd_stat": cs.SPLIT_SUM_REL, "apply": 2e-5,
               "bwd_apply": 2e-4, "dw": 2e-4} if f32 else
              {"stat": cs.SPLIT_SUM_REL, "bwd_stat": cs.SPLIT_SUM_REL, "apply": 1.0,
               "bwd_apply": cs.RMSNORM_GATED_ULPS, "dw": 1e-4})
    return all(errs[k] <= v for k, v in limits.items())


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import cost
    from repro_torch.kernels.rmsnorm import ops

    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    sources, order, old = {"new": SOURCE.read_text()}, [], set()
    args = iter(argv)
    for a in args:
        if a == "--source":
            a, path = next(args).split("=", 1)
            sources[a] = (ROOT / path).read_text()
            old.add(a)
        elif a not in NARROW:
            sources[a] = variant_source(a)
        order.append(a)
    order = order + ["new"]
    libs = build(sources)
    runs = {n: Launches(torch, libs["new" if n in NARROW else n], n not in old, n in NARROW)
            for n in order}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 21)
    ok, checks = True, {}
    cases = [(c, False) for c in cs.RMSNORM_SPLIT_SHAPES + cs.RMSNORM_SPLIT_EXTRA]
    cases += [(c, True) for c in F32_CASES]
    for (label, rows, d, dn, ranks, width), f32 in cases:
        inp = (f32_inputs if f32 else cs.split_inputs)(torch, g, rows, d, dn, ranks, width)
        for name in dict.fromkeys(order):
            errs = check(torch, cs, runs[name], inp, dn)
            good = held(cs, errs, f32) and (errs["dw_bits_twice"] or name in old)
            checks.setdefault(name, {})[label] = errs | {"held": good}
            print(f"check {name} {label} ({rows}, {d} of {dn}, gate stride {width}): "
                  f"{json.dumps(errs)} held {good}", flush=True)
            ok &= good or name != "new"
        del inp
    bits = {n: row1_bits(torch, cs, libs[n]) for n in old}
    for n, by_case in bits.items():
        print(f"row 1 bits, {n} against the committed rmsnorm.cu: "
              f"{'equal' if all(by_case.values()) else 'DIFFER'} {json.dumps(by_case)}",
              flush=True)
    timer = cs.Timer(torch)
    times = {}
    for label, rows, d, dn, ranks, width in cs.RMSNORM_SPLIT_SHAPES:
        inp = cs.split_inputs(torch, g, rows, d, dn, ranks, width)
        y, z, w, dh = cs.split_blocks(inp, inp["blocks"][0])
        st = runs["new"].stat(y, z, w, dh) * ranks
        bst = runs["new"].bwd_stat(y, z, w, dh).contiguous() * ranks
        works = {"stat": cost.rmsnorm(rows, d, "gated_stat"),
                 "apply": cost.rmsnorm(rows, d, "gated_apply"),
                 "bwd_stat": cost.rmsnorm_bwd(rows, d, "gated_stat"),
                 "bwd_apply": cost.rmsnorm_bwd(rows, d, "gated_apply")}
        widths = ops.split_widths(y, z, w, dh)
        entry = times[label] = {
            "shape": [rows, d, dn], "gate_row_stride": width, "load_bytes": widths,
            "bound_ms": {k: v.bound_ms()[0] for k, v in works.items()},
            "plan": {k: ops.plan_split(k, rows, d, widths["y"] == 16, widths["gate"])
                     for k in LAUNCHES}, "ms": {}, "clean_l2_ms": {}, "graph_ms": {}}
        for name in order + order[::-1]:
            r = runs[name]
            fns = {"stat": lambda: r.stat(y, z, w, dh),
                   "apply": lambda: r.apply(y, z, w, dh, st, dn),
                   "bwd_stat": lambda: r.bwd_stat(y, z, w, dh),
                   "bwd_apply": lambda: r.bwd_apply(y, z, w, dh, bst, dn)}
            for k, fn in fns.items():
                ms, clean = timer.ms(fn, 30), timer.ms(fn, 30, clean_l2=True)
                entry["ms"].setdefault(name, {}).setdefault(k, []).append(ms)
                entry["clean_l2_ms"].setdefault(name, {}).setdefault(k, []).append(clean)
                in_graph = ""
                if rows <= 128:
                    gms = graph_ms(torch, fn)
                    entry["graph_ms"].setdefault(name, {}).setdefault(k, []).append(gms)
                    in_graph = f", one of {DECODE_GRAPH} in a graph {gms:.5f} ms"
                print(f"time {label} {name} {k}: {ms:.5f} ms "
                      f"({entry['bound_ms'][k] / ms:.3f} of the bound), clean L2 "
                      f"{clean:.5f} ms ({entry['bound_ms'][k] / clean:.3f}){in_graph}",
                      flush=True)
        for key in ("ms", "clean_l2_ms"):
            entry[key.replace("ms", "share")] = {
                n: {k: entry["bound_ms"][k] / (sum(v) / len(v)) for k, v in m.items()}
                for n, m in entry[key].items()}
        del inp, y, z, w, dh
    print(json.dumps({"card": card, "order": order, "held": ok, "times": times,
                      "checks": checks, "row1_bits_equal": bits}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
