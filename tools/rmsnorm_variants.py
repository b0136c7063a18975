#!/usr/bin/env python3
"""Time variants of the fused RMSNorm kernel (row 1), to see where its time
goes and to set its launch configuration.

    python3 tools/rmsnorm_variants.py                        # every variant
    python3 tools/rmsnorm_variants.py --source old=path/to/rmsnorm.cu as-is \
        --source new=src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu --source old2=path/to/rmsnorm.cu
    python3 tools/rmsnorm_variants.py as-is pdl --steady as-is,pdl

Needs a CUDA card and nvcc. Each variant is the current ``rmsnorm.cu`` with
a few lines edited (``--source NAME=PATH``: another whole source; one
without the gate's interface, such as the parent's, runs the norm through
its two-pointer interface and the gated norm as the four-kernel chain the
model used with it), written to and built in ``build/rmsnorm_variants/``
with ``-Xptxas -v`` (the checkout's source is never touched). Every variant
runs ``chip_smoke.py``'s phase-3 RMSNorm cases and race check (a variant
that leaves work out is expected to fail them and is labelled so) and is
timed at the six shapes of ``chip_smoke.RMSNORM_SHAPES`` as
``chip_smoke.rmsnorm_times`` times the kernel (decode shapes: a graph of 81
launches on their own buffers, the L2 flushed by a read, per launch;
prefill shapes: one launch, flushed by a read and by a write), beside the
empty-kernel floor and the library yardstick, measured once. When both
``few-only`` and ``many-only`` run, a row sweep times the two designs from
4 to 4096 rows at d 5120 (residual) and 1536 (gated): the switch FEW_ROWS.
``--steady A,B,...`` also serves mistral_nemo_12b and mamba2_130m (4 and 8
x 2048 prompt tokens, random weights from the seed) and times 16 steady
decode steps through the engine's CUDA graph once for each of the variants
named, in the order given and again in reverse. One line per variant, then a JSON summary with the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
OUT = ROOT / "build" / "rmsnorm_variants"

FEW = "constexpr int FEW_ROWS = 128; "
THREADS = "constexpr int MANY_THREADS = 256; "
PREFETCH = "constexpr bool PREFETCH = true; "
W_LOAD = "      load_f32<VW, true>(p.w + (int64_t)v * VW, wv[k]);\n"
WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
SCALE = "        for (int j = 0; j < VW; ++j) o[j] = s[k][j] * inv * wv[k][j];\n"
BARRIER = "    __syncthreads();\n"
PARTIALS = "    for (int u = 0; u < nw; ++u) tot += red[buf][u];\n"
LOAD_X = "    *reinterpret_cast<uint4*>(dst) = __ldcg(reinterpret_cast<const uint4*>(src));\n"
STORE = "    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);\n"
WAVE = "    pl.grid = p->rows < wave ? p->rows : wave;\n"
LAUNCH = "  kernel<<<pl.grid, pl.threads, 0, stream>>>(*p);\n"
OUTSIDE = "expected to fail the checks"


def launch_ex(attrs: str) -> str:
    """The kernel's launch line as cudaLaunchKernelEx with the launch
    attributes that the C++ in ``attrs`` adds to ``attr[n++]``."""
    return ("  cudaLaunchAttribute attr[2];\n  int n = 0;\n" + attrs +
            "  cudaLaunchConfig_t cfg = {dim3(pl.grid), dim3(pl.threads), 0, stream, attr,\n"
            "                            (unsigned)n};\n"
            "  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, *p);\n"
            "  if (err != cudaSuccess) return err;\n")


#: the edit that launches the kernel as a programmatic dependent
#: (tools/rmsnorm_planted_faults.py plants it too)
PDL_ON = (LAUNCH, launch_ex(
    "  attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
    "  attr[n++].val.programmaticStreamSerializationAllowed = 1;\n"))


def cluster_edits(most: int, min_vecs: int) -> list[tuple[str, str]]:
    """The decode design with a row spread over a thread-block cluster of up
    to ``most`` blocks (powers of two, at least ``min_vecs`` 16-byte vectors
    a block), the warps' partials read through distributed shared memory."""
    cg = "cooperative_groups"
    return [
        ("#include <cuda_bf16.h>\n", "#include <cooperative_groups.h>\n#include <cuda_bf16.h>\n"),
        ("  const int first = tid;\n",
         f"  const {cg}::cluster_group cluster = {cg}::this_cluster();\n"
         "  const int cl = (int)cluster.num_blocks();\n"
         "  const int first = (int)cluster.block_rank() * PER * T + tid;\n"),
        ("  const int step = gridDim.x;\n", "  const int step = gridDim.x / cl;\n"),
        ("  int buf = 0, row = blockIdx.x;\n", "  int buf = 0, row = blockIdx.x / cl;\n"),
        (BARRIER, "    if (cl == 1) {\n      __syncthreads();\n    } else {\n      cluster.sync();\n    }\n"),
        (PARTIALS, "    for (int c = 0; c < cl; ++c) {\n"
                   "      const float* part = cl == 1 ? red[buf] : cluster.map_shared_rank(red[buf], c);\n"
                   "      for (int u = 0; u < nw; ++u) tot += part[u];\n    }\n"),
        ("  }\n}\n\n// The launch geometry of one call.\n",
         "  }\n  if (cl > 1) cluster.sync();  // a block's partials outlive its peers' reads\n}\n\n"
         "// The launch geometry of one call.\n"),
        ("  int grid, threads, per, vw;\n", "  int grid, threads, per, vw, cluster = 1;\n"),
        ("    ok = pick(&pl, nvec, 1024, false, gated);\n    pl.grid = p.rows;\n",
         f"    while (vec && pl.cluster * 2 <= {most} && nvec / (pl.cluster * 2) >= {min_vecs})\n"
         "      pl.cluster *= 2;\n"
         "    ok = pick(&pl, ceil_div(nvec, pl.cluster), 1024, false, gated);\n"
         "    pl.grid = p.rows * pl.cluster;\n"),
        (LAUNCH, launch_ex(
            "  if (pl.cluster > 1) {\n"
            "    attr[n].id = cudaLaunchAttributeClusterDimension;\n"
            "    attr[n].val.clusterDim.x = pl.cluster;\n"
            "    attr[n].val.clusterDim.y = 1;\n"
            "    attr[n++].val.clusterDim.z = 1;\n  }\n")),
    ]


#: name -> (edits as (text, replacement), what it shows). A variant whose
#: description ends in OUTSIDE leaves work out on purpose.
VARIANTS = {
    "as-is": ([], "the kernel as committed"),
    "cluster-2": (cluster_edits(2, 128), "a row over a cluster of up to 2 blocks at decode shapes"),
    "cluster-4": (cluster_edits(4, 128), "a row over a cluster of up to 4 blocks at decode shapes"),
    "cluster-8": (cluster_edits(8, 64),
                  "a row over a cluster of up to 8 blocks, 64 vectors a block at least"),
    "cluster-narrow": (cluster_edits(4, 32),
                       "clusters of up to 4 for the mamba2 widths too (32 vectors a block)"),
    "no-prefetch": ([(PREFETCH, PREFETCH.replace("true", "false"))],
                    "a block loads its next row only after writing this one"),
    "pdl": ([PDL_ON], "launched as a programmatic dependent"),
    "w-after-wait": ([(W_LOAD, ""), (WAIT, WAIT + W_LOAD.replace("      load_f32", "    for (int k = 0; k < PER; ++k) {\n      const int v = first + k * T;\n      if (v < nvec) load_f32") + "    }\n")],
                     "w loaded after the dependency wait, beside x and r"),
    "w-late": ([(W_LOAD, ""), (SCALE, SCALE.replace("wv[k][j]", "__ldg(p.w + (int64_t)v * VW + j)"))],
               "w read element by element after the reduction, as the previous kernel did"),
    "loads-alone": ([(BARRIER, ""), (PARTIALS, "")],
                    f"loads and stores with no cross-warp reduction; {OUTSIDE}"),
    "threads-128": ([(THREADS, THREADS.replace("256", "128"))],
                    "prefill blocks of at most 128 threads (more vectors a thread)"),
    "threads-512": ([(THREADS, THREADS.replace("256", "512"))],
                    "prefill blocks of at most 512 threads (fewer vectors a thread)"),
    "streaming": ([(LOAD_X, LOAD_X.replace("__ldcg", "__ldcs")),
                   (STORE, "    __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(o));\n")],
                  "x, r and z loaded and y stored with the evict-first (streaming) hint"),
    "two-waves": ([(WAVE, WAVE.replace("p->rows < wave ? p->rows : wave", "p->rows < 2 * wave ? p->rows : 2 * wave"))],
                  "a prefill grid of two waves of blocks (half the rows a block)"),
    "few-only": ([(FEW, FEW.replace("128", "1 << 30"))], "the decode design at every row count"),
    "many-only": ([(FEW, FEW.replace("128", "0"))], "the prefill design at every row count"),
}
#: the row sweep: rows, and the (d, kind) timed at each
SWEEP_ROWS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
SWEEP_WIDTHS = ((5120, "residual"), (1536, "gated"))


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
    for i, (n, p) in enumerate(procs.items()):
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {n} failed to build:\n{log}")
        if i == 0:
            print("\n".join(f"  ptxas {n}: {line.strip()}" for line in log.splitlines()
                            if any(w in line for w in ("Compiling entry", "spill", "Used"))))
        libs[n] = (ctypes.CDLL(str(OUT / f"lib{n}.so")),
                   chip_smoke.ptxas_report(log, chip_smoke.RMSNORM_ENTRY,
                                           chip_smoke.rmsnorm_label))
    return libs


def legacy_call(lib):
    """A fused_rmsnorm over a source with the previous interface (x, r, w,
    y, rout, rows, d, eps, vec, stream): the gated norm as the chain the
    model ran with it (the cast, F.silu, the product, then the norm)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build

    f = lib["rmsnorm_fwd"]     # its own function object: bind() never retypes it
    f.argtypes = [*[ctypes.c_void_p] * 5, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int

    def call(x, w, residual=None, eps=1e-6, gate=None):
        if gate is not None:
            return call(x.to(gate.dtype) * F.silu(gate), w, eps=eps)[0], None
        t, d = x.shape
        y, rout = torch.empty_like(x), torch.empty_like(x)
        vec = int(d % 8 == 0 and all(u.data_ptr() % 16 == 0 for u in (x, w, y, rout)) and
                  (residual is None or residual.data_ptr() % 16 == 0))
        err = f(_build.ptr(x), None if residual is None else _build.ptr(residual), _build.ptr(w),
                _build.ptr(y), _build.ptr(rout), t, d, eps, vec, _build.stream_ptr(x.device))
        _build.check("rmsnorm", err)
        return y, rout
    return call


def use(lib):
    """Route the port's fused_rmsnorm (the wrapper, and the model's imports
    of it) through ``lib``; returns the function the checks call. A source
    with the previous interface is called beside the wrapper, which keeps
    the checkout's library (the chain the checks compare with uses it)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.models import layers, transformer

    legacy = not hasattr(lib, "rmsnorm_plan")
    if legacy:
        _build._libs.pop("rmsnorm", None)
    else:
        _build._libs["rmsnorm"] = lib
    _build._bound.clear()
    fn = legacy_call(lib) if legacy else ops.fused_rmsnorm
    layers.fused_rmsnorm = transformer.fused_rmsnorm = fn
    return fn


def checks(torch, chip_smoke, fn) -> tuple[list, dict]:
    """Phase 3's RMSNorm cases and race check on ``fn``, reported, not
    raised: (the cases that failed, the worst readings)."""
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    failed, worst = [], {"max_abs_err": 0.0, "ulp_excess": 0.0}
    for label, rows, d, kind in chip_smoke.RMSNORM_SHAPES + chip_smoke.RMSNORM_EXTRA:
        inp = chip_smoke.rmsnorm_inputs(torch, g, rows, d, kind)
        y, rout = chip_smoke.rmsnorm_call(fn, inp)
        r = chip_smoke.rmsnorm_check(torch, inp, y, rout, label, check=False)
        for key in worst:
            worst[key] = max(worst[key], r[key])
        if (r["tol_outside"] or r["ulp_outside"] or not r["residual_identical"]
                or r.get("chain_ulp_excess", 0.0) > 1):
            failed.append(f"{label} ({rows}, {d})")
    return failed, worst


def steady(torch, chip_smoke, order: list, libs: dict) -> dict:
    """decode_steady TPOT (ms) of mistral_nemo_12b and mamba2_130m through
    each library in ``order``, a new engine (one capture) each time."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    out = {}
    for arch, requests in (("mistral_nemo_12b", chip_smoke.REQUESTS),
                           ("mamba2_130m", chip_smoke.SSM_REQUESTS)):
        cfg = get_config(arch)
        params, prompts = chip_smoke.serve_inputs(torch, cfg, requests, chip_smoke.SEED)
        runs = []
        for n in order:
            use(libs[n][0])
            engine = ServeEngine(cfg, params, max_batch=requests,
                                 max_len=chip_smoke.PROMPT_LEN + chip_smoke.NEW_TOKENS + 1)
            with torch.no_grad():
                t = engine.decode_steady(prompts, n_steps=16, warmup=2)
            runs.append({"variant": n, "tpot_ms": t.tpot * 1e3,
                         "min_ms": min(t.step_times) * 1e3, "ttft_ms": t.ttft * 1e3})
            print(f"  steady {arch} {json.dumps(runs[-1])}", flush=True)
            del engine
        out[arch] = runs
        del params
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.models import layers, transformer

    sources, argv, steady_order = {}, sys.argv[1:], []
    while argv:             # in the order given: e.g. parent, change, change, parent
        a = argv.pop(0)
        if a == "--source":
            n, path = argv.pop(0).split("=", 1)
            sources[n] = Path(path).read_text()
        elif a == "--steady":
            steady_order = argv.pop(0).split(",")
        else:
            sources[a] = variant_source(a)
    sources = sources or {n: variant_source(n) for n in VARIANTS}
    probe_started = chip_smoke.probe_build_start()
    libs = build(sources)
    probe = chip_smoke.probe_build_finish(probe_started)
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = chip_smoke.Timer(torch)
    card = chip_smoke.nvidia_smi("name,power.limit")
    summary, sweep = [], {}
    base = {}
    for n, (lib, ptxas) in libs.items():
        fn = use(lib)
        legacy = not hasattr(lib, "rmsnorm_plan")
        failed, worst = checks(torch, chip_smoke, fn)
        race = None if legacy else chip_smoke.rmsnorm_race_check(torch, probe, fn, check=False)
        g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 1)
        shapes = {}
        for label, rows, d, kind in chip_smoke.RMSNORM_SHAPES:
            if legacy:
                t = legacy_times(torch, timer, chip_smoke, fn, g, rows, d, kind)
            else:
                t = chip_smoke.rmsnorm_times(torch, timer, probe, fn, g, rows, d, kind,
                                             yardsticks=label not in base)
                if label not in base:
                    base[label] = {k: t[k] for k in t if k in (
                        "floor_ms", "library_ms", "library_write_flush_ms", "bound_ms")}
                    if kind == "residual" and rows > chip_smoke.GRAPH_ROWS:
                        base[label]["copy_ms"] = copy_ms(torch, timer, chip_smoke, g, rows, d)
                        base[label]["copy_write_flush_ms"] = copy_ms(
                            torch, timer, chip_smoke, g, rows, d, clean=False)
            shapes[label] = t
        row = dict(variant=n, what=VARIANTS[n][1] if n in VARIANTS else "the source given",
                   shapes={k: {m: v[m] for m in ("ms", "write_flush_ms", "plan") if m in v}
                           for k, v in shapes.items()},
                   cases_failed=failed, worst=worst, race=race, ptxas=ptxas)
        summary.append(row)
        print(f"{n:15s} " + "  ".join(f"{k} {v['ms'] * 1e3:.3f} us" for k, v in shapes.items())
              + f"  failed: {failed or 'none'}  race: "
              + ("-" if race is None else str(any(sum(r['eager_wrong'] + r['replayed_wrong'])
                                                  for r in race.values())))
              + f"  # {row['what']}", flush=True)
    if "few-only" in libs and "many-only" in libs:
        g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2)
        for d, kind in SWEEP_WIDTHS:
            for rows in SWEEP_ROWS:
                for n in ("few-only", "many-only"):
                    fn = use(libs[n][0])
                    t = chip_smoke.rmsnorm_times(torch, timer, probe, fn, g, rows, d, kind,
                                                 yardsticks=False)
                    sweep.setdefault(f"{kind} d {d}", {}).setdefault(rows, {})[n] = t["ms"]
                print(f"  sweep {kind} d {d} rows {rows}: "
                      f"{json.dumps(sweep[f'{kind} d {d}'][rows])}", flush=True)
    steady_runs = None
    if steady_order:
        steady_runs = steady(torch, chip_smoke, steady_order + steady_order[::-1], libs)
    _build._libs.pop("rmsnorm", None)
    _build._bound.clear()
    layers.fused_rmsnorm = transformer.fused_rmsnorm = ops.fused_rmsnorm
    print(json.dumps({"card": card, "baseline": base, "runs": summary, "sweep": sweep,
                      "steady": steady_runs}))
    return 0


def copy_ms(torch, timer, chip_smoke, g, rows, d, clean=True) -> float:
    """What the card's memory gives this traffic: x copied to y and r to the
    new residual, two ``copy_`` calls that move the norm's bytes (w aside),
    one replay, the L2 flushed by a read (or by a write)."""
    inp = chip_smoke.rmsnorm_inputs(torch, g, rows, d, "residual")
    y, rout = torch.empty_like(inp["x"]), torch.empty_like(inp["x"])
    return timer.ms(lambda: (y.copy_(inp["x"]), rout.copy_(inp["r"])), 50, clean)


def legacy_times(torch, timer, chip_smoke, fn, g, rows, d, kind) -> dict:
    """A previous-interface source timed as ``chip_smoke.rmsnorm_times``
    times the kernel: the same graph of launches (read flush) or the same
    single launch (read and write flush)."""
    n = chip_smoke.GRAPH_LAUNCHES if rows <= chip_smoke.GRAPH_ROWS else 1
    cases = [chip_smoke.rmsnorm_inputs(torch, g, rows, d, kind) for _ in range(n)]

    def graph(clean):
        return timer.ms(lambda: [chip_smoke.rmsnorm_call(fn, c) for c in cases],
                        30 if n > 1 else 50, clean) / n
    return {"ms": graph(True)} | ({"write_flush_ms": graph(False)} if n == 1 else {})


if __name__ == "__main__":
    sys.exit(main())
