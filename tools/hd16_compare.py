#!/usr/bin/env python3
"""Hold and time the bf16 head-dim-16 decode-attention and dK/dV kernels
beside another source of the same kernels (a parent's), in one call on one
card.

    python3 tools/hd16_compare.py --source parent=local/parent
    python3 tools/hd16_compare.py --source parent=local/parent --quick split-16 cl-2

``--source NAME=DIR``: a directory holding ``decode_attention.cu`` and
``flash_attention.cu`` with the checkout's C interface, e.g. a parent's,
written with ``git show <commit>:src/repro_torch/kernels/decode_attention/
csrc/decode_attention.cu > local/parent/decode_attention.cu`` (and the same
for ``flash_attention/csrc/flash_attention.cu``). The checkout's sources run
as ``new``. Needs a CUDA card and nvcc; every source is built in parallel
into ``build/hd16_compare/`` with ``-Xptxas -v`` (the checkout is never
touched), and the registers and spills of its decode and flash kernels are
printed. Further arguments name VARIANTS: the checkout's sources with a few
lines edited, run as sources of their own (a variant that leaves work out
fails the checks, and says so).

Each source is held first: the hd-16 decode cases of ``chip_smoke.py``'s
phase 3 (:func:`chip_smoke.decode_check`: within DECODE_REL of the plain
version and one bf16 ulp + DECODE_ULP_FLOOR of the f64 value) with kv_len at
the 64-key tile's edges, one captured launch replayed while kv_len crosses
them; the hd-16 training cases and dK/dV at Sk not a multiple of 64
(:func:`chip_smoke.training_case`: each key row within TRAIN_ROW_REL, two
calls the same bits). Then every source is timed in turns, the sources in
the order given and back (old, new, new, old): decode at the SMOKE serving
shape (4, 8/2 heads, cache 2081, hd 16, kv_len 2079) as chip_smoke times a
kernel (one launch a graph replay, the L2 flushed by a write) and as
GRAPH_LAUNCHES launches on their own caches in one graph after a read of the
flush buffer, each beside SDPA and, in the graph, an empty kernel with the
decode launch's block count (the floor); dK/dV at (4, 8/2, 2048, 16)
causal. Unless ``--quick``, the hd 32, 64 and 128 instantiations (which
this design leaves alone) of both kernels give each source's bits, held
against the first source's, and are timed in the same turns. Prints one
line per reading, then a JSON summary with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels"
SOURCES = {"decode_attention": CSRC / "decode_attention" / "csrc" / "decode_attention.cu",
           "flash_attention": CSRC / "flash_attention" / "csrc" / "flash_attention.cu"}
OUT = ROOT / "build" / "hd16_compare"

#: kv_len at the new tile's edges (64 keys) and at the cache's ends
DECODE_LENS = (0, 1, 63, 64, 65, 127, 128, 129, 1000, 2079, 2081)
#: dK/dV cases beyond phase 3's: Sk not a multiple of 64, causal and full
DKV_EXTRA = (("sk-100-causal", (2, 8, 2, 100, 100, True)),
             ("sk-65-full", (1, 4, 1, 77, 65, False)),
             ("sk-191-gqa3", (2, 6, 2, 191, 191, True)))
#: the shapes the other head dims are held and timed at:
#: decode (B, H, Hkv, S, hd, kv_len), dK/dV (B, H, Hkv, Sq, Sk, hd, causal)
OTHER_DECODE = ((4, 8, 2, 2081, 32, 2079), (4, 8, 2, 2081, 64, 2079),
                (4, 32, 8, 2081, 128, 2079))
OTHER_DKV = ((4, 8, 2, 2048, 2048, 32, True), (4, 8, 2, 2048, 2048, 64, True),
             (8, 16, 16, 2048, 2048, 128, True))

OUTSIDE = "expected to fail the checks"
_SPLIT = "constexpr int H16_MAX_SPLIT = 8;"
_TK = "constexpr int H16_TK = 64; "
_WARPS = "constexpr int H16_W = 4; "
_NTILES = "    return split >= tiles ? 0 : (tiles - split + n_split - 1) / n_split;"
_EARLY = "      for (; i < H16_EARLY && tile_key(i) < p.S; ++i) issue(i);\n"
_FINAL = "  if (split != 0) return;  // nothing reads the others' shared memory\n"
_CL = "constexpr int DKV16_CL = 4; "
_MINB = "constexpr int DKV16_MINB = 4; "
_DST = "  static constexpr int ST = 4;   // ring stages (Q, dO and row statistics)"
_EXP = "            float pm = ex2_ftz(fmaf(sa[x], scale_log2, -lsev[2 * j + (e & 1)] * LOG2E));"
_BQ = "  static constexpr int BQ = 64;  // queries a Q/dO tile\n  static constexpr int ST = 4; "
_MASK = "        probs(Flag<true>{});"
_MASK_IF = "      if ((m0 + BQ > Sq) || (causal && m0 < n0 + C::BK - 1))\n"
_PACK = """    pack_a<BQ>(pf, sa);
    pack_a<BQ>(df, pd);
    // dV += P^T dO, dK += dS^T Q (the k dimension is the query)
"""
_PACK_TRUNC = """#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pf[kk][x] = __byte_perm(__float_as_uint(sa[8 * kk + 2 * x]),
                                __float_as_uint(sa[8 * kk + 2 * x + 1]), 0x7632);
        df[kk][x] = __byte_perm(__float_as_uint(pd[8 * kk + 2 * x]),
                                __float_as_uint(pd[8 * kk + 2 * x + 1]), 0x7632);
      }
    // dV += P^T dO, dK += dS^T Q (the k dimension is the query)
"""
_DVDK = """#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {  // 16 queries a k-step: 16 rows of 32 bytes
      wgmma_rs<HD>(dva, pf[kk], q_mnmaj + off + do_off + kk * (16 * C::SW >> 4));
      wgmma_rs<HD>(dka, df[kk], q_mnmaj + off + kk * (16 * C::SW >> 4));
    }
"""
_DVDK_NONE = """    {
      uint32_t fold = 0;  // every packed fragment used, so none is dropped
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) fold ^= pf[kk][x] ^ df[kk][x];
      dva[0] += __uint_as_float(fold & 0x3f800000u);
    }
"""
#: name -> (library, edits as (text, replacement), what it shows)
VARIANTS = {
    "split-16": ("decode_attention", [(_SPLIT, _SPLIT.replace("= 8;", "= 16;"))],
                 "decode: up to 16 blocks a head group (a non-portable cluster)"),
    "split-4": ("decode_attention", [(_SPLIT, _SPLIT.replace("= 8;", "= 4;"))],
                "decode: up to 4 blocks a head group"),
    "tk-32": ("decode_attention", [(_TK, _TK.replace("64", "32"))],
              "decode: 32-key tiles"),
    "warps-8": ("decode_attention", [(_WARPS, _WARPS.replace("4", "8"))],
                "decode: 8 consumer warps"),
    "merge-alone": ("decode_attention", [(_NTILES, "    return 0;"), (_EARLY, "")],
                    f"decode: no tiles, no early loads: launch, prologue and the merges; "
                    f"{OUTSIDE}"),
    "no-final-merge": ("decode_attention", [(_FINAL, "  return;\n")],
                       f"decode: the partials pushed to block 0, not merged; {OUTSIDE}"),
    "cl-2": ("flash_attention", [(_CL, _CL.replace("4", "2"))],
             "dK/dV: an item's tiles split two ways"),
    "cl-8": ("flash_attention", [(_CL, _CL.replace("4", "8"))],
             "dK/dV: an item's tiles split eight ways"),
    "minb-3": ("flash_attention", [(_MINB, _MINB.replace("4", "3"))],
               "dK/dV: three blocks an SM (up to 168 registers)"),
    "minb-2": ("flash_attention", [(_MINB, _MINB.replace("4", "2"))],
               "dK/dV: two blocks an SM"),
    "bq-128": ("flash_attention", [(_MINB, _MINB.replace("4", "2")), (_BQ, _BQ.replace("64", "128"))],
               "dK/dV: 128-query tiles, two blocks an SM"),
    "trunc-pack": ("flash_attention", [(_PACK, _PACK_TRUNC)],
                   f"dK/dV: P^T and dS^T cut to bf16 by a byte permute, not rounded by "
                   f"cvt; {OUTSIDE}"),
    "no-mask": ("flash_attention", [(_MASK, _MASK.replace("true", "false"))],
                f"dK/dV: no causal or edge mask; {OUTSIDE}"),
    "mask-always": ("flash_attention", [(_MASK_IF, "      if (true)\n")],
                    "dK/dV: every tile masked"),
    "no-exp-trunc-pack": ("flash_attention", [(_EXP, _EXP.replace("ex2_ftz(", "(")),
                                              (_PACK, _PACK_TRUNC)],
                          f"dK/dV: neither the exponential nor the rounding; {OUTSIDE}"),
    "no-dvdk": ("flash_attention", [(_DVDK, _DVDK_NONE)],
                f"dK/dV: P^T and dS^T packed but no dV, dK products; {OUTSIDE}"),
    "st-8": ("flash_attention", [(_DST, _DST.replace("4", "8"))],
             "dK/dV: 8 ring stages, not 4"),
    "no-exp": ("flash_attention", [(_EXP, _EXP.replace("ex2_ftz(", "("))],
               f"dK/dV: P without its exponential (an FMA); {OUTSIDE}"),
}


def variant_sources(name: str) -> dict[str, str]:
    """The checkout's two sources with variant ``name``'s edits."""
    lib, edits, _ = VARIANTS[name]
    texts = {n: path.read_text() for n, path in SOURCES.items()}
    for old, new in edits:
        if texts[lib].count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {texts[lib].count(old)} times")
        texts[lib] = texts[lib].replace(old, new)
    return texts


def build(sources: dict[str, dict[str, str]]) -> dict:
    """Build every (source, library) in parallel; returns name -> {library:
    (CDLL, ptxas report)}."""
    import chip_smoke
    from repro_torch.kernels import _build

    procs, first = {}, {}  # a text built once, under the first source that has it
    for n, files in sources.items():
        out = OUT / n
        out.mkdir(parents=True, exist_ok=True)
        for lib, text in files.items():
            if (lib, text) in first:
                continue
            first[lib, text] = n
            cu = out / f"{lib}.cu"
            cu.write_text(text)
            procs[n, lib] = subprocess.Popen(
                [_build.nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o",
                 str(out / f"lib{lib}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for (n, lib), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{n}/{lib} failed to build:\n{log}")
        entry = (chip_smoke.DECODE_ENTRY if lib == "decode_attention" else
                 r"(" + "|".join(chip_smoke.FLASH_KERNELS) + r")ILi(\d+)E(Lb(\d)E)?")
        label = (chip_smoke.decode_label if lib == "decode_attention" else
                 lambda m: f"{m.group(1)}<{m.group(2)}{', lse' if m.group(4) == '1' else ''}>")
        built[n, lib] = (ctypes.CDLL(str(OUT / n / f"lib{lib}.so")),
                         chip_smoke.ptxas_report(log, entry, label))
    return {n: {lib: built[first[lib, text], lib] for lib, text in files.items()}
            for n, files in sources.items()}


def use(libs: dict) -> None:
    """Point the wrappers at one source's libraries."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops

    for lib, (cdll, _) in libs.items():
        _build._libs[lib] = cdll
    _build._bound.clear()
    ops._plans.clear()


def hold(torch, chip_smoke, timer, failed: list) -> dict:
    """The hd-16 checks of one source; failures appended to ``failed``."""
    from repro_torch.kernels.decode_attention.ops import decode_attention

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 7 + 16)
    worst = {"o_err": 0.0, "ulp_excess": 0.0, "lse_err": 0.0}

    def note(label, r):
        for key in worst:
            worst[key] = max(worst[key], r[key])
        if not (r["o_err"] <= r.get("o_lim", 0.0) and r["lse_err"] <= 1e-3
                and r["ulp_excess"] <= 1.0):
            failed.append(label)
    for label, (b, h, hkv, s, kv_len) in chip_smoke.contract_decode_cases(16, "bf16"):
        shape = (b, h, hkv, s, 16, kv_len)
        q, k, v = chip_smoke.decode_inputs(torch, g, shape)
        note(label, chip_smoke.decode_check(torch, q, k, v, kv_len,
                                            *decode_attention(q, k, v, kv_len), label,
                                            check=False))
        if label == "serve":
            for n, r in chip_smoke.decode_replay_check(
                    torch, decode_attention, q, k, v, DECODE_LENS, f"{label} replayed",
                    check=False).items():
                note(f"{label} replayed at {n}", r)
    for s, kv_len in ((8192, 8000), (16384, 16383)):  # more tiles a block than it issues early
        shape = (1, 8, 2, s, 16, kv_len)
        q, k, v = chip_smoke.decode_inputs(torch, g, shape)
        note(f"long {s}", chip_smoke.decode_check(torch, q, k, v, kv_len,
                                                  *decode_attention(q, k, v, kv_len),
                                                  f"long {s}", check=False))
    q, k, v = chip_smoke.decode_inputs(torch, g, (4, 8, 2, 2081, 16, 2079))
    kl = torch.full((1,), 2079, dtype=torch.int32, device="cuda")
    out = []
    timer.ms(lambda: out.append(decode_attention(q, k, v, kl)), 20)  # replays, flushed
    note("serve, timed", chip_smoke.decode_check(torch, q, k, v, 2079, *out[-1], "timed",
                                                 check=False))
    for nrep in (1, 2, 3, 4, 8, 16):       # every group at the tile's edges
        for kv_len in (0, 1, 63, 64, 65, 300):
            shape = (2, 2 * nrep, 2, 300, 16, kv_len)
            q, k, v = chip_smoke.decode_inputs(torch, g, shape)
            note(f"gqa{nrep} kv_len {kv_len}", chip_smoke.decode_check(
                torch, q, k, v, kv_len, *decode_attention(q, k, v, kv_len),
                f"gqa{nrep}", check=False))
    bits = True
    cases = [(label, (b, h, hkv, sq, sk, 16, causal)) for label, (b, h, hkv, sq, sk, causal)
             in chip_smoke.contract_train_cases(16, "bf16")] + [
        (label, (b, h, hkv, sq, sk, 16, causal)) for label, (b, h, hkv, sq, sk, causal)
        in DKV_EXTRA]
    dkv_err = 0.0
    for label, shape in cases:
        q, k, v, do = chip_smoke.training_inputs(torch, shape)
        try:
            r = chip_smoke.training_case(torch, q, k, v, do, shape[-1], label)
            dkv_err = max(dkv_err, r["dk"]["row_scaled_err"], r["dv"]["row_scaled_err"])
        except AssertionError as e:
            failed.append(str(e)[:160])
            bits = False
    return dict(decode=worst, dkv_row_scaled_err=dkv_err, dkv_checks_passed=bits)


def main() -> int:
    import faulthandler

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import _build, cost
    from repro_torch.kernels.decode_attention.ops import decode_attention, plan
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd_dkv
    from repro_torch.kernels.flash_attention.ref import attention_delta, flash_attention_fwd_lse_ref

    argv, sources, quick, variants = sys.argv[1:], {}, False, []
    while argv:
        a = argv.pop(0)
        if a == "--source":
            n, d = argv.pop(0).split("=", 1)
            sources[n] = {lib: (Path(d) / f"{lib}.cu").read_text() for lib in SOURCES}
        elif a == "--quick":
            quick = True
        elif a in VARIANTS:
            variants.append(a)
        else:
            raise SystemExit(f"unknown argument {a}")
    # print where a hung run sits, before an outer time limit kills it
    faulthandler.dump_traceback_later(420 if quick else 1200, exit=True)
    sources["new"] = {n: path.read_text() for n, path in SOURCES.items()}
    sources |= {n: variant_sources(n) for n in variants}
    libs = build(sources)
    names = list(sources)
    for n in names:
        for lib, (_, report) in libs[n].items():
            print(f"{n} {lib} ptxas: {json.dumps(report)}", flush=True)
    probe = chip_smoke.probe_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = chip_smoke.Timer(torch)
    stream = lambda: _build.stream_ptr(torch.device("cuda"))  # noqa: E731

    held = {}
    for n in names:
        use(libs[n])
        failed: list = []
        held[n] = hold(torch, chip_smoke, timer, failed) | {"failed": failed}
        print(f"{n} held: {json.dumps(held[n])}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    dshape = (4, 8, 2, 2081, 16, 2079)
    caches = [chip_smoke.decode_inputs(torch, g, dshape)
              for _ in range(chip_smoke.GRAPH_LAUNCHES)]
    kv_len = dshape[-1]
    kl = torch.full((1,), kv_len, dtype=torch.int32, device="cuda")
    q, k, v = caches[0]
    tshape = (4, 8, 2, 2048, 2048, 16, True)
    tq, tk, tv, tdo = chip_smoke.training_inputs(torch, tshape)
    to, tlse = flash_attention_fwd_lse_ref(tq, tk, tv, True)
    tdd = attention_delta(to, tdo)
    del to
    n_graph = chip_smoke.GRAPH_LAUNCHES

    def in_graph(call):
        return timer.ms(lambda: [call(c) for c in caches], 20, clean_l2=True) / n_graph

    others = []
    if not quick:
        for shape in OTHER_DECODE:
            others.append(("decode", shape, chip_smoke.decode_inputs(torch, g, shape)))
        for shape in OTHER_DKV:
            x = chip_smoke.training_inputs(torch, shape)
            o, lse = flash_attention_fwd_lse_ref(*x[:3], shape[-1])
            others.append(("dkv", shape, (*x, lse, attention_delta(o, x[3]))))
            del o

    def run_other(kind, shape, args):
        if kind == "decode":
            kln = torch.full((1,), shape[-1], dtype=torch.int32, device="cuda")
            return lambda: decode_attention(*args, kln)
        q_, k_, v_, do_, lse_, dd_ = args
        return lambda: flash_attention_bwd_dkv(q_, k_, v_, do_, lse_, dd_, shape[-1])

    first_out = {}
    turns = names + ([] if quick else names[::-1])
    times: dict = {n: {} for n in names}
    b_dec = cost.decode_attention(4, 8, 2, 16, kv_len)
    b_dkv = cost.flash_attention_bwd_dkv(4, 8, 2, 2048, 2048, 16, True)
    bounds = {"decode": dict(zip(("bound_ms", "bound_by"), b_dec.bound_ms()),
                             exp_bound_ms=cost.exponentials(
                                 "decode_attention", 4, 8, 2, 16, kv_len).bound_ms()[0]),
              "dkv": dict(zip(("bound_ms", "bound_by"), b_dkv.bound_ms()),
                          exp_bound_ms=cost.exponentials(
                              "flash_attention_bwd_dkv", 4, 8, 2, 2048, 2048, 16,
                              True).bound_ms()[0])}
    kc, vc = k[:, :, :kv_len], v[:, :, :kv_len]
    lib_c = [(cq[:, :, None], ck[:, :, :kv_len], cv[:, :, :kv_len]) for cq, ck, cv in caches]
    yard = dict(sdpa_ms=timer.ms(lambda: chip_smoke.sdpa(F, q[:, :, None], kc, vc, False), 50),
                sdpa_graph_ms=timer.ms(lambda: [chip_smoke.sdpa(F, *c, False) for c in lib_c],
                                       20, clean_l2=True) / n_graph)
    print(f"SDPA decode {yard['sdpa_ms']:.5f} ms, in a graph {yard['sdpa_graph_ms']:.5f} ms a "
          f"launch", flush=True)
    def empty(_=None):
        _build.check("decode_attention", probe.empty_launch(
            pl["n_split"] * pl["groups"], 160, stream()))
    readings = (("dkv_ms", lambda: timer.ms(lambda: flash_attention_bwd_dkv(
                    tq, tk, tv, tdo, tlse, tdd, True), 20)),
                ("decode_graph_ms", lambda: in_graph(lambda c: decode_attention(*c, kl))),
                ("decode_ms", lambda: timer.ms(lambda: decode_attention(q, k, v, kl), 50)),
                ("empty_ms", lambda: timer.ms(empty, 50)),
                ("empty_graph_ms", lambda: in_graph(empty)))
    for key, read in readings:   # a reading of every turn before the next reading
        for turn, n in enumerate(turns):
            if key.startswith("empty") and turn >= len(names):
                continue
            use(libs[n])
            pl = plan(4, 8, 2, 16)
            r = times[n].setdefault("turns", [{} for _ in turns])[turn]
            r["plan"] = pl
            r[key] = read()
            print(f"  {n} turn {turn} {key} {r[key]:.5f}", flush=True)
    for turn, n in enumerate(turns):
        use(libs[n])
        r = times[n]["turns"][turn]
        for kind, shape, args in others:
            fn = run_other(kind, shape, args)
            out = fn()
            torch.cuda.synchronize()
            key = f"{kind}{list(shape)}"
            if key in first_out:
                got = out if isinstance(out, tuple) else (out,)
                want = first_out[key]
                r[f"{key}_bits_as_{names[0]}"] = all(bool(torch.equal(a, b))
                                                     for a, b in zip(got, want))
            else:
                first_out[key] = out if isinstance(out, tuple) else (out,)
            r[f"{key}_ms"] = timer.ms(fn, 20)
        print(f"turn {turn} {n}: {json.dumps(r)}", flush=True)
    print(json.dumps({"card": chip_smoke.nvidia_smi("name,power.limit"),
                      "bounds": bounds, **yard, "held": held, "times": times}))
    return 0 if all(not h["failed"] for n, h in held.items()
                    if not VARIANTS.get(n, ("", "", ""))[2].endswith(OUTSIDE)) else 1


if __name__ == "__main__":
    sys.exit(main())
