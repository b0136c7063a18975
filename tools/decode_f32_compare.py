#!/usr/bin/env python3
"""Hold and time the float32 decode-attention kernel against other sources
of it, in one call on one card.

    python3 tools/decode_f32_compare.py
    python3 tools/decode_f32_compare.py --source pr28=local/pr28/decode_attention_f32.cu
    python3 tools/decode_f32_compare.py split-8 warps-4 warps-4-ring-4

Needs a CUDA card and nvcc. Builds, in parallel with ``-Xptxas -v`` into
``build/decode_f32_compare/``, the committed ``decode_attention_f32.cu``
("new"), each ``--source NAME=PATH`` (another whole source with the same
``decode_attention_f32_fwd``, such as a parent commit's, written out with
``git show <commit>:src/repro_torch/kernels/decode_attention/csrc/decode_attention_f32.cu``
into a git-ignored directory) and each variant named (the committed source
with a line edited; the checkout's source is never touched):

* ``split-8``: at most 8 blocks a head group (the portable cluster size),
  not 16;
* ``warps-4``: four warps a block, not eight (half the ring: two blocks an
  SM);
* ``warps-4-ring-4``: four warps of four ring stages each (the same bytes
  in flight a block, half the warps). Eight warps of three stages would
  not fit in shared memory;
* ``lanes-x2``: twice the lanes a key (a lane per 64 bytes of a row), so
  half the keys a tile and half the ring: two blocks an SM with eight
  warps;
* ``no-tiles``: every block's part empty (the early loads still issued):
  launch, the early loads and the merges; expected to fail the checks;
* ``no-loads``: as ``no-tiles`` without the early loads: launch, q and the
  merges alone; expected to fail the checks.

Each build prints its instantiations' registers and spills. Each source is
held against the plain version (o and lse at F32_TOL 2e-5, as
``chip_smoke.py`` phase 3; kv_len 0 must give o = 0 and lse = -1e30) over
the cases below, the first through one captured launch replayed with
kv_len set on the device to 0, 1, 17, half, full, S and S + 100; the
committed source must pass, the others are reported. Then every source is
timed like ``chip_smoke.py`` times a kernel (CUDA-graph replays, L2 flushed
by a write, and by a read: clean L2) in the order given, then again in
reverse, at the paths' shapes: mistral_nemo_12b's float32 decode (1, 32/8,
cache 2081, hd 128, kv_len 2079) over its bf16 cache and over an f32 one,
and the contract's (4, 8/2, 2081) at hd 16 and 32 over a bf16 cache, with
SDPA over the valid prefix (the cache cast to f32 outside the call) and the
bound (``kernels/cost.py``) beside them. One line per reading, then a JSON
summary with the card's name and power limit.
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
SOURCE = ROOT / "src/repro_torch/kernels/decode_attention/csrc/decode_attention_f32.cu"
OUT = ROOT / "build" / "decode_f32_compare"

SPLIT = "constexpr int MAX_SPLIT = 16; "
RING = "constexpr int STW = 2; "
WARPS = "constexpr int NW = 8; "
LANES = "LPK = ROW > 128 ? ROW / 128 : 1;"
NTILES = "const int ntiles = split < tiles ? (tiles - split + n_split - 1) / n_split : 0;"
EARLY = "    if (tile_key(warp + st * NW) < p.S) issue(warp + st * NW, st);"
#: name -> edits of the committed source as (text, replacement)
VARIANTS = {
    "split-8": [(SPLIT, SPLIT.replace("16", "8"))],
    "warps-4": [(WARPS, WARPS.replace("8", "4"))],
    "warps-4-ring-4": [(WARPS, WARPS.replace("8", "4")), (RING, RING.replace("2", "4"))],
    "lanes-x2": [(LANES, LANES.replace("128", "64"))],
    "no-tiles": [(NTILES, "const int ntiles = 0 * tiles;")],
    "no-loads": [(NTILES, "const int ntiles = 0 * tiles;"), (EARLY, "")],
}
#: (label, hd, (B, H, Hkv, S, kv_len), cache dtype name) held; the first is
#: also replayed at other kv_len
CHECKS = (("mistral f32", 128, (1, 32, 8, 2081, 2079), "bfloat16"),
          ("mistral f32, f32 cache", 128, (1, 32, 8, 2081, 2079), "float32"),
          ("gqa3 ragged", 64, (2, 6, 2, 300, 299), "float32"),
          ("mha", 32, (3, 8, 8, 90, 1), "bfloat16"),
          ("gqa5", 128, (2, 10, 2, 300, 257), "bfloat16"),
          ("gqa16", 16, (2, 64, 4, 600, 577), "float32"),
          ("kv_len S", 16, (4, 8, 2, 2081, 2081), "bfloat16"),
          ("kv_len 0", 128, (2, 8, 2, 50, 0), "float32"))
#: (label, hd, (B, H, Hkv, S, kv_len), cache dtype name) timed
TIMED = (("mistral f32 decode", 128, (1, 32, 8, 2081, 2079), "bfloat16"),
         ("mistral f32 decode, f32 cache", 128, (1, 32, 8, 2081, 2079), "float32"),
         ("contract hd 16", 16, (4, 8, 2, 2081, 2079), "bfloat16"),
         ("contract hd 32", 32, (4, 8, 2, 2081, 2079), "bfloat16"))


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(sources: dict[str, str]) -> dict:
    """Build every source in parallel; returns name -> the loaded library,
    after printing its instantiations' registers and spills."""
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
            m = re.search(r"decode_f32_kernelILi(\d+)E(?:Li(\d+)E)?(f|13__nv_bfloat16)E", line)
            if "Compiling entry" in line and m:
                kernel = (f"<{m.group(1)}{', ' + m.group(2) if m.group(2) else ''}, "
                          f"{'f32' if m.group(3) == 'f' else 'bf16'}>")
            elif kernel and "spill stores" in line:
                spill = sum(map(int, re.findall(r"(\d+) bytes spill", line)))
            elif kernel and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                seen.append(f"{kernel} {regs}{f' ({spill} B spilled)' if spill else ''}")
                kernel = None
        print(f"{name}: decode_f32 registers {'; '.join(sorted(seen))}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def plan(lib, b, h, hkv, hd, bf16_cache: bool):
    """The library's launch plan at a shape ({n_split, groups, smem_bytes,
    clusters}), or None for a source without ``decode_attention_f32_plan``."""
    fn = getattr(lib, "decode_attention_f32_plan", None)
    if fn is None:
        return None
    fn.argtypes = [*[ctypes.c_int] * 5, ctypes.POINTER(ctypes.c_int64)]
    info = (ctypes.c_int64 * 4)()
    if fn(b, h, hkv, hd, int(bf16_cache), info):
        raise RuntimeError("decode_attention_f32_plan failed")
    return dict(zip(("n_split", "groups", "smem_bytes", "clusters"), info))


def caller(torch, lib):
    """decode(q, k, v, kv_len) through one library's entry point, outputs
    allocated as the wrapper allocates them; a refused launch raises."""
    fn = lib.decode_attention_f32_fwd
    fn.argtypes = [*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 6,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, kv_len):
        b, h, hd = q.shape
        _, hkv, s, _ = k.shape
        o = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
        st = (ctypes.c_int64 * 8)(q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 kv_len.data_ptr(), b, h, hkv, s, hd, int(k.dtype == torch.bfloat16), st,
                 math.log2(math.e) / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_attention_f32_fwd: CUDA error {err}")
        return o, lse
    return call


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import cost

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    sources, order = {"new": SOURCE.read_text()}, []
    args = iter(argv)
    for a in args:
        if a == "--source":
            a, path = next(args).split("=", 1)
            sources[a] = (ROOT / path).read_text()
        else:
            sources[a] = variant_source(a)
        order.append(a)
    order = order + ["new"]
    libs = build(sources)
    calls = {n: caller(torch, lib) for n, lib in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def inputs(hd, b, h, hkv, s, cache):
        q = torch.randn((b, h, hd), generator=g, device="cuda")
        k, v = (cs.contract_inputs(torch, g, b, hkv, s, hd, getattr(torch, cache))
                for _ in range(2))
        return q, k, v

    summary, failed, refused = {"card": card, "checks": {}, "ms": {}}, [], set()
    for n, (label, hd, (b, h, hkv, s, kv_len), cache) in enumerate(CHECKS):
        q, k, v = inputs(hd, b, h, hkv, s, cache)
        kl = torch.full((1,), kv_len, dtype=torch.int32, device="cuda")
        for name, call in calls.items():
            tag = f"{name} {label} (hd {hd}, {b} x {h}/{hkv}, S {s}, kv_len {kv_len}, {cache})"
            try:
                errs = [cs.f32_decode_check(torch, q, k, v, kv_len, *call(q, k, v, kl),
                                            tag)["o_err"]]
                if n == 0:
                    lens = (0, 1, 17, kv_len // 2, kv_len, s, s + 100)
                    errs += [r["o_err"] for r in cs.decode_replay_check(
                        torch, call, q, k, v, lens, f"{tag} replayed",
                        hold=cs.f32_decode_check).values()]
                got = {"max_abs_err": max(errs), "held": True}
            except (AssertionError, RuntimeError) as err:   # a refused launch too
                got = {"held": False, "error": str(err)[:200]}
                if isinstance(err, RuntimeError):
                    refused.add(name)
                if name == "new":
                    failed.append(label)
            summary["checks"][f"{name} {label}"] = got
            print(f"check {tag}: {json.dumps(got)}", flush=True)

    timer = cs.Timer(torch)
    turns = [n for n in order + order[::-1] if n not in refused]
    for label, hd, (b, h, hkv, s, kv_len), cache in TIMED:
        q, k, v = inputs(hd, b, h, hkv, s, cache)
        kl = torch.full((1,), kv_len, dtype=torch.int32, device="cuda")
        kc, vc = k[:, :, :kv_len].float(), v[:, :, :kv_len].float()
        bound_ms, bound_by = cost.decode_attention(
            b, h, hkv, hd, kv_len, f32=True, cache_bytes=k.element_size()).bound_ms()
        row = {"shape": [b, h, hkv, s, hd, kv_len], "cache": cache, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "plans": {n: plan(lib, b, h, hkv, hd, cache == "bfloat16")
                         for n, lib in libs.items() if n not in refused}}
        print(f"{label} plans: {json.dumps(row['plans'])}", flush=True)
        for clean in (False, True):
            ms = [(name, timer.ms(lambda: calls[name](q, k, v, kl), 50, clean_l2=clean))
                  for name in turns]
            sdpa = timer.ms(lambda: cs.sdpa(F, q[:, :, None], kc, vc, False), 50,
                            clean_l2=clean)
            key = "clean_l2" if clean else "write_flush"
            row[key] = {"ms": ms, "sdpa_ms": sdpa}
            print(f"{label} [{key}]: " + ", ".join(f"{n} {t:.5f}" for n, t in ms)
                  + f"; SDPA {sdpa:.5f}; bound {bound_ms:.5f} ({bound_by})", flush=True)
        summary["ms"][label] = row
    print(json.dumps(summary))
    if failed:
        print(f"the committed source failed the checks: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
