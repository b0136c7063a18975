#!/usr/bin/env python3
"""Plant faults in a copy of the flash-attention CUDA source and show that
``chip_smoke.py``'s check of the training kernels fails each of them, and
that a pipeline fault leaves the process's CUDA context usable.

    python3 tools/flash_planted_faults.py      # from the root of a checkout

Needs a CUDA card and nvcc. Each fault is a one-line edit (or a few).
"pipeline" faults break a TMA / mbarrier pipeline: a producer that never
loads an item's last tile (the forward's V, dQ's K/V, dK/dV's Q/dO), a
consumer that waits on the wrong phase parity, a forward load of only the
first 64-column half of an hd 128 row. "tile" faults drop one tile, deep
in the sequence or at its end, for every row after it or for the last
block's rows only.

What a pipeline fault does: a wait that is never answered gives up after
~2^32 cycles and sets the block's stuck flag; the block's other waits then
return at once, its producer stops loading and waits for the loads it
issued to land, and its epilogue writes NaN. A fault that leaves no wait
unanswered (a wrong parity lets the consumers run ahead of the data)
yields wrong values instead. Either way the row check fails, and the CUDA
context stays usable: after every run the case process makes a cuBLAS
product and a launch of the unchanged RMSNorm kernel, each against its
plain version. A launch that ends in a CUDA error counts as caught but not
as expected for a pipeline fault. The "diagnosis" runs plant the two
forward pipeline faults into the forward with part of that repair taken
out (the producer's stop, the drain, or both) and are reported only.

For every run the script copies ``src/repro_torch`` into a temporary
directory, edits the copy's ``flash_attention.cu`` (the checkout is never
touched), builds the copies in parallel, runs ``chip_smoke.training_case``
at the olmo_1b training shape (8, 16, 2048, 128), causal, in one process
per run, and reads two ratios for each output: the largest error over the
whole tensor's largest plain value, and the worst row's largest error over
that row's largest plain value (the check ``chip_smoke.py`` makes, limit
2e-2). The unchanged source runs the same way as the baseline. Prints one
JSON line per run and exits non-zero if the baseline fails the row check
or leaves the context unusable, or a fault passes the row check, or a
pipeline fault leaves the context unusable.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("repro_torch/kernels/flash_attention/csrc/flash_attention.cu")

# Anchors: source text that occurs exactly once in flash_attention.cu
# (tests/test_torch_planted_faults.py holds them to that).
FWD_PRODUCER_LOOP = "for (int it = -1; it < n_tiles; ++it) {"
FWD_K_WAIT = ("const int sk = kt % ST, sv = vt % ST;\n"
              "        mbar_wait(full_k + sk, (kt / ST) & 1, stuck);")
FWD_BOX = ("  for (int c = 0; c < C::NC; ++c)\n"
           "    tma_load_4d(dst + c * ROWS * C::SW, map, bar, c * C::CW, head, row, batch);")
FWD_MASK = "if ((n0 + FBN > Sk) || (causal && n0 + FBN - 1 > m0w)) {"
FWD_LIM = "lim[rh] = (causal ? min(Sk, qrow[rh] + 1) : Sk) - n0 - 2 * t;"
DQ_PRODUCER_LOOP = "for (; j < n_tiles; ++j) {"
DQ_WAIT = "mbar_wait(full + st, (j / ST) & 1, stuck);"
DQ_MASK = "if ((n0 + BN > Sk) || (causal && n0 + BN - 1 > m0w)) {"
DQ_VIS = "vis[rh] = (causal ? min(Sk, qrow[rh] + 1) : Sk) - n0 - 2 * t;"
DKV_PRODUCER_LOOP = "for (; i < tiles; ++i) {"
DKV_WAIT = "mbar_wait(full + st, (i / ST) & 1, stuck);"
DKV_PV = "const float pv = c >= lo[e >> 1] && c < hi ? p : 0.f;"
ANCHORS = (FWD_PRODUCER_LOOP, FWD_K_WAIT, FWD_BOX, FWD_MASK, FWD_LIM,
           DQ_PRODUCER_LOOP, DQ_WAIT, DQ_MASK, DQ_VIS, DKV_PRODUCER_LOOP,
           DKV_WAIT, DKV_PV)


def _drop_fwd_keys(cond: str) -> list[tuple[str, str]]:
    return [(FWD_MASK, FWD_MASK.replace(")) {", f") || ({cond})) {{")),
            (FWD_LIM, FWD_LIM.replace("= (causal", f"= ({cond}) ? 0 : (causal"))]


def _drop_dq_keys(cond: str) -> list[tuple[str, str]]:
    return [(DQ_MASK, DQ_MASK.replace(")) {", f") || ({cond})) {{")),
            (DQ_VIS, DQ_VIS.replace("= (causal", f"= ({cond}) ? 0 : (causal"))]


def _drop_dkv_queries(cond: str) -> list[tuple[str, str]]:
    return [(DKV_PV, DKV_PV.replace("= c >= lo", f"= !({cond}) && c >= lo"))]


def _wrong_parity(anchor: str, counter: str) -> list[tuple[str, str]]:
    return [(anchor, anchor.replace(f"({counter} / ST) & 1,", f"(({counter} / ST) & 1) ^ 1,"))]


#: name -> (kind, the outputs it corrupts, edits as (anchor, replacement),
#: what it does). "pipeline" faults break a TMA / mbarrier pipeline: the
#: block's watchdog must turn them into failed rows with the CUDA context
#: still usable. "tile" faults drop a tile: the dK/dV and dQ ones for every
#: row after it, or, like the forward's, for the rows of one block at the
#: end of the sequence only, whose values are the smallest of a causal
#: tensor.
FAULTS = {
    "fwd_producer_skips_last_stage": (
        "pipeline", ("o",), [(FWD_PRODUCER_LOOP, FWD_PRODUCER_LOOP.replace(
            "it < n_tiles;", "it < n_tiles - 1;"))],
        "the producer never loads an item's last V tile"),
    "fwd_wrong_parity": (
        "pipeline", ("o",), _wrong_parity(FWD_K_WAIT, "kt"),
        "the consumers wait on each K stage's barrier with the wrong phase parity"),
    "fwd_first_half_only": (
        "pipeline", ("o",), [(FWD_BOX, FWD_BOX.replace("c * C::CW, head", "0, head"))],
        "every hd 128 tile loads columns 0-63 into both halves"),
    "fwd_deep_key_tile_last_rows": (
        "tile", ("o",), _drop_fwd_keys("m0w - 64 * wg + FBM >= Sq && n0 == 1024"),
        "forward skips keys 1024-1151 for the last 128 queries only"),
    "dq_producer_skips_last_tile": (
        "pipeline", ("dq",), [(DQ_PRODUCER_LOOP, DQ_PRODUCER_LOOP.replace(
            "j < n_tiles;", "j < n_tiles - 1;"))],
        "the dQ producer never loads an item's last K/V tile"),
    "dq_wrong_parity": (
        "pipeline", ("dq",), _wrong_parity(DQ_WAIT, "j"),
        "the dQ consumers wait on each K/V stage with the wrong phase parity"),
    "dkv_producer_skips_last_tile": (
        "pipeline", ("dk", "dv"), [(DKV_PRODUCER_LOOP, DKV_PRODUCER_LOOP.replace(
            "i < tiles;", "i < tiles - 1;"))],
        "the dK/dV producer never loads an item's last Q/dO tile"),
    "dkv_wrong_parity": (
        "pipeline", ("dk", "dv"), _wrong_parity(DKV_WAIT, "i"),
        "the dK/dV consumers wait on each Q/dO stage with the wrong phase parity"),
    "dkv_deep_query_tile": ("tile", ("dk", "dv"), _drop_dkv_queries("m0 == 1024"),
                            "dK/dV skips queries 1024-1087"),
    "dkv_last_query_tile": ("tile", ("dk", "dv"), _drop_dkv_queries("m0 + BQ >= Sq"),
                            "dK/dV skips the last 64-query tile"),
    "dq_deep_key_tile": ("tile", ("dq",), _drop_dq_keys("n0 == 1024"),
                         "dQ skips keys 1024-1087"),
    "dkv_last_query_tile_last_keys": (
        "tile", ("dk", "dv"), _drop_dkv_queries("m0 + BQ >= Sq && n0w + 64 >= Sk"),
        "dK/dV skips the last 64 queries for the last 64 keys only"),
    "dq_deep_key_tile_last_rows": (
        "tile", ("dq",), _drop_dq_keys("m0w + 64 >= Sq && n0 == 1024"),
        "dQ skips keys 1024-1087 for the last 64 queries only"),
}
# The forward producer's stop once a wait has given up, and its drain.
FWD_STOP = [("L < items && !*stuck;", "L < items;"),
            ("        if (*stuck) break;\n        load_rows<HD, FBM>(&qmap",
             "        load_rows<HD, FBM>(&qmap"),
            ("            if (*stuck) break;\n            load_rows<HD, FBN>(&kmap",
             "            load_rows<HD, FBN>(&kmap"),
            ("            if (*stuck) break;\n            load_rows<HD, FBN>(&vmap",
             "            load_rows<HD, FBN>(&vmap")]
FWD_DRAIN = [("      drain_ring(full_q, 2, nq);\n      drain_ring(full_k, ST, kt);\n"
              "      drain_ring(full_v, ST, vt);\n", "")]
#: name -> (the fault, repair edits taken out, what is left of the repair)
DIAGNOSIS = {f"{fault}_{cut}": (fault, edits, what)
             for fault in ("fwd_producer_skips_last_stage", "fwd_wrong_parity")
             for cut, edits, what in (
                 ("no_drain", FWD_DRAIN, "the producer stops, no drain"),
                 ("no_stop", FWD_STOP, "the producer keeps loading, then drains"),
                 ("no_repair", FWD_STOP + FWD_DRAIN,
                  "the producer keeps loading and exits without a drain"))}
LIMIT = 2e-2


def plant(text: str, edits: list[tuple[str, str]]) -> str:
    """Replace each anchor, which must occur exactly once, by its edit."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"planted fault: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def context_usable(torch) -> dict:
    """After a run: a cuBLAS product and a launch of the (unchanged) RMSNorm
    kernel, each against its plain version; any CUDA error means the
    faulted launch broke the process's context."""
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref
    try:
        g = torch.Generator(device="cuda").manual_seed(7)
        a = torch.randn(256, 256, generator=g, device="cuda")
        blas = bool(torch.allclose((a @ a).cpu(), a.cpu() @ a.cpu(), rtol=1e-3, atol=1e-3))
        x = torch.randn(64, 512, generator=g, device="cuda").bfloat16()
        w = torch.rand(512, generator=g, device="cuda") + 0.5
        y = fused_rmsnorm(x, w)[0]
        kernel = bool(torch.allclose(y.float(), fused_rmsnorm_ref(x, w)[0].float(),
                                     rtol=2e-2, atol=2e-2))
        torch.cuda.synchronize()
        return {"context_usable": blas and kernel}
    except RuntimeError as e:
        return {"context_usable": False, "context_error": str(e).splitlines()[0][:200]}


def run_case(src: Path) -> dict:
    """In a child process: run the training-shape case on the kernels under
    ``src`` without failing on it, then check that the context still works."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke

    shape = chip_smoke.TRAIN_CASES[0][1]
    q, k, v, do = chip_smoke.training_inputs(torch, shape)
    try:
        res = chip_smoke.training_case(torch, q, k, v, do, shape[-1], "train",
                                       check=False)
        out = {x: {k: res[x][k] for k in ("whole_scaled_err", "row_scaled_err", "finite")}
               for x in ("o", "dk", "dv", "dq")}
    except RuntimeError as e:      # a fault that makes a launch fail
        out = {"kernel_error": str(e).splitlines()[0][:200]}
    return out | context_usable(torch)


def build(src: Path) -> None:
    """Build the flash-attention and RMSNorm kernels of the copy at ``src``
    (into its own build directory)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "_build.load('flash_attention'); _build.load('rmsnorm')")
    subprocess.run([sys.executable, "-c", code, str(src)], check=True,
                   capture_output=True, text=True, timeout=900)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--case":
        print(json.dumps(run_case(Path(sys.argv[2]))), flush=True)
        return 0
    runs = {name: (kind, hit, edits, what)
            for name, (kind, hit, edits, what) in FAULTS.items()}
    for name, (fault, cut, what) in DIAGNOSIS.items():
        kind, hit, edits, _ = FAULTS[fault]
        runs[name] = ("diagnosis", hit, edits + cut, f"{fault} with {what}")
    with tempfile.TemporaryDirectory(prefix="planted-") as tmp:
        srcs = {}
        for name in ("baseline", *runs):
            dst = Path(tmp) / name / "src" / "repro_torch"
            shutil.copytree(ROOT / "src" / "repro_torch", dst,
                            ignore=shutil.ignore_patterns("__pycache__"))
            if name in runs:
                cu = dst.parent / SOURCE
                cu.write_text(plant(cu.read_text(), runs[name][2]))
            srcs[name] = dst.parent
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(build, srcs.values()))
        ok = True
        for name, src in srcs.items():
            out = subprocess.run([sys.executable, __file__, "--case", str(src)],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            kind, hit, _, what = runs.get(name, ("baseline", (), None,
                                                 "the unchanged source"))
            failed = "kernel_error" in res
            caught_rows = failed or any(not res[x]["row_scaled_err"] <= LIMIT
                                        for x in hit)
            caught_whole = failed or any(not res[x]["whole_scaled_err"] <= LIMIT
                                         for x in hit)
            usable = res["context_usable"]
            if name == "baseline":
                good = not failed and usable and all(
                    res[x]["row_scaled_err"] <= LIMIT and res[x]["finite"]
                    for x in ("o", "dk", "dv", "dq"))
            elif kind == "pipeline":
                good = caught_rows and usable and not failed
            elif kind == "tile":
                good = caught_rows and usable
            else:
                good = None               # diagnosis: reported only
            ok &= good is not False
            print(json.dumps({"run": name, "kind": kind, "what": what,
                              "row_check_fails": caught_rows if hit else not good,
                              "whole_tensor_check_fails": caught_whole if hit else None,
                              "as_expected": good, **res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
