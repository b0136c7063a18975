#!/usr/bin/env python3
"""Plant faults in a copy of the flash-attention CUDA source and show that
``chip_smoke.py``'s check of the training kernels fails each of them.

    python3 tools/flash_planted_faults.py      # from the root of a checkout

Needs a CUDA card and nvcc. Each fault is a one-line edit. The forward's
faults break its pipeline (the producer skips the last V tile, a consumer
waits on the wrong mbarrier parity, only the first 64-column half of an
hd 128 row is loaded) or drop one 128-key tile for the last block's rows;
the backward's drop one 64-key or 32-query tile, deep in the sequence or at
its end, for every row after it or for the last block's rows only. A fault
that leaves a wait unanswered makes the kernel give up the wait and write
NaN (the source's pipeline watchdog), so it fails the check without
hanging the card. For every fault the script copies ``src/repro_torch``
into a temporary directory, edits the copy's ``flash_attention.cu`` (the
checkout is never touched), builds it, runs ``chip_smoke.training_case``
at the olmo_1b training shape (8, 16, 2048, 128), causal, and reads two
ratios for each output: the largest error over the whole tensor's largest
plain value, and the worst row's largest error over that row's largest
plain value (the check ``chip_smoke.py`` makes, limit 2e-2). The
unchanged source runs the same way as the baseline. Prints one JSON line
per run and exits non-zero if the baseline fails the row check or a fault
passes it.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("repro_torch/kernels/flash_attention/csrc/flash_attention.cu")

# Anchors: source text that occurs exactly once in flash_attention.cu
# (tests/test_torch_planted_faults.py holds them to that).
FWD_PRODUCER_LOOP = "for (int it = -1; it < n_tiles; ++it) {"
FWD_K_WAIT = ("const int sk = kt % ST, sv = vt % ST;\n"
              "        mbar_wait(full_k + sk, (kt / ST) & 1, stuck);")
FWD_BOX = "tma_load_4d(dst + c * 128 * C::SW, map, bar, c * C::CW, head, row, batch);"
FWD_MASK = "if ((n0 + FBN > Sk) || (causal && n0 + FBN - 1 > m0w)) {"
FWD_LIM = "lim[rh] = (causal ? min(Sk, qrow[rh] + 1) : Sk) - n0 - 2 * t;"
DKV_OK = "const bool ok = m0 + qc < Sq && !(causal && key > m0 + qc);"
DQ_MASK = "const bool mask = (n0 + BN > Sk) || (causal && n0 + BN - 1 > m0);"
DQ_OK = "const bool ok = !mask || (key < Sk && !(causal && key > qrow[rh]));"
ANCHORS = (FWD_PRODUCER_LOOP, FWD_K_WAIT, FWD_BOX, FWD_MASK, FWD_LIM, DKV_OK,
           DQ_MASK, DQ_OK)


def _drop_fwd_keys(cond: str) -> list[tuple[str, str]]:
    return [(FWD_MASK, FWD_MASK.replace(")) {", f") || ({cond})) {{")),
            (FWD_LIM, FWD_LIM.replace("= (causal", f"= ({cond}) ? 0 : (causal"))]


def _drop_dq_keys(cond: str) -> list[tuple[str, str]]:
    return [(DQ_MASK, DQ_MASK[:-1] + f" || ({cond});"),
            (DQ_OK, DQ_OK.replace("const bool ok = ", f"const bool ok = !({cond}) && (")
             [:-1] + ");")]


def _drop_dkv_queries(cond: str) -> list[tuple[str, str]]:
    return [(DKV_OK, DKV_OK.replace("m0 + qc < Sq &&", f"m0 + qc < Sq && !({cond}) &&"))]


#: name -> (the outputs it corrupts, edits as (anchor, replacement), what it
#: does). The forward's first three break the TMA / mbarrier pipeline; the
#: other forward fault and the last two backward ones drop a tile for the
#: rows of one block at the end of the sequence only, whose values are the
#: smallest of a causal tensor; the other backward faults drop a tile for
#: every row after it.
FAULTS = {
    "fwd_producer_skips_last_stage": (
        ("o",), [(FWD_PRODUCER_LOOP, FWD_PRODUCER_LOOP.replace(
            "it < n_tiles;", "it < n_tiles - 1;"))],
        "the producer never loads an item's last V tile"),
    "fwd_wrong_parity": (
        ("o",), [(FWD_K_WAIT, FWD_K_WAIT.replace("(kt / ST) & 1,", "((kt / ST) & 1) ^ 1,"))],
        "the consumers wait on each K stage's barrier with the wrong phase parity"),
    "fwd_first_half_only": (
        ("o",), [(FWD_BOX, FWD_BOX.replace("c * C::CW, head", "0, head"))],
        "every hd 128 tile loads columns 0-63 into both halves"),
    "fwd_deep_key_tile_last_rows": (
        ("o",), _drop_fwd_keys("m0w - 64 * wg + FBM >= Sq && n0 == 1024"),
        "forward skips keys 1024-1151 for the last 128 queries only"),
    "dkv_deep_query_tile": (("dk", "dv"), _drop_dkv_queries("m0 == 1024"),
                            "dK/dV skips queries 1024-1055"),
    "dkv_last_query_tile": (("dk", "dv"), _drop_dkv_queries("m0 + BQ2 >= Sq"),
                            "dK/dV skips the last 32-query tile"),
    "dq_deep_key_tile": (("dq",), _drop_dq_keys("n0 == 1024"),
                         "dQ skips keys 1024-1087"),
    "dkv_last_query_tile_last_keys": (
        ("dk", "dv"), _drop_dkv_queries("m0 + BQ2 >= Sq && n0 + BN >= Sk"),
        "dK/dV skips the last 32 queries for the last 64 keys only"),
    "dq_deep_key_tile_last_rows": (
        ("dq",), _drop_dq_keys("m0 + BM >= Sq && n0 == 1024"),
        "dQ skips keys 1024-1087 for the last 64 queries only"),
}
LIMIT = 2e-2


def plant(text: str, edits: list[tuple[str, str]]) -> str:
    """Replace each anchor, which must occur exactly once, by its edit."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"planted fault: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def run_case(src: Path) -> dict:
    """In a child process: run the training-shape case on the kernels under
    ``src`` (built at their first launch) without failing on it."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke

    shape = chip_smoke.TRAIN_CASES[0][1]
    q, k, v, do = chip_smoke.training_inputs(torch, shape)
    try:
        res = chip_smoke.training_case(torch, q, k, v, do, shape[-1], "train",
                                       check=False)
    except RuntimeError as e:      # a fault that makes a launch fail
        return {"kernel_error": str(e).splitlines()[0][:200]}
    return {x: {k: res[x][k] for k in ("whole_scaled_err", "row_scaled_err", "finite")}
            for x in ("o", "dk", "dv", "dq")}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--case":
        print(json.dumps(run_case(Path(sys.argv[2]))), flush=True)
        return 0
    with tempfile.TemporaryDirectory(prefix="planted-") as tmp:
        srcs = {"baseline": ROOT / "src"}
        for name, (_, edits, _) in FAULTS.items():
            dst = Path(tmp) / name / "src" / "repro_torch"
            shutil.copytree(ROOT / "src" / "repro_torch", dst,
                            ignore=shutil.ignore_patterns("__pycache__"))
            cu = dst.parent / SOURCE
            cu.write_text(plant(cu.read_text(), edits))
            srcs[name] = dst.parent
        ok = True
        for name, src in srcs.items():
            out = subprocess.run([sys.executable, __file__, "--case", str(src)],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            hit = FAULTS[name][0] if name in FAULTS else ()
            failed = "kernel_error" in res
            caught_rows = failed or any(not res[x]["row_scaled_err"] <= LIMIT
                                        for x in hit)
            caught_whole = failed or any(not res[x]["whole_scaled_err"] <= LIMIT
                                         for x in hit)
            clean = not failed and all(res[x]["row_scaled_err"] <= LIMIT
                                       and res[x]["finite"] for x in res)
            good = clean if name == "baseline" else caught_rows
            ok &= good
            print(json.dumps({"run": name,
                              "what": FAULTS[name][2] if name in FAULTS else
                              "the unchanged source",
                              "row_check_fails": not clean if name == "baseline"
                              else caught_rows,
                              "whole_tensor_check_fails": caught_whole
                              if name in FAULTS else None,
                              "as_expected": good, **res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
