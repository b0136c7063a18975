#!/usr/bin/env python3
"""Plant faults in a copy of the SSD chunk-scan CUDA source and show which
of ``chip_smoke.py``'s checks fails each of them: the phase-3 SSD cases
(every case against the plain scan, rtol = atol = 2e-4) and phase 7's
whole-model check of mamba2_130m (decode vs prefill through the kernel and
through the plain scan on three weight seeds; the kernel route's layer 0
handoff and each layer alone within 1e-5, the deep readings within 2x the
plain route's).

    python3 tools/ssd_planted_faults.py      # from the root of a checkout

Needs a CUDA card and nvcc. For every run the script copies
``src/repro_torch`` into a temporary directory, edits the copy's ``ssd.cu``
at anchors that occur once (the checkout is never touched), builds the
copies in parallel and runs the checks in one process per run. The
unchanged source runs the same way as the baseline. Faults:

  state_rounded_to_bf16            the state carried into the next chunk
                                   is rounded to bf16;
  state_mid_term_dropped           C h drops the state's middle bf16 term:
                                   one cross term too many dropped from a
                                   split product;
  ragged_tail_last_row_out_of_h    the sequence's last row is left out of
                                   the state (its decay weight is 0);
  diagonal_of_L_dropped            the masked scores drop i == j.

The "diagnosis" run ``two_terms`` keeps two bf16 terms of every split
operand (KEEP = 1) and is only reported: it shows what the checks see of
an error just above f32 rounding.

Prints one JSON line per run, with the checks that fired and the phase-7
readings per route and seed, and exits non-zero if the baseline fails a
check or a fault passes them all.
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
SOURCE = Path("repro_torch/kernels/ssd/csrc/ssd.cu")

# Anchors: source text that occurs exactly once in ssd.cu
# (tests/test_torch_planted_faults.py holds them to that).
CARRY = "    }\n  }\n  // h_final in the model's orientation (P, N)."
H_TERMS = ("          for (int u = 0; u < 3; ++u) { ah[u][0] = s0[u]; ah[u][1] = s1[u]; "
           "ah[u][2] = s2[u]; ah[u][3] = s3[u]; }")
W0 = "      wv[2 * lane] = t0 * expf(cs_last - c0v);"
W1 = "      wv[2 * lane + 1] = t1 * expf(cs_last - c1v);"
DIAG0 = "          const float v0 = i >= j ? acc[h2][2 * rr]"
DIAG1 = "          const float v1 = i >= j + 1 ? acc[h2][2 * rr + 1]"
KEEP = "constexpr int KEEP = 2;"
ANCHORS = (CARRY, H_TERMS, W0, W1, DIAG0, DIAG1, KEEP)

#: name -> (edits as (anchor, replacement), what it does)
FAULTS = {
    "state_rounded_to_bf16": (
        [(CARRY, CARRY.replace(
            "    }\n  }\n", "    }\n    if (c + 1 < nc)\n      for (auto& r : hacc)\n"
            "        for (float& v : r) v = __bfloat162float(__float2bfloat16(v));\n  }\n"))],
        "the state carried into the next chunk is rounded to bf16"),
    "state_mid_term_dropped": (
        [(H_TERMS, H_TERMS + "\n          ah[1][0] = ah[1][1] = ah[1][2] = ah[1][3] = 0u;")],
        "C h drops the state's middle bf16 term (hi and lo kept)"),
    "ragged_tail_last_row_out_of_h": (
        [(W0, W0.replace("t0 * expf", "(c0 + 2 * lane == a.S - 1 ? 0.f : t0) * expf")),
         (W1, W1.replace("t1 * expf", "(c0 + 2 * lane + 1 == a.S - 1 ? 0.f : t1) * expf"))],
        "the sequence's last row is left out of the state"),
    "diagonal_of_L_dropped": (
        [(DIAG0, DIAG0.replace("i >= j ?", "i > j ?")),
         (DIAG1, DIAG1.replace("i >= j + 1 ?", "i > j + 1 ?"))],
        "the masked scores drop the diagonal i == j"),
}
#: name -> (edits, what it does); reported only
DIAGNOSIS = {
    "two_terms": ([(KEEP, KEEP.replace("2", "1"))],
                  "every split operand keeps two bf16 terms, not three"),
}


def plant(text: str, edits: list[tuple[str, str]]) -> str:
    """Replace each anchor, which must occur exactly once, by its edit."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"planted fault: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def run_case(src: Path) -> dict:
    """In a child process, on the kernels under ``src``: every phase-3 SSD
    case against the plain scan, then phase 7's readings and verdict."""
    sys.path[:0] = [str(src), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd.ops import ssd_chunk

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2_130m")
    phase3, worst = [], 0.0
    for label, args, plain, _ in chip_smoke.ssd_cases(
            torch, chip_smoke.SSM_REQUESTS, chip_smoke.PROMPT_LEN, 24, 64, 128):
        y, st = ssd_chunk(*args)
        yr, sr = plain()
        for got, want, what in ((y, yr, "y"), (st, sr, "state")):
            try:
                worst = max(worst, chip_smoke.compare(torch, got, want, "", chip_smoke.SSD_TOL))
            except AssertionError:
                phase3.append(f"{label} {what}")
    readings = chip_smoke.ssm_model_readings(torch, cfg, chip_smoke.SSM_REQUESTS, None)
    summary = {route: {seed: {k: float(f"{v:.3g}") for k, v in
                              chip_smoke.ssm_summary(r).items()}
                       for seed, r in by_seed.items()}
               for route, by_seed in readings.items()}
    return {"phase3_failed": phase3, "phase3_worst_err_inside": worst,
            "phase7_broken": chip_smoke.ssm_verdict(readings), "phase7": summary}


def build(src: Path) -> None:
    """Build the SSD and RMSNorm kernels of the copy at ``src`` (into its own
    build directory)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "_build.load('ssd'); _build.load('rmsnorm')")
    subprocess.run([sys.executable, "-c", code, str(src)], check=True,
                   capture_output=True, text=True, timeout=900)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--case":
        print(json.dumps(run_case(Path(sys.argv[2]))), flush=True)
        return 0
    runs = {name: ("fault", edits, what) for name, (edits, what) in FAULTS.items()}
    runs |= {name: ("diagnosis", edits, what) for name, (edits, what) in DIAGNOSIS.items()}
    with tempfile.TemporaryDirectory(prefix="planted-ssd-") as tmp:
        srcs = {}
        for name in ("baseline", *runs):
            dst = Path(tmp) / name / "src" / "repro_torch"
            shutil.copytree(ROOT / "src" / "repro_torch", dst,
                            ignore=shutil.ignore_patterns("__pycache__"))
            if name in runs:
                cu = dst.parent / SOURCE
                cu.write_text(plant(cu.read_text(), runs[name][1]))
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
            kind, _, what = runs.get(name, ("baseline", None, "the unchanged source"))
            caught = bool(res["phase3_failed"] or res["phase7_broken"])
            good = (not caught if kind == "baseline" else caught if kind == "fault"
                    else None)
            ok &= good is not False
            print(json.dumps({"run": name, "kind": kind, "what": what,
                              "caught": caught, "as_expected": good, **res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
