#!/usr/bin/env python3
"""Plant faults in a copy of the fused RMSNorm kernel (row 1) and show which
of ``chip_smoke.py``'s phase-3 RMSNorm checks fails each of them: y within
TOL of the plain version ("tol", the only check before the f64 one), y
within one bf16 ulp of its f64 value ("ulp"), the new residual bit for bit
("residual"), the gated norm within one ulp of the unfused chain ("chain"),
and the race check ("race": a predecessor that writes x last, eagerly and
replayed in a graph).

    python3 tools/rmsnorm_planted_faults.py      # from the root of a checkout

Needs a CUDA card and nvcc. For every run the script copies
``src/repro_torch`` into a temporary directory, edits the copy's
``rmsnorm.cu`` at anchors that occur once (the checkout is never touched),
builds the copies in parallel and runs the checks in one process per run.
The unchanged source runs the same way as the baseline, and once more
launched as a programmatic dependent (``pdl_on``, the edit of
``tools/rmsnorm_variants.py``'s pdl variant), which must pass too: the
port launches the kernel plainly, and only under that launch does the
dependency wait matter.
Faults:

  warp_partial_dropped     warp 1 of a block leaves its partial sum of
                           squares out (1/20 of the sum at d 5120);
  w_one_vector_off         each thread reads the next 16-byte vector of w
                           (its own at the last one);
  wait_after_x_loads       launched as a programmatic dependent, the kernel
                           waits for its predecessor only after issuing its
                           first x and r loads;
  silu_not_rounded         the gate's SiLU is not rounded to bf16 before the
                           product.

Prints one JSON line per run, with the checks that fired, and exits
non-zero if a baseline fails a check or a fault passes them all.
"""
from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = Path("repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu")

_spec = importlib.util.spec_from_file_location(
    "rmsnorm_variants", Path(__file__).with_name("rmsnorm_variants.py"))
_variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_variants)

# Anchors: text that occurs exactly once in the source
# (tests/test_torch_planted_faults.py holds them to that).
PARTIAL = "    if (lane == 0) red[buf][warp] = sq;\n"
W_LOAD = "      load_f32<VW, true>(p.w + (int64_t)v * VW, wv[k]);\n"
WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
FIRST_LOAD = "  if (prefetch) load_row<VW, PER, GATE>(p, row, first, xb, rb, yf);\n"
SILU = "          const float sz = round_to<Elt>(zf / (1.f + expf(-zf)));\n"
#: the launch as a programmatic dependent, the variants tool's edit
PDL_ON = _variants.PDL_ON
ANCHORS = (PARTIAL, W_LOAD, WAIT, FIRST_LOAD, PDL_ON[0], SILU)

#: name -> (edits as (anchor, replacement), what it does); BASELINES must pass
FAULTS = {
    "warp_partial_dropped": ([(PARTIAL, PARTIAL.replace("= sq;", "= warp == 1 ? 0.f : sq;"))],
                             "warp 1 leaves its partial sum of squares out"),
    "w_one_vector_off": ([(W_LOAD, W_LOAD.replace("(int64_t)v * VW", "(int64_t)(v + 1 < nvec ? v + 1 : v) * VW"))],
                         "each thread reads the next vector of w"),
    "wait_after_x_loads": ([PDL_ON, (WAIT, ""), (FIRST_LOAD, FIRST_LOAD + WAIT)],
                           "a programmatic dependent that waits after its first x loads"),
    "silu_not_rounded": ([(SILU, SILU.replace("round_to<Elt>(zf / (1.f + expf(-zf)))",
                                              "zf / (1.f + expf(-zf))"))],
                         "SiLU not rounded to bf16 before the product"),
}
BASELINES = {"baseline": ([], "the unchanged source"),
             "pdl_on": ([PDL_ON], "the source launched as a programmatic dependent")}


def plant(text: str, edits: list[tuple[str, str]]) -> str:
    """Replace each anchor, which must occur exactly once, by its edit."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"planted fault: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def run_case(src: Path) -> dict:
    """In a child process, on the package under ``src``: every phase-3
    RMSNorm case and the race check, reported (not raised)."""
    sys.path[:0] = [str(src), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm

    probe = chip_smoke.probe_library()
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    fired = {"tol": [], "ulp": [], "residual": [], "chain": [], "race": []}
    worst = {"max_abs_err": 0.0, "ulp_excess": 0.0, "chain_ulp_excess": 0.0}
    for label, rows, d, kind in chip_smoke.RMSNORM_SHAPES + chip_smoke.RMSNORM_EXTRA:
        inp = chip_smoke.rmsnorm_inputs(torch, g, rows, d, kind)
        key = f"{label} ({rows}, {d})"
        r = chip_smoke.rmsnorm_check(torch, inp, *chip_smoke.rmsnorm_call(fused_rmsnorm, inp),
                                     key, check=False)
        for name, bad in (("tol", r["tol_outside"]), ("ulp", r["ulp_outside"]),
                          ("residual", not r["residual_identical"]),
                          ("chain", r.get("chain_ulp_excess", 0.0) > 1)):
            if bad:
                fired[name].append(key)
        for k in worst:
            worst[k] = max(worst[k], r.get(k, 0.0))
    race = chip_smoke.rmsnorm_race_check(torch, probe, fused_rmsnorm, check=False)
    fired["race"] = [k for k, v in race.items() if any(v["eager_wrong"] + v["replayed_wrong"])]
    return {"fired": {k: v for k, v in fired.items() if v}, "worst": worst, "race": race}


def build(src: Path) -> None:
    """Build the RMSNorm kernel and the measurement helper of the copy at
    ``src`` (into its own build directory)."""
    code = ("import sys; sys.path[:0] = sys.argv[1:3]; import chip_smoke; "
            "from repro_torch.kernels import _build; _build.load('rmsnorm'); "
            "chip_smoke.probe_library()")
    subprocess.run([sys.executable, "-c", code, str(src), str(ROOT)], check=True,
                   capture_output=True, text=True, timeout=900)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--case":
        print(json.dumps(run_case(Path(sys.argv[2]))), flush=True)
        return 0
    runs = BASELINES | FAULTS
    with tempfile.TemporaryDirectory(prefix="planted-rmsnorm-") as tmp:
        srcs = {}
        for name, (edits, _) in runs.items():
            dst = Path(tmp) / name / "src" / "repro_torch"
            shutil.copytree(ROOT / "src" / "repro_torch", dst,
                            ignore=shutil.ignore_patterns("__pycache__"))
            f = dst.parent / KERNEL
            f.write_text(plant(f.read_text(), edits))
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
            caught = bool(res["fired"])
            good = caught == (name in FAULTS)
            ok &= good
            print(json.dumps({"run": name, "what": runs[name][1], "caught": caught,
                              "as_expected": good, **res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
