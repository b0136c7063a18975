"""Gate of the port's modeled-vs-measured validation loop.

For every smoke serving scenario with an executable twin (`serving`,
`mamba2`, `moe`) this gate compares the analytical prediction against the
twin's execution and applies the declared error bands of
`repro_torch.validation.report`:

* **dry-run channel (mandatory)** — FLOPs / bytes / collective link bytes
  of one decode step, counted by `repro_torch.validation.opcount`. With a
  CUDA card the step is counted fresh on the kernels' route (every twin's
  shape, the moe twin's hd 16 among them, is one the kernels take);
  without one the gate
  falls back to the *measured* numbers committed in
  `BENCH_validation_torch.json` and still re-derives the analytical
  predictions from scratch, so a model-side drift fails on a machine
  without a card.
* **wall-clock channel** — steady-state TPOT on a real `ServeEngine`
  (warmup discarded, per-step sync, trimmed mean), gated one-sided on the
  compute term everywhere and two-sided through the hybrid roofline on
  `wall_gate` cases. Needs the card; skipped with a visible notice
  otherwise (the committed baseline records the card's numbers, its name
  and its power limit).

Exit 1 on any band violation. `--update` re-measures everything on the
card and rewrites `BENCH_validation_torch.json`.

  PYTHONPATH=src python tools/check_validation_torch.py [--update]
                                                        [--baseline PATH]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
BASELINE = REPO / "BENCH_validation_torch.json"


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def _baseline_rows(base: dict) -> list[dict]:
    """Re-derive predictions fresh (numpy only) at the baseline's
    calibration, reuse the committed dry-run counts; drop wall-clock
    sections (another machine's clock means nothing here)."""
    from repro_torch.validation import build_case, build_case_report, predict_case

    rows = []
    cal = base["calibration"]
    for brow in base["cases"]:
        case = build_case(brow["case"])
        predicted = predict_case(case, cal["flop_rate"], cal["mem_bw"])
        rows.append(build_case_report(brow["case"], predicted, brow["dryrun"],
                                      None, None, case.twin.wall_gate))
    return rows


def print_rows(rows: list[dict]) -> None:
    for row in rows:
        r = row["ratios"]
        line = (f"  {row['case']:10s} dry run ({row['dryrun'].get('route', '?')}"
                f" route) flops x{r['flops']:.4f}  bytes x{r['bytes']:.2f}  "
                f"collective Δ {row['collective_delta_bytes']:.0f} B")
        if "wallclock" in row:
            line += (f"  | TPOT {row['wallclock']['tpot'] * 1e3:.4f} ms, "
                     f"predicted x{r['step_time']:.3f}, compute-term "
                     f"x{r['compute_term']:.3f}, hybrid x{r['hybrid']:.3f}"
                     f"{' [gated]' if row['wall_gate'] else ''}")
        elif "wallclock_absent" in row:
            line += f"  | no wall clock: {row['wallclock_absent']}"
        print(line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=BASELINE,
                    help=f"baseline JSON (default {BASELINE})")
    ap.add_argument("--update", action="store_true",
                    help="re-measure on the card and rewrite the baseline")
    args = ap.parse_args()

    import torch

    from repro_torch.validation import check_report, measure_cases, write_report

    on_card = torch.cuda.is_available()
    if args.update and not on_card:
        print("validation gate: --update measures on a CUDA card; none here",
              file=sys.stderr)
        return 1
    if on_card:
        report = measure_cases() | {"device": card()}
        if args.update:
            write_report(report, args.baseline)
            print_rows(report["cases"])
            print(f"validation baseline updated: {args.baseline}")
            return 0
    else:
        print("validation gate: no CUDA card — wall-clock channel SKIPPED; "
              "gating fresh analytical predictions against the committed "
              "dry-run counts")
        if not args.baseline.exists():
            print(f"validation gate: no baseline at {args.baseline}; run "
                  f"--update on the card first", file=sys.stderr)
            return 1
        report = {"cases": _baseline_rows(json.loads(args.baseline.read_text()))}

    print_rows(report["cases"])
    problems = check_report(report)
    if problems:
        print("validation gate: FAIL", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    n_wall = sum(1 for r in report["cases"] if "wallclock" in r)
    print(f"validation gate: PASS ({len(report['cases'])} cases dry-run "
          f"validated, {n_wall} wall-clock"
          f"{'' if on_card else ' [wall clocks skipped: no card]'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
