"""Run the parts of ``chip_smoke.py`` that the kernels' contract (head dim
16 in bf16, float32 at every head dim) reaches, alone on one card: the
build reports of every kernel instantiation (``chip_smoke.build_reports``:
registers, spills, shared memory), phase 3's checks of the contract's
instantiations (:func:`chip_smoke.check_contract`), then any of phase 12
(the validation loop, its moe twin at hd 16 on the card) and phases 22-25
(hd-16 SMOKE serving and training, float32 SMOKE configs card vs CPU,
mistral_nemo_12b served and olmo_1b trained in float32 at full size).
Each part's failure is printed and the next part still runs; the exit
code is 1 if any failed.

    python3 tools/contract_phases.py                  # build and phase 3
    python3 tools/contract_phases.py 12 22 23 24 25   # and those phases
    python3 tools/contract_phases.py --no-phase3 23   # build and phase 23

From the root of a checkout; a few minutes, the kernels' build included.
"""
from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    card = cs.nvidia_smi("name,power.limit")
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    logs = _build.build_all(verbose=True)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    reports, failed = cs.build_reports(logs)
    for name, report in reports.items():
        print(f"{name} kernels ({cs.BUILD_COLUMNS[name]}): {json.dumps(report)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = []
    if "--no-phase3" not in argv:
        parts.append(("phase 3 contract", lambda: cs.check_contract(torch, cs.Timer(torch))))
    phases = {"12": lambda: cs.check_validation(card),
              "22": lambda: cs.phase22_hd16(torch, kernels),
              "23": lambda: cs.phase23_f32_smoke(torch, kernels),
              "24": lambda: cs.phase24_f32_serving(torch, kernels),
              "25": lambda: cs.phase25_f32_training(torch, kernels)}
    parts += [(f"phase {p}", phases[p]) for p in argv if p in phases]
    for name, run in parts:
        t1 = time.perf_counter()
        try:
            run()
        except Exception:
            traceback.print_exc()
            failed.append(name)
        torch.cuda.empty_cache()
        print(f"{name} in {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s; failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
