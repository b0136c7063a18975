"""Run the parts of ``chip_smoke.py`` that training through the fused
RMSNorm and the SSD scan reaches, alone on the card: the build report of
the RMSNorm backward kernels (registers, spills), phase 3's RMSNorm
backward checks and times, then phase 18 (the full-width gradient checks,
the SMOKE steps card vs CPU, ``run_train`` on mamba2_130m, mistral_nemo_12b
under remat "full" and "dots"). Each part's failure is printed and the next
part still runs; the exit code is 1 if any failed.

    python3 tools/train_rmsnorm_phases.py            # from the root of a checkout
    python3 tools/train_rmsnorm_phases.py --quick    # phase 3's part and 18a only

A few minutes, the kernels' build included: a quick way to iterate on the
training path without the serving, DSE and validation phases.
"""
from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import json

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.kernels import _build

    quick = "--quick" in sys.argv[1:]
    t0 = time.perf_counter()
    card = cs.nvidia_smi("name,power.limit")
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    logs = _build.build_all(verbose=True)
    report = cs.ptxas_report(logs["rmsnorm"], cs.RMSNORM_BWD_ENTRY, cs.rmsnorm_bwd_label)
    print(f"rmsnorm backward build: {json.dumps(report)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = cs.Timer(torch)
    failed = []
    parts = [("phase 3 rmsnorm backward", lambda: cs.check_rmsnorm_bwd(torch, timer))]
    parts += [(f"phase 18a grads {arch}", lambda arch=arch: cs.say(
        f"{arch}: {cs.check_rmsnorm_grads(torch, kernels, arch)}"))
        for arch in ("mamba2_130m", "mistral_nemo_12b")]
    if not quick:
        parts += [(f"phase 18a SMOKE {arch}", lambda arch=arch: cs.say(
            f"{arch}: {cs.check_smoke_training(torch, arch, steps=1)}"))
            for arch in cs.RMSNORM_ARCHS]
        parts += [("phase 18b mamba2", lambda: cs.check_mamba2_training(torch, kernels)),
                  ("phase 18c mistral", lambda: cs.check_mistral_training(torch, kernels))]
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
    sys.exit(main())
