"""Run the parts of ``chip_smoke.py`` that the model axis of every layer
kind reaches, alone on one card: the RMSNorm build report (registers and
spills of every instantiation, the split-row launches' kernels too), phase
3's RMSNorm checks (the one-launch norm, its backward, and the gated norm
over split rows: each statistic and apply launch against its plain
version, the blocks put together against the one-launch norm), then phase
21 (mamba2_130m, llama32_vision_11b and seamless_m4t_medium served on two
gloo ranks sharing the card, mesh (1, 2), and a mamba2_130m train step,
each against one device). Each part's failure is printed and the next
part still runs; the exit code is 1 if any failed.

    python3 tools/model_axis_phases.py      # from the root of a checkout

A few minutes, the kernels' build included.
"""
from __future__ import annotations

import json
import sys
import tempfile
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
    import chip_smoke as cs
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    card = cs.nvidia_smi("name,power.limit")
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    started = cs.probe_build_start()
    logs = _build.build_all(verbose=True)
    probe = cs.probe_build_finish(started)
    for lib, entry, label in (("rmsnorm", cs.RMSNORM_ENTRY, cs.rmsnorm_label),
                              ("rmsnorm", cs.RMSNORM_BWD_ENTRY, cs.rmsnorm_bwd_label),
                              ("rmsnorm_split", cs.RMSNORM_SPLIT_ENTRY, cs.rmsnorm_split_label)):
        print(f"{lib} build: {json.dumps(cs.ptxas_report(logs[lib], entry, label))}",
              flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch)
    failed = []
    parts = (("phase 3 split-row norm", lambda: cs.check_rmsnorm_split(torch, timer)),
             ("phase 3 rmsnorm", lambda: cs.check_rmsnorm(torch, timer, probe)),
             ("phase 3 rmsnorm backward", lambda: cs.check_rmsnorm_bwd(torch, timer)),
             ("phase 21", lambda: cs.phase21(
                 torch, Path(tempfile.mkdtemp(prefix="phase21-")), card)))
    for name, run in parts:
        t1 = time.perf_counter()
        try:
            out = run()
            if name == "phase 3 split-row norm":
                print(json.dumps({k: {x: v[x] for x in ("ms", "plain_ms", "bound_ms")}
                                  for k, v in out.items()}), flush=True)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        torch.cuda.empty_cache()
        print(f"{name} in {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s; failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
