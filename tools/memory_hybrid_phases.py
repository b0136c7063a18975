"""Run the parts of ``chip_smoke.py`` that cross-attention memory, the
encoder and Jamba's hybrid blocks reach, alone on the card: phase 3's
attention, SSD and RMSNorm checks (with the cross-attention, encoder,
Jamba scan and Jamba gated-norm shapes among them), then phases 14-17
(llama32_vision_11b, seamless_m4t_medium, jamba_v01_52b cut to
``chip_smoke.JAMBA_LAYERS`` layers, speculative decoding). Each part's
failure is printed and the next part still runs; the exit code is 1 if
any failed.

    python3 tools/memory_hybrid_phases.py      # from the root of a checkout

A few minutes, the kernels' build included: a quick way to iterate on
these paths without the DSE, training and MoE phases.
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
    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    card = cs.nvidia_smi("name,power.limit")
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    started = cs.probe_build_start()
    _build.build_all()
    probe = cs.probe_build_finish(started)
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch)
    failed = []
    parts = (("phase 3 attention", lambda: cs.check_kernels(torch, timer)),
             ("phase 3 ssd", lambda: cs.check_ssd(torch, timer)),
             ("phase 3 rmsnorm", lambda: cs.check_rmsnorm(torch, timer, probe)),
             *((path, lambda fn=fn: fn(torch, kernels)) for path, fn in cs.NEW_PATHS))
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
