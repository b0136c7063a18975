"""Run phases 10-13 of ``chip_smoke.py`` alone on the card: OLMoE-1B-7B
serving at full width (10-11), the validation loop (12, which writes
BENCH_validation_torch.json) and the serving-model reading for OLMoE (13).
Each phase's failure is printed and the next phase still runs; the exit
code is 1 if any failed.

    python3 tools/moe_validation_phases.py      # from the root of a checkout

About a minute, the kernels' build included: a quick way to iterate on
the MoE layers or the validation loop without the other phases.
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
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    card = cs.nvidia_smi("name,power.limit")
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    failed, measured = [], {}
    cfg = get_config("olmoe_1b_7b")
    phases = (
        ("olmoe serving", lambda: measured.__setitem__(
            "olmoe_1b_7b", cs.check_serving(torch, kernels, "olmoe_1b_7b", cs.REQUESTS, {
                "flash_attention": cfg.n_layers,
                "decode_attention": cfg.n_layers * (cs.NEW_TOKENS - 1),
                "rmsnorm": (1 + 2 * cfg.n_layers) * cs.NEW_TOKENS}, phase=10)[1])),
        ("validation", lambda: cs.check_validation(card)),
        ("serving model", lambda: cs.serving_model_reading(measured)))
    for name, run in phases:
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
