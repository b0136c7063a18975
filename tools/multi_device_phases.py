"""Run the multi-device parts of ``chip_smoke.py`` alone on the card: phase
3's attention checks (decode attention with the context-parallel blocks
of CP_DECODE_CASES among them) and phase 20 (one NCCL rank training on
the (1, 1) mesh with FSDP, OLMoE-1B-7B on two gloo ranks sharing the card,
data-parallel steps on two). Each part's failure is printed and the next
still runs; the exit code is 1 if any failed.

    python3 tools/multi_device_phases.py          # from the root of a checkout
    python3 tools/multi_device_phases.py --nccl   # phase 20's two-rank parts
                                                  # alone over NCCL, a card a rank

A few minutes, the kernels' build included: a quick way to iterate on
``parallel/`` and ``launch/`` without the other phases. ``--nccl`` needs
two cards or more: after two NCCL ranks have summed one tensor, it runs
(c), then (b), over NCCL, which reaches the NCCL branches of the gather
and the reduce-scatter (FSDP), as two gloo ranks sharing one card do not.
"""
from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: two NCCL ranks, a card each, sum one tensor (argv: rank, store directory)
PROBE = """
import sys, torch, torch.distributed as dist
from pathlib import Path
import chip_smoke as cs
rank = int(sys.argv[1])
dev = cs.phase20_join(Path(sys.argv[2]), "probe", rank, 2, "nccl")
x = torch.full((4,), rank + 1.0, device=dev)
dist.all_reduce(x)
dist.destroy_process_group()
print("sum", x.tolist(), "on", dev)
sys.exit(0 if x.tolist() == [3.0] * 4 else 1)
"""


def nccl_probe(job_dir: Path) -> bool:
    """Whether two NCCL ranks connect and sum within 90 s (NCCL's own log
    printed), before the parts that would wait on them much longer."""
    import os
    import subprocess
    env = dict(os.environ, NCCL_DEBUG="WARN",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    procs = [subprocess.Popen([sys.executable, "-c", PROBE, str(r), str(job_dir)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    ok = True
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=90)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
        ok = ok and p.returncode == 0
        print(f"[nccl probe rank {r}, exit {p.returncode}]\n{out[-3000:]}", flush=True)
    return ok


def main() -> int:
    import torch

    nccl = sys.argv[1:] == ["--nccl"]
    if torch.cuda.device_count() < (2 if nccl else 1):
        print(f"needs {2 if nccl else 1} CUDA card(s)", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    card = cs.nvidia_smi("name,power.limit")
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    failed = []
    if nccl:
        import tempfile
        job_dir = Path(tempfile.mkdtemp(prefix="phase20-nccl-"))
        if not nccl_probe(job_dir):
            print("two NCCL ranks did not sum; phase 20 over NCCL not run")
            return 1
        parts = (("phase 20c over NCCL", lambda: cs.phase20_c(job_dir, "nccl")),
                 ("phase 20b over NCCL", lambda: cs.phase20_b(torch, job_dir, "nccl")))
    else:
        parts = (("phase 3 attention", lambda: cs.check_kernels(torch, cs.Timer(torch))),
                 ("phase 20", lambda: cs.check_multi_device(torch, card)))
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
