"""Training launcher of the port: one device, synthetic tokens.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
      --steps 8 --batch 8 --seq 2048 --repeat
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_130m \\
      --steps 8 --batch 8 --seq 2048 --repeat
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

:func:`run_train` is the importable body; ``main`` is the argparse shell,
with the reference's flags (``--mesh`` and ``--fsdp`` wait for the
multi-device layer). Every architecture trains (``--arch``), on the
CUDA card unless ``device`` (``--device``) says otherwise: ``--device
cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..configs import ARCH_IDS, get_config
from ..device import resolve_device, synchronize
from ..models import init_params, param_count, param_dtype
from ..models.config import ModelConfig
from ..train.checkpoint import CheckpointManager
from ..train.data import SyntheticTokens
from ..train.fault import StragglerMonitor
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.trainer import make_train_step


@dataclasses.dataclass
class TrainResult:
    losses: list[float]
    step_times: list[float]      # seconds, host clock, each step synced
    tokens_per_s: float          # batch x seq over the mean step after the first
    peak_memory_bytes: int | None  # torch.cuda.max_memory_allocated; None on CPU
    n_params: int
    device: str


def run_train(cfg: ModelConfig, steps: int = 20, batch: int = 8,
              seq: int = 128, accum: int = 1, lr: float = 3e-4,
              seed: int = 0, device=None, ckpt_dir: str | None = None,
              ckpt_every: int = 0, repeat: bool = False) -> TrainResult:
    """Initialise params from ``seed`` (in ``cfg.param_dtype``), then take
    ``steps`` AdamW steps on synthetic tokens (numpy, ``seed``), with the
    image embeddings or audio frames the config's memory takes; with
    ``repeat`` every step sees the first batch (the loss must fall). Saves
    a checkpoint every ``ckpt_every`` steps (asynchronously) to
    ``ckpt_dir``."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = init_params(cfg, seed=seed, device=device,
                         dtype=param_dtype(cfg))
    opt = adamw_init(params, master=cfg.param_dtype == "bfloat16")
    step_fn = make_train_step(cfg, AdamWConfig(lr=lr), accum=accum)
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = (cfg.n_image_tokens, cfg.d_model)
    if cfg.is_enc_dec:
        extras["audio_frames"] = (cfg.n_audio_frames, cfg.d_model)
    data = iter(SyntheticTokens(cfg.vocab, batch, seq, seed=seed,
                                device=device, extras=extras))
    first = next(data)
    mgr = None
    if ckpt_every:
        mgr = CheckpointManager(ckpt_dir or os.path.join(
            tempfile.gettempdir(), "repro_torch_launch_train"))
    mon = StragglerMonitor()
    losses, times = [], []
    print(f"{cfg.name}: {param_count(params):,} params on {device}, "
          f"{batch} x {seq} tokens per step, accum {accum}")
    for step in range(steps):
        b = first if repeat or step == 0 else next(data)
        synchronize(device)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        mon.record(step, dt)
        losses.append(loss)
        times.append(dt)
        if step % 5 == 0 or step == steps - 1:
            print(f"step {step:4d}  loss {loss:7.4f}  grad_norm "
                  f"{float(metrics['grad_norm']):8.4f}  {dt * 1e3:8.1f} ms")
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt})
    if mgr:
        mgr.wait()
    steady = times[1:] or times
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return TrainResult(losses=losses, step_times=times,
                       tokens_per_s=batch * seq * len(steady) / sum(steady),
                       peak_memory_bytes=peak, n_params=param_count(params),
                       device=str(device))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmo_1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", action="store_true",
                    help="train on the first batch at every step")
    ap.add_argument("--mesh", help="multi-device mesh (not ported)")
    ap.add_argument("--fsdp", action="store_true", help="(not ported)")
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", help="default: the CUDA card")
    args = ap.parse_args()
    if args.mesh or args.fsdp:
        raise NotImplementedError(
            "--mesh and --fsdp wait for the multi-device layer "
            "(ROADMAP.md queue 1 item 9)")
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.bf16_params:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    res = run_train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                    accum=args.accum, lr=args.lr, seed=args.seed,
                    device=args.device, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, repeat=args.repeat)
    peak = ("" if res.peak_memory_bytes is None
            else f", peak memory {res.peak_memory_bytes / 2**30:.2f} GiB")
    print(f"done: {res.tokens_per_s:.1f} tokens/s{peak}")


if __name__ == "__main__":
    main()
