"""Training launcher of the port: synthetic tokens on one device or over
a (data, model) mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
      --steps 8 --batch 8 --seq 2048 --repeat
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_130m \\
      --steps 8 --batch 8 --seq 2048 --repeat
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

  # 8 ranks, one card each (NCCL), or on the CPU (gloo):
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch olmo_1b --smoke --steps 20 --mesh 2x4 --fsdp
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch olmo_1b --smoke --steps 20 --mesh 2x4 --fsdp --device cpu

:func:`run_train` is the importable body; ``main`` is the argparse shell,
with the reference's flags. Every architecture trains (``--arch``), on the
CUDA card unless ``device`` (``--device``) says otherwise: ``--device
cpu`` runs the kernels' plain versions. With ``mesh`` (``--mesh 2x4``,
data x model, or pod x data x model) the run joins the process group that
``torchrun`` (or ``torch.multiprocessing.spawn`` with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set) describes: NCCL on
card ``LOCAL_RANK``, gloo with ``--device cpu``; each rank holds its
blocks of the parameters (``--fsdp``: FSDP-sharded over the data axes too)
and takes its rows of the global batch, which every rank draws from the
same seed.
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
from ..parallel.logical import use_rules


@dataclasses.dataclass
class TrainResult:
    losses: list[float]
    step_times: list[float]      # seconds, host clock, each step synced
    tokens_per_s: float          # batch x seq over the mean step after the first
    peak_memory_bytes: int | None  # torch.cuda.max_memory_allocated; None on CPU
    n_params: int
    device: str
    mesh: dict | None = None     # axis -> size, where the run had a mesh


def run_train(cfg: ModelConfig, steps: int = 20, batch: int = 8,
              seq: int = 128, accum: int = 1, lr: float = 3e-4,
              seed: int = 0, device=None, ckpt_dir: str | None = None,
              ckpt_every: int = 0, repeat: bool = False, mesh=None,
              fsdp: bool = False,
              compress_dp_grads: bool = False) -> TrainResult:
    """Initialise params from ``seed`` (in ``cfg.param_dtype``), then take
    ``steps`` AdamW steps on synthetic tokens (numpy, ``seed``), with the
    image embeddings or audio frames the config's memory takes; with
    ``repeat`` every step sees the first batch (the loss must fall). Saves
    a checkpoint every ``ckpt_every`` steps (asynchronously) to
    ``ckpt_dir``. ``mesh``: a :class:`~repro_torch.parallel.dist.Mesh`, or
    a spec such as ``"2x4"`` over the process group (joined here if it is
    not yet); each rank then trains its blocks (``fsdp``, as
    ``make_train_step``) and the result's losses are the global ones."""
    if mesh is None:
        return _run(cfg, steps, batch, seq, accum, lr, seed,
                    resolve_device(device), ckpt_dir, ckpt_every, repeat,
                    None, fsdp, compress_dp_grads)
    from .mesh import init_ranks, make_axis_rules, parse_mesh
    if isinstance(mesh, str):
        dev = init_ranks(device or "cuda")
        mesh = parse_mesh(mesh, dev)
    else:
        dev = resolve_device(device)
    with use_rules(make_axis_rules(mesh, cfg), mesh):
        return _run(cfg, steps, batch, seq, accum, lr, seed, dev, ckpt_dir,
                    ckpt_every, repeat, mesh, fsdp, compress_dp_grads)


def _run(cfg, steps, batch, seq, accum, lr, seed, device, ckpt_dir,
         ckpt_every, repeat, mesh, fsdp, compress_dp_grads) -> TrainResult:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    master = cfg.param_dtype == "bfloat16"
    params = init_params(cfg, seed=seed, device=device,
                         dtype=param_dtype(cfg))
    n_params = param_count(params)
    if mesh is not None:
        from .shardings import opt_shardings, param_shardings, shard_tree
        params = shard_tree(params, param_shardings(cfg, mesh, fsdp), mesh,
                            copy=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    opt = adamw_init(params, master=master)
    step_fn = make_train_step(cfg, AdamWConfig(lr=lr), accum=accum,
                              compress_dp_grads=compress_dp_grads, fsdp=fsdp)
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
    where = "" if mesh is None else f", mesh {mesh.sizes}" + (
        " fsdp" if fsdp else "")
    say = print if mesh is None or torch.distributed.get_rank() == 0 else \
        (lambda *a, **k: None)
    say(f"{cfg.name}: {n_params:,} params on {device}{where}, "
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
            say(f"step {step:4d}  loss {loss:7.4f}  grad_norm "
                  f"{float(metrics['grad_norm']):8.4f}  {dt * 1e3:8.1f} ms")
        if mgr and (step + 1) % ckpt_every == 0:
            tree = {"params": params, "opt": opt}
            if mesh is not None:     # the checkpoint holds whole arrays
                from .shardings import gather_tree
                tree = gather_tree(tree, {
                    "params": param_shardings(cfg, mesh, fsdp),
                    "opt": opt_shardings(cfg, mesh, fsdp, master)}, mesh)
            if mesh is None or torch.distributed.get_rank() == 0:
                mgr.save_async(step + 1, tree)
    if mgr:
        mgr.wait()
    steady = times[1:] or times
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return TrainResult(losses=losses, step_times=times,
                       tokens_per_s=batch * seq * len(steady) / sum(steady),
                       peak_memory_bytes=peak, n_params=n_params,
                       device=str(device),
                       mesh=None if mesh is None else mesh.sizes)


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
    ap.add_argument("--mesh", help="e.g. 2x4 (data x model), over the ranks "
                    "torchrun starts")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", help="default: the CUDA card")
    args = ap.parse_args()
    if args.fsdp and not args.mesh:
        ap.error("--fsdp shards over a mesh: give --mesh")
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.bf16_params:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    res = run_train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                    accum=args.accum, lr=args.lr, seed=args.seed,
                    device=args.device, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, repeat=args.repeat,
                    mesh=args.mesh, fsdp=args.fsdp)
    peak = ("" if res.peak_memory_bytes is None
            else f", peak memory {res.peak_memory_bytes / 2**30:.2f} GiB")
    if not args.mesh or torch.distributed.get_rank() == 0:
        print(f"done: {res.tokens_per_s:.1f} tokens/s{peak}")
    if args.mesh:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
