"""Training step and loop (the reference's ``train/trainer.py``): gradient
accumulation, checkpointing, straggler accounting.

The step runs eagerly: ``loss_fn`` forward, ``torch.autograd.grad`` for the
gradients, then :func:`adamw_update` in place. Every architecture of the
reference trains: the attention differentiates through
``flash_attention_train`` (the forward with LSE, then the dK/dV and dQ
kernels), the fused RMSNorm through its backward kernel
(``fused_rmsnorm_bwd``) and the SSD scan through its plain backward
(``ssd_chunk_bwd_plain``); each layer is rematerialised as ``cfg.remat``
says. What needs a device mesh (``compress_dp_grads``, the expert-parallel
``moe_dispatch="shard_map"``) raises.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from ..models.config import ModelConfig
from ..models.transformer import check_supported, loss_fn
from .optimizer import (AdamWConfig, adamw_init, adamw_update, global_norm,
                        tree_leaves, tree_unflatten)


def _grads(cfg: ModelConfig, params: dict, leaves: list, batch: dict):
    loss = loss_fn(cfg, params, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    accum: int = 1, schedule: Callable | None = None,
                    compress_dp_grads: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating params and opt_state in place.

    ``accum`` > 1 splits the batch into microbatches along dim 0 and sums
    their gradients in f32, then divides by ``accum``. ``schedule(step)``
    scales the lr and reads the step before its increment. metrics:
    ``loss`` and ``grad_norm`` (before clipping), 0-d f32 tensors."""
    check_supported(cfg)
    if compress_dp_grads:
        raise NotImplementedError(
            "compressed data-parallel gradients wait for the multi-device "
            "layer (ROADMAP.md queue 1 item 9)")
    opt_cfg = opt_cfg or AdamWConfig()
    schedule = schedule or (lambda s: 1.0)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if accum == 1:
            loss, grads = _grads(cfg, params, leaves, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum:
                raise ValueError(f"batch {n} not divisible by accum {accum}")
            loss = torch.zeros((), dtype=torch.float32)
            grads = None
            for i in range(accum):
                mb = {k: v[i * n // accum:(i + 1) * n // accum]
                      for k, v in batch.items()}
                mloss, g = _grads(cfg, params, leaves, mb)
                loss = loss.to(mloss.device) + mloss.float()
                g = [x.float() for x in g]
                grads = g if grads is None else [
                    a.add_(b) for a, b in zip(grads, g)]
            loss = loss / accum
            grads = [g.div_(accum) for g in grads]
        for p in leaves:
            p.requires_grad_(False)
        grads = tree_unflatten(params, list(grads))
        lr_scale = schedule(int(opt_state["step"]))
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        adamw_update(params, grads, opt_state, opt_cfg, lr_scale)
        return params, opt_state, metrics

    return train_step


def train_loop(cfg: ModelConfig, params, data_iter, steps: int,
               opt_cfg: AdamWConfig | None = None, accum: int = 1,
               checkpoint_manager=None, checkpoint_every: int = 0,
               straggler_monitor=None, log_every: int = 10,
               start_step: int = 0):
    """Synchronous training loop with checkpointing and straggler
    accounting. Returns (params, opt_state, loss history)."""
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg, accum)
    history = []
    for step in range(start_step, steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])           # waits for the device
        dt = time.perf_counter() - t0
        if straggler_monitor is not None:
            straggler_monitor.record(step, dt)
        history.append(loss)
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} ({dt * 1e3:.1f} ms)")
        if checkpoint_manager is not None and checkpoint_every \
                and (step + 1) % checkpoint_every == 0:
            checkpoint_manager.save(step + 1,
                                    {"params": params, "opt": opt_state})
    return params, opt_state, history
