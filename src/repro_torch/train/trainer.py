"""Training step and loop (the reference's ``train/trainer.py``): gradient
accumulation, compressed data-parallel gradients, checkpointing, straggler
accounting.

The step runs eagerly: ``loss_fn`` forward, ``torch.autograd.grad`` for the
gradients, then :func:`adamw_update` in place. Every architecture of the
reference trains: the attention differentiates through
``flash_attention_train`` (the forward with LSE, then the dK/dV and dQ
kernels), the fused RMSNorm through its backward kernel
(``fused_rmsnorm_bwd``) and the SSD scan through its plain backward
(``ssd_chunk_bwd_plain``); each layer is rematerialised as ``cfg.remat``
says.

Over a mesh (the step made and called inside ``use_rules(rules, mesh)``,
as the reference's launcher jits it with the mesh's shardings), each rank
holds its blocks of the parameters and optimizer state
(``launch/shardings.param_shardings(cfg, mesh, fsdp)``), takes its rows of
the global batch it is given, and sums its gradients, weighted by its share
of the tokens, over the data axes; the model axis' collectives are in the
layers. With ``fsdp`` (ZeRO-3) the parameters, moments and master weights
live sharded along ``_fsdp_spec``'s dim over the data axes too: the step
gathers each such leaf once per step, the gradients are reduce-scattered
back to the shards, and each rank updates its own. The global gradient
norm that clipping reads is summed over the ranks, each leaf counted once.
"""
from __future__ import annotations

import math
import time
from typing import Callable

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.transformer import check_supported, loss_fn
from ..parallel import dist as pd
from ..parallel.compression import dequantize_int8, quantize_int8
from ..parallel.logical import PartitionSpec, current_mesh, current_rules
from .optimizer import (AdamWConfig, adamw_init, adamw_update, global_norm,
                        tree_leaves, tree_unflatten)


def _grads(cfg: ModelConfig, params: dict, leaves: list, batch: dict):
    loss = loss_fn(cfg, params, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _loss_and_grads(cfg: ModelConfig, params: dict, leaves: list, batch: dict,
                    accum: int):
    """(loss, grads of ``leaves``): one pass, or ``accum`` microbatches
    along dim 0 whose f32 gradients are summed and divided by ``accum``."""
    if accum == 1:
        return _grads(cfg, params, leaves, batch)
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
    return loss / accum, [g.div_(accum) for g in grads]


def _int8_round_trip(g: torch.Tensor) -> torch.Tensor:
    """The compressed data-parallel all-reduce's payload: ``g`` through
    int8 and back (``parallel/compression.py``)."""
    return dequantize_int8(*quantize_int8(g))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    accum: int = 1, schedule: Callable | None = None,
                    compress_dp_grads: bool = False, fsdp: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating params and opt_state in place.

    ``accum`` > 1 splits the batch into microbatches along dim 0 and sums
    their gradients in f32, then divides by ``accum``. ``schedule(step)``
    scales the lr and reads the step before its increment.
    ``compress_dp_grads`` sends every gradient through int8 and back before
    the data-parallel sum (on one device: the round trip alone, as the
    reference). ``fsdp``: over a mesh, the parameters are FSDP-sharded (see
    the module). metrics: ``loss`` and ``grad_norm`` (before clipping), 0-d
    f32 tensors."""
    check_supported(cfg)
    opt_cfg = opt_cfg or AdamWConfig()
    schedule = schedule or (lambda s: 1.0)
    layouts: dict = {}

    def train_step(params, opt_state, batch):
        mesh = current_mesh() if current_rules() is not None else None
        if mesh is not None:
            if id(mesh) not in layouts:
                layouts[id(mesh)] = _MeshLayout(cfg, mesh, fsdp)
            return layouts[id(mesh)].step(params, opt_state, batch, accum,
                                          compress_dp_grads, opt_cfg, schedule)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, grads = _loss_and_grads(cfg, params, leaves, batch, accum)
        for p in leaves:
            p.requires_grad_(False)
        if compress_dp_grads:
            grads = [_int8_round_trip(g) for g in grads]
        grads = tree_unflatten(params, list(grads))
        lr_scale = schedule(int(opt_state["step"]))
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        adamw_update(params, grads, opt_state, opt_cfg, lr_scale)
        return params, opt_state, metrics

    return train_step


def _spec_leaves(specs) -> list:
    """The PartitionSpecs of a spec tree in :func:`tree_leaves` order."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [x for v in specs for x in _spec_leaves(v)]


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class _MeshLayout:
    """What a step over one mesh needs to know of every leaf: its spec, its
    FSDP dim, the ranks that hold a copy of it, and whether its gradient is
    a partial sum over 'model'."""

    def __init__(self, cfg: ModelConfig, mesh, fsdp: bool):
        from ..launch.mesh import batch_axes
        from ..launch.shardings import batch_shardings, param_shardings
        self.cfg, self.mesh = cfg, mesh
        self.specs = param_shardings(cfg, mesh, fsdp=fsdp, rules=current_rules())
        self.leaf_specs = _spec_leaves(self.specs)
        self.data = batch_axes(mesh)
        self.data_axes = _axes(self.data)
        self.n_data = mesh.size(self.data)
        self.dgroup = mesh.group(self.data) if self.n_data > 1 else None
        self.mgroup = mesh.group("model") if mesh.size("model") > 1 else None
        self.fsdp_dims = [next((i for i, e in enumerate(sp)
                                if e is not None and _axes(e) == self.data_axes),
                               None) for sp in self.leaf_specs]
        world = math.prod(mesh.shape)
        self.copies = [world // mesh.size(tuple(a for e in sp for a in _axes(e)))
                       for sp in self.leaf_specs]
        self.batch_shardings = batch_shardings

    def _model_partial(self, params: dict) -> list[bool]:
        """Per leaf: whether its gradient on a rank is that rank's share of
        a sum over 'model': the MoE router where the experts are split."""
        cfg = self.cfg
        marks = []

        def walk(node):
            items = sorted(node.items()) if isinstance(node, dict) else \
                list(enumerate(node))
            for k, v in items:
                if isinstance(v, torch.Tensor):
                    marks.append(self.mgroup is not None and k == "router"
                                 and node["wi"].shape[0] != cfg.moe_experts)
                else:
                    walk(v)
        walk(params)
        return marks

    def _local_batch(self, batch: dict) -> dict:
        from ..launch.shardings import shard_tree
        n = next(iter(batch.values())).shape[0]
        specs = self.batch_shardings(self.cfg, self.mesh, n)
        specs = {k: specs.get(k, specs["tokens"]) for k in batch}
        return shard_tree(batch, specs, self.mesh)

    def step(self, params, opt_state, batch, accum, compress, opt_cfg,
             schedule):
        leaves = tree_leaves(params)
        used = []
        for p, dim in zip(leaves, self.fsdp_dims):
            if dim is None:
                used.append(p.requires_grad_(True))
            else:
                used.append(pd.all_gather(p.detach(), dim, self.dgroup)
                            .requires_grad_(True))
        whole = tree_unflatten(params, used)
        local = self._local_batch(batch)
        mask = local.get("mask")
        count = (torch.ones_like(local["labels"], dtype=torch.float32).sum()
                 if mask is None else mask.float().sum().clamp_min(1.0))
        share = count / pd.all_reduce(count, self.dgroup)     # on the device
        loss, grads = _loss_and_grads(self.cfg, whole, used, local, accum)
        for p in leaves:
            p.requires_grad_(False)
        loss = pd.all_reduce(loss * share, self.dgroup)
        out = []
        for g, dim, part in zip(grads, self.fsdp_dims, self._model_partial(whole)):
            if compress:
                g = _int8_round_trip(g)
            g = g * share
            g = (pd.all_reduce(g, self.dgroup) if dim is None
                 else pd.reduce_scatter(g, dim, self.dgroup))
            if part:
                g = pd.all_reduce(g, self.mgroup)
            out.append(g)
        gnorm = self._global_norm(out)
        grads = tree_unflatten(params, out)
        lr_scale = schedule(int(opt_state["step"]))
        adamw_update(params, grads, opt_state, opt_cfg, lr_scale, gnorm=gnorm)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    def _global_norm(self, grads: list) -> torch.Tensor:
        """sqrt of the sum of squares of the whole gradient: each rank's
        blocks, each divided by the number of ranks holding a copy, summed
        over the world."""
        sq = sum(torch.linalg.vector_norm(g, dtype=torch.float32).square() / c
                 for g, c in zip(grads, self.copies))
        if math.prod(self.mesh.shape) > 1:
            sq = pd.all_reduce(sq, dist.group.WORLD)
        return sq.sqrt()


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
