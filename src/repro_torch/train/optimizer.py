"""AdamW and schedules on parameter trees (the reference's
``train/optimizer.py``), as plain tensor functions.

Not ``torch.optim.AdamW``: the reference clips by the global norm with an
epsilon of 1e-9 and applies decoupled weight decay inside the update, to
every leaf (the embedding included); this module follows it term for term.

A tree is a nest of dicts and lists with tensors at the leaves, as the
model's parameters are. Unlike the reference, :func:`adamw_update` updates
the parameters and the moments in place (it returns the same objects): at
0.9 B parameters each f32 copy is 3.6 GB, and a functional update would
hold a second copy of each tree at its peak.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


# ------------------------------- trees -----------------------------------------
def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree, in a fixed order (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [x for v in tree for x in tree_leaves(v)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]


def tree_unflatten(tree, leaves: list):
    """A tree of ``tree``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return [build(v) for v in t]
    return build(tree)


# ------------------------------- AdamW -----------------------------------------
def adamw_init(params, master: bool = False) -> dict:
    """{"m", "v", "step"}: the moments f32 whatever the params' dtype (the
    reference's bf16 moments become f32 at its first update, where the f32
    gradient promotes them); with ``master`` (mixed precision) an f32
    ``master`` copy of the weights is kept too. ``step`` is a 0-d int64
    tensor on the CPU."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    with torch.no_grad():
        out = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
               "step": torch.zeros((), dtype=torch.int64)}
        if master:
            out["master"] = tree_map(lambda p: p.detach().float().clone(),
                                     params)
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32) for x in leaves]
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale: float | torch.Tensor = 1.0,
                 gnorm: torch.Tensor | None = None):
    """One AdamW step with global-norm clipping, in place. Returns
    (params, state), the objects passed in.

    With a ``master`` tree in ``state`` the update goes to the f32 master
    weights and the live params are re-cast from them. ``gnorm`` is the
    gradients' global norm where the trees are one rank's blocks of a
    sharded whole (the trainer's, over a mesh); default: their own norm."""
    step = int(state["step"]) + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1.0 - cfg.b1 ** step
    bc2 = 1.0 - cfg.b2 ** step
    lr = cfg.lr * lr_scale
    targets = tree_leaves(state.get("master", params))
    for p, g, m, v, t in zip(tree_leaves(params), tree_leaves(grads),
                             tree_leaves(state["m"]), tree_leaves(state["v"]),
                             targets):
        gf = g.float() * clip.to(g.device)
        m.mul_(cfg.b1).add_(gf, alpha=1.0 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(gf, gf, value=1.0 - cfg.b2)
        del gf
        tf = t.float()
        upd = (m / bc1) / ((v / bc2).sqrt_().add_(cfg.eps))
        upd.add_(tf, alpha=cfg.weight_decay)
        t.copy_(tf - lr * upd)
        if t is not p:
            p.copy_(t)
    state["step"] = torch.tensor(step, dtype=torch.int64)
    return params, state


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[int], float]:
    """Linear warm-up to 1, then a cosine to 0 at ``total``: a multiplier
    of the optimizer's lr (``base_lr`` is not applied, as in the
    reference)."""
    def fn(step) -> float:
        step = float(step)
        if step < warmup:
            return step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return 0.5 * (1 + math.cos(math.pi * prog))
    return fn
