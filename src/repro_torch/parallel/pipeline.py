"""Pipeline parallelism (the reference's ``parallel/pipeline.py``): the
GPipe schedule over a 'stage' axis, activations passed point to point.

Each rank along the axis owns one stage's layers, and microbatches flow
from stage to stage: n_micro + n_stages - 1 ticks; at tick t, stage s
works on microbatch t - s where that is one, receiving its input from
stage s - 1 and sending its output to stage s + 1 (``batch_isend_irecv``).
The bubble fraction (n_stages - 1) / ticks is the term DFModel's iteration
model charges (core/interchip.py). The last stage's outputs reach every
rank of the axis (a broadcast), as the reference's final sum does.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .dist import broadcast


def pipeline_forward(mesh, stage_fn: Callable, n_stages: int,
                     axis: str = "stage"):
    """Build fn(stage_params, x_micro) -> y_micro running the GPipe
    schedule.

    stage_params: a tree whose leaves have a leading (n_stages, ...) dim;
    each rank takes its stage's slice. x_micro: (n_micro, mb, ...), the
    same on every rank. ``stage_fn(params_slice, x) -> y`` keeps x's shape
    (a transformer trunk's d_model in and out)."""
    if mesh.size(axis) != n_stages:
        raise ValueError(f"{n_stages} stages on an axis of {mesh.size(axis)}")
    group = mesh.group(axis)
    sidx = mesh.index(axis)

    def run(params, xs):
        mine = _slice(params, sidx)
        n_micro = xs.shape[0]
        outs = torch.zeros_like(xs)
        prev = dist.get_global_rank(group, sidx - 1) if sidx else None
        nxt = dist.get_global_rank(group, sidx + 1) if sidx < n_stages - 1 else None
        for t in range(n_micro + n_stages - 1):
            mb = t - sidx
            if not 0 <= mb < n_micro:
                continue
            if prev is None:
                x = xs[mb]
            else:
                x = torch.empty_like(xs[0])
                for w in dist.batch_isend_irecv(
                        [dist.P2POp(dist.irecv, x, prev, group)]):
                    w.wait()
            y = stage_fn(mine, x)
            if nxt is None:
                outs[mb] = y
            else:
                for w in dist.batch_isend_irecv(
                        [dist.P2POp(dist.isend, y.contiguous(), nxt, group)]):
                    w.wait()
        return broadcast(outs, n_stages - 1, group)

    return run


def _slice(tree, i: int):
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return [_slice(v, i) for v in tree]
