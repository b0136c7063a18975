"""Sharding assembly (the reference's ``launch/shardings.py``): the
PartitionSpec of every leaf of the parameters, optimizer state, batch and
decode cache for a (config, mesh).

Each function returns a tree of the port's structure with a
:class:`~repro_torch.parallel.logical.PartitionSpec` at every leaf. The
port's ``stack`` is a list of block dictionaries where the reference stacks
each leaf over a leading (n_blocks,) dim, so the reference's leading None
of a stacked leaf falls away and the remaining entries are the reference's;
one difference remains by design: FSDP (:func:`_fsdp_spec`) picks the
largest dim that the data axes divide, and where the reference's stacking
dim ties with a leaf's largest dim (first wins) it shards the stack, which a
list cannot be; the port shards that leaf's own largest dim. Shapes come
from ``init_params`` / ``init_cache`` on the meta device: nothing is
allocated. :func:`local_shard` cuts this rank's block of a whole tensor by
its spec.
"""
from __future__ import annotations

import torch

from ..models import init_cache, init_params
from ..models.config import ModelConfig
from ..models.transformer import param_dtype
from ..parallel.logical import P, PartitionSpec, param_spec
from .mesh import batch_axes, make_axis_rules, mesh_sizes, safe_spec


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    return [_map(fn, v, path + (str(i),)) for i, v in enumerate(tree)]


def _fsdp_spec(spec: PartitionSpec, shape: tuple[int, ...], mesh) -> PartitionSpec:
    """ZeRO/FSDP: also shard a parameter over the data axes, along its
    largest dim not yet sharded that the data axes' size divides (the first
    of equals). Leaves with no such dim stay as they were."""
    ba = batch_axes(mesh)
    axes = ba if isinstance(ba, tuple) else (ba,)
    sizes = mesh_sizes(mesh)
    fsdp_size = 1
    for a in axes:
        fsdp_size *= sizes[a]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    cands = [i for i, (dim, ax) in enumerate(zip(shape, entries))
             if ax is None and dim % fsdp_size == 0]
    if not cands:
        return spec
    best = max(cands, key=lambda i: shape[i])
    entries[best] = ba
    return P(*entries)


def param_shardings(cfg: ModelConfig, mesh, fsdp: bool = False):
    """Spec tree matching ``init_params(cfg)``."""
    rules = make_axis_rules(mesh)
    sizes = mesh_sizes(mesh)
    shapes = init_params(cfg, device="meta", dtype=param_dtype(cfg))

    def one(path, leaf):
        spec = param_spec(path[-1:], tuple(leaf.shape), rules, sizes)
        if fsdp:
            spec = _fsdp_spec(spec, tuple(leaf.shape), mesh)
        return safe_spec(tuple(leaf.shape), spec, mesh)

    return _map(one, shapes)


def opt_shardings(cfg: ModelConfig, mesh, fsdp: bool = False,
                  master: bool = False) -> dict:
    ps = param_shardings(cfg, mesh, fsdp=fsdp)
    out = {"m": ps, "v": ps, "step": P()}
    if master:   # mixed precision: f32 master weights, sharded like params
        out["master"] = ps
    return out


def batch_shardings(cfg: ModelConfig, mesh, batch: int) -> dict:
    ba = batch_axes(mesh)
    bspec = safe_spec((batch, 1), P(ba, None), mesh)
    out = {"tokens": bspec, "labels": bspec}
    if cfg.family == "vlm":
        out["image_embeds"] = safe_spec((batch, 1, 1), P(ba, None, None), mesh)
    if cfg.is_enc_dec:
        out["audio_frames"] = safe_spec((batch, 1, 1), P(ba, None, None), mesh)
    return out


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int) -> dict:
    """Decode cache: the KV sequence dim on 'model' (context parallelism),
    the batch on the data axes; SSM state heads on 'model'."""
    ba = batch_axes(mesh)
    shapes = init_cache(cfg, batch, max_len, device="meta")
    specs = {}
    if "k" in shapes:
        spec = safe_spec(tuple(shapes["k"].shape),
                         P(None, None, ba, "model", None, None), mesh)
        specs["k"] = specs["v"] = spec
    if "ssm" in shapes:
        specs["ssm"] = safe_spec(tuple(shapes["ssm"].shape),
                                 P(None, None, ba, "model", None, None), mesh)
        specs["conv"] = safe_spec(tuple(shapes["conv"].shape),
                                  P(None, None, ba, None, "model"), mesh)
    return specs


def decode_input_shardings(cfg: ModelConfig, mesh, batch: int,
                           max_len: int) -> dict:
    ba = batch_axes(mesh)
    out = {"token": safe_spec((batch,), P(ba), mesh), "pos": P(),
           "cache": cache_shardings(cfg, mesh, batch, max_len)}
    if cfg.family == "vlm" or cfg.is_enc_dec:
        out["memory"] = safe_spec((batch, 1, 1), P(ba, None, None), mesh)
    return out


# ------------------------------- local blocks --------------------------------
def local_shard(x, spec: PartitionSpec, mesh):
    """This rank's block of the whole tensor (or numpy array) ``x`` under
    ``spec``: each sharded dim cut into the axes' size and this rank's
    place along them taken (a view where it can be)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.size(ax)
        blk = x.shape[dim] // n
        i = mesh.index(ax)
        x = x[(slice(None),) * dim + (slice(i * blk, (i + 1) * blk),)]
    return x


def shard_tree(tree, specs, mesh, copy: bool = False):
    """:func:`local_shard` over a tree and its spec tree; with ``copy``
    each block is a contiguous copy of its own (the whole can be freed)."""
    if isinstance(specs, PartitionSpec):
        x = local_shard(tree, specs, mesh)
        return x.clone(memory_format=torch.contiguous_format) if copy else x
    if isinstance(specs, dict):
        return {k: shard_tree(tree[k], specs[k], mesh, copy) for k in tree}
    return [shard_tree(t, s, mesh, copy) for t, s in zip(tree, specs)]


def gather_tree(tree, specs, mesh):
    """The whole tensors of a tree of this rank's blocks: each sharded dim
    gathered over its axes (every rank calls this)."""
    from ..parallel.dist import all_gather
    if isinstance(specs, PartitionSpec):
        x = tree
        for dim, ax in enumerate(specs):
            if ax is not None and mesh.size(ax) > 1:
                x = all_gather(x.contiguous(), dim, mesh.group(ax))
        return x
    if isinstance(specs, dict):
        return {k: gather_tree(tree[k], specs[k], mesh) for k in tree}
    return [gather_tree(t, s, mesh) for t, s in zip(tree, specs)]
