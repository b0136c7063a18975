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

The Mamba2 layer's projection is split by segments, not in one block (a
difference by design from the reference, which reshards): ``in_proj``'s
columns ``[z | x | B | C | dt]`` carry a
:class:`~repro_torch.parallel.logical.Segments` entry that gives each rank
its heads' z, x and dt and all of B and C, and the conv cache's ``[x | B |
C]`` channels alike; ``out_proj``'s rows and the state's heads split in one
block as the reference's. Where the model axis does not divide the heads
(``ssm_split``) the SSM stays whole on every rank and those entries are
None. :func:`local_shard`, :func:`shard_tree`, :func:`gather_tree` and the
checkpoint's restore apply the segments, so a gathered tree equals the
whole one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import init_cache, init_params
from ..models.config import ModelConfig
from ..models.layers import ssm_dims, ssm_split
from ..models.transformer import param_dtype
from ..parallel.logical import P, PartitionSpec, Segments, param_spec
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


def ssm_segments(cfg: ModelConfig, channels: bool = False) -> Segments:
    """The Mamba2 ``in_proj``'s columns as segments over 'model' (z, x, B, C,
    dt), or with ``channels`` the conv's (x, B, C)."""
    d_in, n, h, _ = ssm_dims(cfg)
    if channels:
        return Segments("model", (d_in, n, n), (True, False, False))
    return Segments("model", (d_in, d_in, n, n, h), (True, True, False, False, True))


def _ssm_entry(cfg: ModelConfig, mesh, entry, channels: bool = False):
    """A 'model' entry of an SSM leaf (in_proj's columns, the conv cache's
    channels) as the segmented split, or None where the heads do not
    divide the model axis."""
    if entry != "model":
        return entry
    return ssm_segments(cfg, channels) if ssm_split(cfg, mesh.size("model")) else None


def param_shardings(cfg: ModelConfig, mesh, fsdp: bool = False, rules=None):
    """Spec tree matching ``init_params(cfg)``, under ``rules`` (default
    ``make_axis_rules(mesh)``; ``kv_replicate`` keeps wk/wv whole)."""
    rules = make_axis_rules(mesh) if rules is None else rules
    sizes = mesh_sizes(mesh)
    shapes = init_params(cfg, device="meta", dtype=param_dtype(cfg))

    def one(path, leaf):
        spec = param_spec(path[-1:], tuple(leaf.shape), rules, sizes)
        if fsdp:
            spec = _fsdp_spec(spec, tuple(leaf.shape), mesh)
        spec = safe_spec(tuple(leaf.shape), spec, mesh)
        if path[-1] == "in_proj":
            spec = P(spec[0], _ssm_entry(cfg, mesh, spec[1]))
        return spec

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
        conv = safe_spec(tuple(shapes["conv"].shape),
                         P(None, None, ba, None, "model"), mesh)
        specs["conv"] = P(*conv[:4], _ssm_entry(cfg, mesh, conv[4], channels=True))
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
def _segment_pieces(x, dim: int, seg: Segments, i: int, n: int) -> list:
    """Rank ``i`` of ``n``'s pieces of the whole dim ``dim`` of ``x``: each
    split segment's block ``i``, each whole segment as it is."""
    pieces, off = [], 0
    for size, split in zip(seg.sizes, seg.split):
        lo, width = (off + i * (size // n), size // n) if split else (off, size)
        pieces.append(x[(slice(None),) * dim + (slice(lo, lo + width),)])
        off += size
    return pieces


def local_shard(x, spec: PartitionSpec, mesh):
    """This rank's block of the whole tensor (or numpy array) ``x`` under
    ``spec``: each sharded dim cut into the axes' size and this rank's
    place along them taken (a view where it can be; a copy where the dim
    is split by :class:`Segments`)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.size(ax)
        i = mesh.index(ax)
        if isinstance(ax, Segments):
            pieces = _segment_pieces(x, dim, ax, i, n)
            x = (np.concatenate(pieces, dim) if isinstance(x, np.ndarray)
                 else torch.cat(pieces, dim))
            continue
        blk = x.shape[dim] // n
        x = x[(slice(None),) * dim + (slice(i * blk, (i + 1) * blk),)]
    return x


def _spec_at(specs, path: tuple):
    """The spec at ``path`` (keys, list places as ints or digit strings)."""
    for k in path:
        specs = specs[int(k)] if isinstance(specs, list) else specs[k]
    return specs


def init_local_params(cfg: ModelConfig, mesh, seed: int = 0, device=None,
                      dtype: torch.dtype | None = None) -> dict:
    """This rank's blocks of ``init_params(cfg, seed)`` under
    ``param_shardings(cfg, mesh)``, made a layer at a time: each leaf is
    drawn whole (the same values as the whole init's), its block kept as a
    copy of its own and the rest freed, so a model larger than one card's
    memory is made on the ranks that hold it."""
    specs = param_shardings(cfg, mesh)
    return init_params(cfg, seed=seed, device=device, dtype=dtype, leaf=lambda path, t:
                       local_shard(t, _spec_at(specs, path), mesh).clone(
                           memory_format=torch.contiguous_format))


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
            if ax is None or mesh.size(ax) == 1:
                continue
            x = all_gather(x.contiguous(), dim, mesh.group(ax))
            if isinstance(ax, Segments):     # rank blocks -> segment order
                n = mesh.size(ax)
                ranks = x.chunk(n, dim)
                local = ax.local_sizes(n)
                parts = [r.split(local, dim) for r in ranks]
                x = torch.cat([p for j, split in enumerate(ax.split)
                               for p in ([parts[r][j] for r in range(n)] if split
                                         else [parts[0][j]])], dim)
        return x
    if isinstance(specs, dict):
        return {k: gather_tree(tree[k], specs[k], mesh) for k in tree}
    return [gather_tree(t, s, mesh) for t, s in zip(tree, specs)]
