"""Logical-axis sharding rules (the reference's ``parallel/logical.py``).

Models name the axes of their tensors logically ("heads", "ff", "vocab",
"experts", ...); the launcher installs an :class:`AxisRules` that maps
logical names to mesh axes, together with the mesh (:func:`use_rules`).
Outside any rules context (unit tests, one device) nothing is sharded and
the model runs exactly as it does without this module.

The port runs its mesh explicitly: each rank holds the local block of every
tensor that a rule shards, and the layers that read the rules put the
collectives in themselves (``models/layers.py``). So :func:`shard` places
nothing; it only checks an annotation's rank where the reference constrains
a sharding. :func:`param_spec` is the naming convention both packages share:
which dims of a parameter leaf are sharded over which mesh axes.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Sequence

import torch


class PartitionSpec(tuple):
    """Per dim of a tensor: a mesh axis name, a tuple of names (the dim
    split over their product, the first outermost), or None (whole on
    every rank). ``PartitionSpec("data", None)``; equal to the tuple of
    its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Segments(str):
    """A spec entry for a dim made of segments, each either split over the
    mesh axis (its blocks, rank by rank) or whole on every rank: the Mamba2
    ``in_proj``'s ``[z | x | B | C | dt]`` columns, whose z, x and dt follow
    the rank's heads while B and C (one group for every head) stay whole,
    and the conv cache's ``[x | B | C]`` channels. It is the axis' name as a
    string (so a spec reads as the reference's, sharded over that axis), and
    ``sizes`` / ``split`` give the whole dim's segments."""

    sizes: tuple
    split: tuple

    def __new__(cls, axis: str, sizes, split):
        obj = super().__new__(cls, axis)
        obj.sizes, obj.split = tuple(int(n) for n in sizes), tuple(bool(b) for b in split)
        if len(obj.sizes) != len(obj.split):
            raise ValueError(f"Segments: {obj.sizes} and {obj.split}")
        return obj

    def __repr__(self) -> str:
        return f"Segments({str(self)!r}, {self.sizes}, {self.split})"

    def __reduce__(self):          # copies and pickles keep the segments
        return Segments, (str(self), self.sizes, self.split)

    def local_sizes(self, n: int) -> tuple:
        """The segments' widths on one of ``n`` ranks."""
        return tuple(s // n if sp else s for s, sp in zip(self.sizes, self.split))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis -> mesh axis (or tuple of mesh axes, or None)."""

    rules: dict

    def spec(self, *logical: str | None) -> PartitionSpec:
        return P(*(self.rules.get(a) if a is not None else None
                   for a in logical))


_current: contextvars.ContextVar[AxisRules | None] = contextvars.ContextVar(
    "axis_rules", default=None)
_current_mesh: contextvars.ContextVar = contextvars.ContextVar(
    "axis_mesh", default=None)


def current_rules() -> AxisRules | None:
    return _current.get()


def current_mesh():
    """The mesh installed alongside the rules (None outside the launcher).
    Layers read it to run their collectives over its axes."""
    return _current_mesh.get()


@contextlib.contextmanager
def use_rules(rules: AxisRules | None, mesh=None):
    token = _current.set(rules)
    mtoken = _current_mesh.set(mesh)
    try:
        yield
    finally:
        _current.reset(token)
        _current_mesh.reset(mtoken)


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """``x`` unchanged. With rules installed, checks that ``logical`` names
    one axis per dim of ``x``, as the reference's sharding constraint does;
    the tensor is already this rank's block."""
    if _current.get() is not None and len(logical) != x.dim():
        raise ValueError(f"shard(): {len(logical)} axes for rank-{x.dim()}")
    return x


def param_spec(path: Sequence[str], shape: tuple[int, ...],
               rules: AxisRules, mesh_axis_sizes: dict) -> PartitionSpec:
    """PartitionSpec of a parameter leaf by naming convention.

    Conventions (leaf name — see models/layers.py init functions):
      embed (V, d)        -> ('vocab', None)
      wq/wk/wv (d, H*hd)  -> (None, 'heads')   [kv replicated if indivisible]
      wo (H*hd, d)        -> ('heads', None)
      mlp wi/wg (d, F)    -> (None, 'ff'); wo (F, d) -> ('ff', None)
      moe wi/wg (E, d, F) -> ('experts', None, None); router replicated
      ssm in_proj (d, X)  -> (None, 'ff'); out_proj (X, d) -> ('ff', None)
      norms / scalars     -> replicated
    A dim is sharded only where the mesh axes' size divides it. ``path``
    starting with "stack" names a leaf of the reference's stacked layers,
    whose leading (n_blocks,) dim gets None; the port's own leaves (a block
    of its list) have no such dim.
    """
    name = path[-1]
    stacked = len(path) > 1 and path[0] == "stack"

    def ok(logical: str, dim: int) -> bool:
        ax = rules.rules.get(logical)
        if ax is None:
            return False
        size = mesh_axis_sizes.get(ax, 1) if isinstance(ax, str) else 1
        if isinstance(ax, tuple):
            size = 1
            for a in ax:
                size *= mesh_axis_sizes.get(a, 1)
        return dim % max(size, 1) == 0

    def on(logical: str, dim: int):
        return rules.rules.get(logical) if ok(logical, dim) else None

    d = shape[1:] if stacked else shape
    if name == "embed":
        base = (on("vocab", d[0]), None)
    elif name == "wq":
        base = (None, on("heads", d[1]))
    elif name in ("wk", "wv"):
        base = (None, on("kv_heads", d[1]))
    elif name == "wo" and len(d) == 2:
        base = (on("heads", d[0]), None)
    elif name in ("wi", "wg") and len(d) == 2:
        base = (None, on("ff", d[1]))
    elif name in ("wi", "wg", "wo", "router") and len(d) == 3:
        base = (on("experts", d[0]), None, None)
    elif name == "in_proj":
        base = (None, on("ff", d[1]))
    elif name == "out_proj":
        base = (on("ff", d[0]), None)
    elif name == "lm_head":
        base = (None, on("vocab", d[1]))
    else:
        base = tuple(None for _ in d)
    if stacked:
        base = (None,) + base
    return P(*base)
