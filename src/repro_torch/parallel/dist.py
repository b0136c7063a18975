"""The port's device mesh and its collectives, on ``torch.distributed``.

:class:`Mesh` names the axes of a grid of ranks, as the reference's
``jax.sharding.Mesh`` does (``("data", "model")`` or ``("pod", "data",
"model")``), over a ``torch.distributed.device_mesh.DeviceMesh``; built
without one it has the axes' names and sizes alone, which is all the
sharding specs read. Rank r sits at the row-major coordinates of r in the
grid.

The collectives take a mesh's process group. Megatron's pair of autograd
functions carries tensor parallelism through training: :func:`copy_to`
(identity forward, all-reduce of the gradient backward) in front of a
column-parallel product, :func:`reduce_from` (all-reduce forward, identity
backward) after a row-parallel one. Every collective on a group of one rank
returns its input.

Transport: NCCL on CUDA tensors, gloo on CPU tensors, and gloo on CUDA
tensors when two ranks share one card (NCCL refuses that); gloo stages a
CUDA tensor through the host and takes only ``all_reduce`` and
``broadcast`` there, so the gather and reduce-scatter below are written as
all-reduces unless the group's backend is NCCL.

Each collective of a group of more than one rank is recorded where it is
issued here, by its logical kind (all-gather, all-reduce, reduce-scatter,
and a broadcast as a collective-permute), with its operand's bytes and the
group's size, in every open :func:`recording`: a gather that gloo carries
as an all-reduce is still an all-gather there, so a trace's collectives do
not depend on the backend (``validation/opcount.trace_cost``).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist


class Mesh:
    """Named axes over ``torch.distributed`` ranks.

    ``shape`` and ``axis_names`` as the reference's mesh; ``device_mesh``
    the ``DeviceMesh`` behind it, None for a mesh of names and sizes only
    (specs, planning)."""

    def __init__(self, shape, axis_names, device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names}")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh
        self._groups: dict[tuple, object] = {}

    @classmethod
    def build(cls, shape, axis_names, device_type: str) -> "Mesh":
        """The mesh over the initialised default process group, whose world
        size must be the product of ``shape``; every rank calls this with
        the same arguments (it creates the axes' groups collectively)."""
        from torch.distributed.device_mesh import init_device_mesh
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                             f"ranks, the world has {world}")
        dm = init_device_mesh(device_type, tuple(shape),
                              mesh_dim_names=tuple(axis_names))
        mesh = cls(shape, axis_names, dm)
        if "pod" in axis_names:        # the batch axes' group, made by all
            mesh._make_group(("pod", "data"))
        return mesh

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))})"

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, axes) -> int:
        """The number of ranks along an axis or a tuple of axes (1 for None
        or an axis the mesh lacks)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.sizes.get(a, 1) for a in axes)

    def coords(self) -> dict[str, int]:
        """This rank's coordinate along every axis (all 0 without ranks)."""
        if self.device_mesh is None:
            return {a: 0 for a in self.axis_names}
        rank = dist.get_rank()
        out = {}
        for name, size in zip(reversed(self.axis_names), reversed(self.shape)):
            out[name] = rank % size
            rank //= size
        return out

    def index(self, axes) -> int:
        """This rank's place along an axis or a tuple of axes (row-major,
        the first axis outermost)."""
        if axes is None:
            return 0
        if isinstance(axes, str):
            axes = (axes,)
        c = self.coords()
        idx = 0
        for a in axes:
            idx = idx * self.sizes.get(a, 1) + c.get(a, 0)
        return idx

    def group(self, axes):
        """The process group of this rank's line along ``axes`` (a name or a
        tuple of names)."""
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(str(a) for a in axes if a in self.axis_names)
        if self.device_mesh is None:
            raise ValueError(f"{self!r} has no ranks")
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            raise ValueError(f"no group for axes {axes}")
        return self._groups[axes]

    def _make_group(self, axes: tuple) -> None:
        """Create the groups of the lines along ``axes`` (every rank takes
        part, in the same order)."""
        ranks = torch.arange(math.prod(self.shape)).reshape(self.shape)
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.shape)) if i not in keep]
        lines = ranks.permute(*rest, *keep).reshape(-1, self.size(axes))
        mine, _ = dist.new_subgroups_by_enumeration(lines.tolist())
        self._groups[axes] = mine


# ------------------------------- collectives ---------------------------------
_RECORDERS: list[list] = []
_HLO_DTYPES = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


@contextlib.contextmanager
def recording():
    """Inside the block, every collective issued here on a group of more
    than one rank appends ``(kind, operand bytes, shape text,
    participants)`` to the list it yields, in issue order."""
    rec: list = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _record(kind: str, x: torch.Tensor, n: int) -> None:
    if _RECORDERS:
        shape = f"{_HLO_DTYPES.get(x.dtype, str(x.dtype))}[{','.join(map(str, x.shape))}]"
        item = (kind, x.numel() * x.element_size(), shape, n)
        for rec in _RECORDERS:
            rec.append(item)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def backend(group) -> str:
    """The group's backend name ("nccl", "gloo", "fake")."""
    return dist.get_backend(group)


def _nccl(group) -> bool:
    return backend(group) == "nccl"


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``op`` of ``x`` over the group's ranks."""
    n = group_size(group)
    if n == 1:
        return x
    _record("all-reduce", x, n)
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank order
    (every block of ``x``'s shape)."""
    n = group_size(group)
    if n == 1:
        return x
    _record("all-gather", x, n)
    dim = dim % x.dim()
    if _nccl(group):
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= n
    out = x.new_zeros(shape)
    r = dist.get_rank(group)
    out.narrow(dim, r * x.shape[dim], x.shape[dim]).copy_(x)
    dist.all_reduce(out, group=group)
    return out


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over the group, this rank's block of it along
    ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    _record("reduce-scatter", x, n)
    dim = dim % x.dim()
    blk = x.shape[dim] // n
    r = dist.get_rank(group)
    if _nccl(group):
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((blk, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y.narrow(dim, r * blk, blk).clone()


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` as the group's rank ``src`` holds it, in place."""
    n = group_size(group)
    if n > 1:
        _record("collective-permute", x, n)
        dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` forward; the gradient summed over the group in
    backward (the input of a column-parallel product)."""
    if group_size(group) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group, dtype: torch.dtype | None = None
                ) -> torch.Tensor:
    """Megatron's g: ``x`` summed over the group forward (in ``dtype``,
    default x's, the result in x's); the gradient as it is backward (the
    output of a row-parallel product)."""
    if group_size(group) == 1:
        return x
    out_dtype = x.dtype
    if dtype is not None:
        x = x.to(dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        y = _ReduceFrom.apply(x, group)
    else:
        y = all_reduce(x.contiguous(), group)
    return y.to(out_dtype)
