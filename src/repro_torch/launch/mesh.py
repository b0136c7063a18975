"""Production mesh and axis rules (the reference's ``launch/mesh.py``).

Single pod: 16 x 16 = 256 ranks, axes (data, model): data parallelism over
rows, tensor/expert/context parallelism over columns. Multi-pod: 2 x 16 x
16, the 'pod' axis outer data parallelism. The port's mesh is a
:class:`~repro_torch.parallel.dist.Mesh` over ``torch.distributed`` ranks
(:func:`init_ranks` starts them: NCCL on CUDA, gloo on the CPU, or gloo on
CUDA where ranks share a card); the spec functions read only its axis
names and sizes, so ``Mesh(shape, axis_names)`` serves them without ranks.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..parallel.dist import Mesh
from ..parallel.logical import AxisRules, P, PartitionSpec


def init_ranks(device: str = "cuda", backend: str | None = None,
               init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None,
               timeout: float | None = None) -> torch.device:
    """Join the default process group, if not yet joined, and return this
    rank's device. ``rank``, ``world_size`` and the rendezvous come from
    the arguments or from ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``torchrun`` sets them). ``backend`` defaults to NCCL
    on CUDA and gloo on the CPU; a CUDA rank takes card ``LOCAL_RANK``
    modulo the cards present (gloo lets several ranks share one). An NCCL
    group is bound to that card (``device_id``), so that NCCL does not
    guess the card from the global rank. ``timeout``: seconds a collective
    may wait before it raises (torch's default where None)."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if rank is not None:
            kw["rank"] = rank
        if world_size is not None:
            kw["world_size"] = world_size
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        if backend == "nccl" and dev.type == "cuda":
            kw["device_id"] = dev
        dist.init_process_group(backend, init_method=init_method or "env://",
                                **kw)
    return dev


def _mesh(shape, device: torch.device) -> Mesh:
    """The mesh over the process group; its DeviceMesh on the CPU where the
    backend is gloo (gloo ranks may share a card, which NCCL refuses)."""
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    kind = device.type if dist.get_backend() == "nccl" else "cpu"
    return Mesh.build(shape, axes, kind)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"), over the 256 or 512 ranks of the process group."""
    return _mesh((2, 16, 16) if multi_pod else (16, 16), torch.device(device))


def parse_mesh(spec: str | None, device: str | torch.device = "cuda") -> Mesh:
    """``"2x4"`` (data x model) or ``"2x16x16"`` (pod x data x model) over
    the process group's ranks; None: (world / 2, 2), or (1, 1) alone."""
    world = dist.get_world_size()
    if spec:
        shape = tuple(int(x) for x in spec.split("x"))
    else:
        shape = (max(1, world // 2), min(2, world))
    return _mesh(shape, torch.device(device))


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def make_axis_rules(mesh, cfg=None, kv_replicate: bool = False) -> AxisRules:
    """Logical -> mesh axis mapping of the production layout.

    'seq' is unsharded for training (per-rank full sequences); 'kv_seq'
    (the decode KV cache) shards on 'model': context parallelism.
    ``kv_replicate``: keep the K/V projections whole on every rank of the
    model axis (where the GQA kv heads do not divide it)."""
    return AxisRules({
        "batch": batch_axes(mesh),
        "seq": None,
        "heads": "model",
        "kv_heads": None if kv_replicate else "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "kv_seq": "model",
    })


def mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def safe_spec(shape: tuple[int, ...], spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop the mesh axes that do not divide their dim (a batch of 1
    cannot be split)."""
    sizes = mesh_sizes(mesh)

    def axis_size(ax):
        if ax is None:
            return 1
        if isinstance(ax, (tuple, list)):
            out = 1
            for a in ax:
                out *= sizes[a]
            return out
        return sizes[ax]

    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        fixed.append(ax if ax is not None and dim % axis_size(ax) == 0
                     else None)
    return P(*fixed)
