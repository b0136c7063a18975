"""Dry-run op count of one call: the port's counterpart of the reference's
``launch/hlocost.py``.

The reference lowers its jitted decode step and prices the optimized HLO.
The port has no HLO: it runs the call once, eagerly, and counts what runs.

* **FLOPs** — ``torch.utils.flop_counter.FlopCounterMode``: the matrix
  products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
  attention) at 2 operations a multiply-add. Elementwise work is not
  counted.
* **bytes** — a ``TorchDispatchMode`` adds, for every aten op that moves
  bytes, ``numel × element size`` of each tensor input and of each tensor
  output. Ops that move none count 0: every view (an op whose schema says
  its output aliases an input, ``OpOverload.is_view``: ``view``,
  ``reshape`` as a view, ``transpose``, ``t``, ``permute``, ``expand``,
  ``slice``, ``select``, ``unsqueeze``, ``squeeze``, ``as_strided``,
  ``split``, ``unbind``, ``diagonal``, ``alias``...), the metadata-only
  ``_unsafe_view``, ``detach`` and ``lift_fresh``, and the allocators
  ``empty``, ``empty_like`` and ``empty_strided``. An in-place op
  (``add_``, ``copy_``, ``index_copy_``, ``scatter_add_``) counts the
  tensor it mutates twice, once as an input (the read) and once as its
  output (the write), and whole, even where the op touches a slice of it:
  the decode step's ``index_copy_`` of one cache position counts its
  layer's whole cache twice, as the reference's cost model prices a
  dynamic-update-slice's operand and result.
* **the kernels** — ``ctypes`` calls that neither mode sees. While a count
  runs, each wrapper reports its launch's work
  (:mod:`repro_torch.kernels.cost`, the definition ``chip_smoke.py``'s
  bounds use), and the count adds its FLOPs and bytes.
* **collectives** — counted where ``parallel/dist.py`` issues them, by
  their logical kind (``dist.recording``), each its operand's bytes: a
  gather that gloo carries as an all-reduce of zero-padded blocks counts as
  the gather it is, so the count does not depend on the backend. The
  transport's own ``c10d`` ops move no counted bytes. A one-device step
  has none.

:func:`trace_cost` fills the reference's ``launch/hlocost.CostSummary``
from one such count: the FLOPs, the bytes (also by aten op), and one
``CollectiveRecord`` per distinct (kind, operand shape, group size) in
issue order, ``trips`` the times it was issued, ``collective_bytes`` the
link bytes by kind under the parser's ring terms.

``route`` says which count a result holds: ``"plain"`` where the call ran
on the CPU (every kernel's plain version, seen by both modes), ``"cuda"``
on the card (the kernels through the hook, the rest through the modes).
"""
from __future__ import annotations

import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..kernels import cost
from ..launch.hlocost import CollectiveRecord, CostSummary
from ..parallel import dist as pd

_aten = torch.ops.aten
#: Ops that move no bytes besides the views (``OpOverload.is_view``).
NO_BYTES = {_aten._unsafe_view, _aten.detach, _aten.lift_fresh, _aten.alias,
            _aten.empty, _aten.empty_like, _aten.empty_strided}
#: The reference's collective kinds (``launch/hlocost.py``); a broadcast
#: or a point-to-point transfer counts as a permute.
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def moves_no_bytes(func) -> bool:
    return func.is_view or func.overloadpacket in NO_BYTES


class ByteCounter(TorchDispatchMode):
    """Counts the bytes of every aten op (see the module docstring) and the
    collectives' payload by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace not in _COLLECTIVE_NAMESPACES and not moves_no_bytes(func):
            n = (sum(map(_nbytes, tree_flatten((args, kwargs))[0]))
                 + sum(map(_nbytes, tree_flatten(out)[0])))
            self.bytes += n
            self.ops += 1
            name = func.overloadpacket.__name__
            self.by_op[name] = self.by_op.get(name, 0) + n
        return out


def _counted(fn, device, grad: bool = False):
    """Run ``fn()`` once under every counter (without autograd unless
    ``grad``: a train step differentiates): (kernels' work, FLOP counter,
    byte counter, collectives recorded, host seconds)."""
    device = torch.device(device)
    t0 = time.perf_counter()
    with torch.set_grad_enabled(grad), cost.counting() as kernels, pd.recording() as coll, \
            FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return kernels, flops, nbytes, coll, time.perf_counter() - t0


def count_ops(fn, device) -> dict:
    """Run ``fn()`` once under the FLOP and byte counters and the kernels'
    hook; returns the reference's dry-run keys (``flops``, ``bytes``,
    ``collective_bytes``, ``collective_by_kind``, ``compile_s`` — here the
    host seconds of the counted call) plus ``route``, ``aten_ops`` (ops
    that moved bytes) and ``kernel_launches`` (by wrapper)."""
    kernels, flops, nbytes, coll, seconds = _counted(fn, device)
    collective = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
    for kind, n, _, _ in coll:
        collective[kind] += n
    return {
        "flops": float(flops.get_total_flops() + kernels["flops"]),
        "bytes": float(nbytes.bytes + kernels["bytes"]),
        "collective_bytes": sum(collective.values()),
        "collective_by_kind": collective,
        "compile_s": seconds,
        "route": "cuda" if torch.device(device).type == "cuda" else "plain",
        "aten_ops": nbytes.ops,
        "kernel_launches": dict(kernels["launches"]),
    }


def trace_cost(fn, device, grad: bool = False) -> CostSummary:
    """``fn()`` run once and counted (:func:`count_ops`; with autograd where
    ``grad``) as the reference's ``hlocost.CostSummary`` of this rank:
    FLOPs and bytes (the kernels' work included; ``bytes_by_opcode`` by
    aten op, the kernels under ``"kernels"``), the collectives' schedule by
    kind, no while loops."""
    kernels, flops, nbytes, coll, _ = _counted(fn, device, grad)
    records: dict[tuple, CollectiveRecord] = {}
    for kind, n, shape, parts in coll:
        key = (kind, n, shape, parts)
        if key in records:
            records[key].trips += 1
        else:
            records[key] = CollectiveRecord(kind, float(n), 1, shape, parts)
    by_kind: dict[str, float] = {}
    for r in records.values():
        by_kind[r.kind] = by_kind.get(r.kind, 0.0) + r.total_link_bytes
    by_op = {k: float(v) for k, v in nbytes.by_op.items()}
    if kernels["bytes"]:
        by_op["kernels"] = float(kernels["bytes"])
    return CostSummary(
        flops=float(flops.get_total_flops() + kernels["flops"]),
        bytes_accessed=float(nbytes.bytes + kernels["bytes"]),
        collective_bytes=by_kind, collectives=list(records.values()),
        while_trip_counts=[], bytes_by_opcode=by_op)
