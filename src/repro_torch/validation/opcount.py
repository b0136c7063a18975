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
* **collectives** — ops of the ``c10d`` functional namespaces, their input
  payload by kind; a one-device step has none.

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

_aten = torch.ops.aten
#: Ops that move no bytes besides the views (``OpOverload.is_view``).
NO_BYTES = {_aten._unsafe_view, _aten.detach, _aten.lift_fresh, _aten.alias,
            _aten.empty, _aten.empty_like, _aten.empty_strided}
#: The reference's collective kinds, each with the op-name fragment that
#: marks it; any other collective (send, recv, broadcast) is a permute.
COLLECTIVE_KINDS = {"all-gather": "all_gather", "all-reduce": "all_reduce",
                    "reduce-scatter": "reduce_scatter",
                    "all-to-all": "all_to_all", "collective-permute": None}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def moves_no_bytes(func) -> bool:
    return func.is_view or func.overloadpacket in NO_BYTES


def collective_kind(name: str) -> str:
    for kind, frag in COLLECTIVE_KINDS.items():
        if frag is not None and frag in name:
            return kind
    return "collective-permute"


class ByteCounter(TorchDispatchMode):
    """Counts the bytes of every aten op (see the module docstring) and the
    collectives' payload by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.collective_by_kind = dict.fromkeys(COLLECTIVE_KINDS, 0.0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = sum(map(_nbytes, tree_flatten((args, kwargs))[0]))
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self.collective_by_kind[collective_kind(func.__name__)] += inputs
        elif not moves_no_bytes(func):
            self.bytes += inputs + sum(map(_nbytes, tree_flatten(out)[0]))
            self.ops += 1
        return out


def count_ops(fn, device) -> dict:
    """Run ``fn()`` once under the FLOP and byte counters and the kernels'
    hook; returns the reference's dry-run keys (``flops``, ``bytes``,
    ``collective_bytes``, ``collective_by_kind``, ``compile_s`` — here the
    host seconds of the counted call) plus ``route``, ``aten_ops`` (ops
    that moved bytes) and ``kernel_launches`` (by wrapper)."""
    device = torch.device(device)
    t0 = time.perf_counter()
    with torch.no_grad(), cost.counting() as kernels, \
            FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    collective = dict(nbytes.collective_by_kind)
    return {
        "flops": float(flops.get_total_flops() + kernels["flops"]),
        "bytes": float(nbytes.bytes + kernels["bytes"]),
        "collective_bytes": sum(collective.values()),
        "collective_by_kind": collective,
        "compile_s": time.perf_counter() - t0,
        "route": "cuda" if device.type == "cuda" else "plain",
        "aten_ops": nbytes.ops,
        "kernel_launches": dict(kernels["launches"]),
    }
