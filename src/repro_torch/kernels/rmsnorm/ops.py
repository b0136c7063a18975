"""Wrapper of the fused residual add + RMSNorm kernel.

A CUDA tensor goes to the kernel in ``csrc/rmsnorm.cu``; a CPU tensor goes
to the plain version in :mod:`.ref`. Every call on the card is one launch,
counted in ``fused_rmsnorm.launches``: the residual add and the norm, or
Mamba2's gate (the cast of y, SiLU of z and their product) and the norm.
The kernel picks its launch from the shapes alone (:func:`plan`): up to 128
rows one block a row (the decode step), more rows a one-wave grid whose
blocks keep w in registers for every row they take (prefill).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, cost
from .ref import fused_rmsnorm_ref

#: The widest row the kernel takes: with 16-byte vectors, gated, and with
#: one element a vector (a width not a multiple of 8, or rows that do not
#: start on 16 bytes).
MAX_D, MAX_D_GATED, MAX_D_SCALAR = 16384, 8192, 4096


def _check_gate(x: torch.Tensor, gate: torch.Tensor, residual) -> None:
    if residual is not None:
        raise ValueError("fused_rmsnorm: a gate takes no residual")
    if gate.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_rmsnorm: gate dtype {gate.dtype} not supported")
    if x.dtype not in (torch.float32, gate.dtype):
        raise TypeError(f"fused_rmsnorm: x dtype {x.dtype} with a {gate.dtype} gate")
    if gate.shape != x.shape or gate.dim() != 2:
        raise ValueError(f"fused_rmsnorm: gate shape {tuple(gate.shape)} != x shape "
                         f"{tuple(x.shape)}, (T, d)")
    if gate.device != x.device:
        raise ValueError("fused_rmsnorm: gate and x on different devices")
    if gate.stride(-1) != 1:
        raise ValueError("fused_rmsnorm: the gate's last stride must be 1")


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor,
                  residual: torch.Tensor | None = None, eps: float = 1e-6,
                  gate: torch.Tensor | None = None):
    """x, residual: (T, d); w: (d,) float32. Returns (normed, new_residual),
    both (T, d) in x's dtype. The kernel takes bfloat16 x only.

    ``gate`` (T, d), read in place through its row stride (unit last
    stride), gives the Mamba2 layer's gated norm rmsnorm(x * silu(gate), w)
    in the same launch: no residual, x float32 (or the gate's dtype on the
    CPU), the gate bfloat16 on the card; returns (normed, None), normed in
    the gate's dtype."""
    if gate is not None:
        _check_gate(x, gate, residual)
    if x.device.type == "cpu":
        return fused_rmsnorm_ref(x, w, residual, eps, gate=gate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm: no kernel for device {x.device}")
    _build.refuse_grad("fused_rmsnorm", x, w, residual, gate)
    want = torch.float32 if gate is not None else torch.bfloat16
    if x.dtype != want or (gate is not None and gate.dtype != torch.bfloat16):
        raise TypeError(f"fused_rmsnorm: dtype {x.dtype}"
                        f"{'' if gate is None else f' with a {gate.dtype} gate'}"
                        " not supported")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("fused_rmsnorm: x must be a contiguous (T, d) tensor")
    t, d = x.shape
    if w.shape != (d,) or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("fused_rmsnorm: w must be a contiguous float32 (d,)")
    tensors = [x, w]
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or not residual.is_contiguous()):
            raise ValueError("fused_rmsnorm: residual must match x")
        tensors.append(residual)
    if any(u.device != x.device for u in tensors):
        raise ValueError("fused_rmsnorm: tensors on different devices")
    y = torch.empty(t, d, dtype=torch.bfloat16, device=x.device)
    rout = torch.empty_like(x) if gate is None else None
    if t == 0:
        return y, rout
    rows = [u for u in (x, residual, gate, y, rout) if u is not None]
    vec = d % 8 == 0 and w.data_ptr() % 16 == 0 and all(
        _build.rows_aligned(u) for u in rows)
    widest = MAX_D_SCALAR if not vec else MAX_D_GATED if gate is not None else MAX_D
    if d > widest:
        raise ValueError(f"fused_rmsnorm: d {d} wider than the kernel takes here ({widest}: "
                         f"{MAX_D} with 16-byte rows, {MAX_D_GATED} gated, "
                         f"{MAX_D_SCALAR} otherwise)")
    fn = _build.bind("rmsnorm", "rmsnorm_fwd", [
        *[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    opt = [None if u is None else _build.ptr(u) for u in (residual, gate, rout)]
    err = fn(_build.ptr(x), opt[0], opt[1], _build.ptr(w), _build.ptr(y), opt[2],
             t, d, gate.stride(0) if gate is not None else 0, eps, int(vec),
             _build.stream_ptr(x.device))
    _build.check("rmsnorm", err)
    _build.launched(fused_rmsnorm, lambda: cost.rmsnorm(
        t, d, "gated" if gate is not None else
        "plain" if residual is None else "residual"))
    return y, rout


def plan(rows: int, d: int, gated: bool = False, vec: bool = True) -> dict:
    """The launch a call of these shapes makes on the current card, as the
    kernel picks it: blocks, threads a block, vectors a thread and row,
    elements a vector."""
    fn = _build.bind("rmsnorm", "rmsnorm_plan", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 4)()
    _build.check("rmsnorm", fn(rows, d, int(gated), int(vec), out))
    return dict(zip(("grid", "threads", "vectors_per_thread", "vector"), out))


fused_rmsnorm.launches = 0
