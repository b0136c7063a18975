"""Wrapper of the fused residual add + RMSNorm kernel and of its backward.

A CUDA tensor goes to the kernel in ``csrc/rmsnorm.cu``; a CPU tensor goes
to the plain version in :mod:`.ref`. Every call on the card is one launch,
counted in ``fused_rmsnorm.launches``: the residual add and the norm, or
Mamba2's gate (the cast of y, SiLU of z and their product) and the norm.
The kernel picks its launch from the shapes alone (:func:`plan`): up to 128
rows one block a row (the decode step), more rows a one-wave grid whose
blocks keep w in registers for every row they take (prefill).

Where autograd records (a gradient wanted of x, w, the residual or the
gate), the call goes through a ``torch.autograd.Function`` on either
device: the same forward, and :func:`fused_rmsnorm_bwd` in backward (the
backward kernel on the card, counted in ``fused_rmsnorm_bwd.launches``;
:func:`.ref.fused_rmsnorm_bwd_ref` on the CPU). Under ``torch.no_grad()``
a call launches the forward alone, as serving does.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, cost
from .ref import fused_rmsnorm_bwd_ref, fused_rmsnorm_ref

#: The widest row the kernel takes: with 16-byte vectors, gated, and with
#: one element a vector (a width not a multiple of 8, or rows that do not
#: start on 16 bytes).
MAX_D, MAX_D_GATED, MAX_D_SCALAR = 16384, 8192, 4096
#: The widest row the backward takes with 16-byte vectors (either form;
#: MAX_D_SCALAR otherwise), and the most blocks its grid has: the scratch
#: rows of dw shares a call allocates (``BWD_MAX_BLOCKS`` in the source).
MAX_D_BWD, BWD_MAX_BLOCKS = 8192, 1024


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
    the gate's dtype. Differentiable (:class:`_FusedRMSNorm`)."""
    if gate is not None:
        _check_gate(x, gate, residual)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, residual, gate)):
        if gate is not None:
            return _FusedRMSNorm.apply(x, w, None, gate, eps), None
        return _FusedRMSNorm.apply(x, w, residual, None, eps)
    return _forward(x, w, residual, eps, gate)


class _FusedRMSNorm(torch.autograd.Function):
    """:func:`fused_rmsnorm` with its backward. Saves the inputs (the f32
    sum, or the gated product, is recomputed from them in backward, as the
    forward computes it). Returns the normed output alone when gated."""

    @staticmethod
    def forward(ctx, x, w, residual, gate, eps):
        h, r = _forward(x, w, residual, eps, gate)
        ctx.save_for_backward(x, w, residual, gate)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return h if gate is not None else (h, r)

    @staticmethod
    def backward(ctx, dh, dr=None):
        x, w, residual, gate = ctx.saved_tensors
        if dh is None and dr is None:
            return None, None, None, None, None
        if dh is None:
            dh = torch.zeros(x.shape, dtype=dr.dtype, device=x.device)
        dx, d2, dw = fused_rmsnorm_bwd(dh, dr, x, w, residual, ctx.eps, gate)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None,
                d2 if need[2] else None, d2 if need[3] else None, None)


def _forward(x, w, residual, eps, gate):
    """The forward: the kernel on the card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return fused_rmsnorm_ref(x, w, residual, eps, gate=gate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm: no kernel for device {x.device}")
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


def fused_rmsnorm_bwd(dh: torch.Tensor, dr: torch.Tensor | None,
                      x: torch.Tensor, w: torch.Tensor,
                      residual: torch.Tensor | None = None, eps: float = 1e-6,
                      gate: torch.Tensor | None = None):
    """The backward of :func:`fused_rmsnorm` at (x, w, residual, gate): dh
    the gradient of the normed output, dr that of the new residual (None
    where it is unused; none when gated). Returns (dx, dresidual, dw), or
    gated (dy, dgate, dw), as :func:`.ref.fused_rmsnorm_bwd_ref` defines
    them. On the card: bf16 dh, dr, x and residual (the gated form: f32 x,
    the bf16 gate read through its row stride), f32 w; dx = dresidual is
    one bf16 tensor, the gated dy f32 and dgate bf16 (contiguous), dw f32.
    One call is counted in ``fused_rmsnorm_bwd.launches``: the rows'
    kernel, then the kernel that sums dw's per-block shares in a fixed
    order (no atomics: two calls give the same bits)."""
    if x.device.type == "cpu":
        return fused_rmsnorm_bwd_ref(dh, dr, x, w, residual, eps, gate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm_bwd: no kernel for device {x.device}")
    gated = gate is not None
    if gated:
        _check_gate(x, gate, residual)
        if dr is not None:
            raise ValueError("fused_rmsnorm_bwd: a gated norm has no residual gradient")
    want = torch.float32 if gated else torch.bfloat16
    if (x.dtype != want or dh.dtype != torch.bfloat16
            or (gated and gate.dtype != torch.bfloat16)):
        raise TypeError(f"fused_rmsnorm_bwd: dtypes x {x.dtype}, dh {dh.dtype}"
                        f"{'' if gate is None else f', gate {gate.dtype}'} not supported")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("fused_rmsnorm_bwd: x must be a contiguous (T, d) tensor")
    t, d = x.shape
    if w.shape != (d,) or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("fused_rmsnorm_bwd: w must be a contiguous float32 (d,)")
    for name, u in (("dh", dh), ("dr", dr), ("residual", residual)):
        if u is not None and (u.shape != x.shape or u.dtype != torch.bfloat16):
            raise ValueError(f"fused_rmsnorm_bwd: {name} must be bf16 of x's shape")
    if residual is not None and not residual.is_contiguous():
        raise ValueError("fused_rmsnorm_bwd: residual must be contiguous")
    if any(u is not None and u.device != x.device for u in (dh, dr, w, residual, gate)):
        raise ValueError("fused_rmsnorm_bwd: tensors on different devices")
    dh = dh.contiguous()
    dr = None if dr is None else dr.contiguous()
    dx = torch.empty(t, d, dtype=x.dtype, device=x.device)
    dz = torch.empty(t, d, dtype=torch.bfloat16, device=x.device) if gated else None
    dw = torch.empty(d, dtype=torch.float32, device=x.device)
    second = dz if gated else dx if residual is not None else None
    if t == 0:
        return dx, second, dw.zero_()
    rows = [u for u in (x, residual, gate, dh, dr, dx, dz) if u is not None]
    vec = d % 8 == 0 and w.data_ptr() % 16 == 0 and all(
        _build.rows_aligned(u) for u in rows)
    widest = MAX_D_BWD if vec else MAX_D_SCALAR
    if d > widest:
        raise ValueError(f"fused_rmsnorm_bwd: d {d} wider than the backward takes here "
                         f"({widest}: {MAX_D_BWD} with 16-byte rows, {MAX_D_SCALAR} otherwise)")
    part = torch.empty(min(t, BWD_MAX_BLOCKS), d, dtype=torch.float32, device=x.device)
    fn = _build.bind("rmsnorm", "rmsnorm_bwd", [
        *[ctypes.c_void_p] * 10, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    opt = [None if u is None else _build.ptr(u) for u in (dr, residual, gate, dz)]
    err = fn(_build.ptr(dh), opt[0], _build.ptr(x), opt[1], opt[2], _build.ptr(w),
             _build.ptr(dx), opt[3], _build.ptr(part), _build.ptr(dw), t, d,
             gate.stride(0) if gated else 0, eps, int(vec), _build.stream_ptr(x.device))
    _build.check("rmsnorm", err)
    _build.launched(fused_rmsnorm_bwd, lambda: cost.rmsnorm_bwd(
        t, d, "gated" if gated else "plain" if residual is None else "residual",
        dr is not None))
    return dx, second, dw


def plan_bwd(rows: int, d: int, gated: bool = False, vec: bool = True) -> dict:
    """The backward's launch for these shapes on the current card, as
    :func:`plan` gives the forward's."""
    fn = _build.bind("rmsnorm", "rmsnorm_bwd_plan", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 4)()
    _build.check("rmsnorm", fn(rows, d, int(gated), int(vec), out))
    return dict(zip(("grid", "threads", "vectors_per_thread", "vector"), out))


fused_rmsnorm.launches = 0
fused_rmsnorm_bwd.launches = 0
