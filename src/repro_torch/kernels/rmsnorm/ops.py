"""Wrapper of the fused residual add + RMSNorm kernel and of its backward.

A CUDA tensor goes to the kernel in ``csrc/rmsnorm.cu``, whose templates
take the element type: bfloat16 or float32 rows (the gated form's y is
float32 either way, its gate and output in the element type), counted by
type in ``<wrapper>.by_kind``; float16 and other dtypes raise. A CPU
tensor goes to the plain version in :mod:`.ref`. Every call on the card is
one launch, counted in ``fused_rmsnorm.launches``: the residual add and the norm, or
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

:func:`split_gated_rmsnorm` is the gated norm of a row split over ranks
(the Mamba2 layer under a model axis, each rank its heads' columns): a
statistic launch (:func:`gated_norm_stat`, each row's sum of g² over the
block), an all-reduce of those (T,) floats over the group, and an apply
launch (:func:`gated_norm_apply`), each counted on its own; its backward
alike (:func:`gated_norm_bwd_stat`, an all-reduce of (T, 2),
:func:`gated_norm_bwd_apply`). Their kernels are in
``csrc/rmsnorm_split.cu``; each tensor takes its own vector width
(:func:`split_widths`: the gate, a strided slice, the widest its rows
allow).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, cost
from .ref import (fused_rmsnorm_bwd_ref, fused_rmsnorm_ref, gated_norm_apply_ref,
                  gated_norm_bwd_apply_ref, gated_norm_bwd_stat_ref,
                  gated_norm_stat_ref)

#: The widest row the kernel takes: with 16-byte vectors (float32: 12288),
#: gated, and with one element a vector (a width not a multiple of 8, or
#: rows that do not start on 16 bytes).
MAX_D, MAX_D_GATED, MAX_D_SCALAR = 16384, 8192, 4096
MAX_D_F32 = 12288
#: The widest row the backward takes with 16-byte vectors (either form;
#: MAX_D_SCALAR otherwise), and the most blocks its grid has: the scratch
#: rows of dw shares a call allocates (``BWD_MAX_BLOCKS`` in the source).
MAX_D_BWD, BWD_MAX_BLOCKS = 8192, 1024
#: The element types the kernels take.
_DTYPES = (torch.bfloat16, torch.float32)


def _entry(name: str, dtype: torch.dtype) -> str:
    """The C entry point ``name`` for rows of ``dtype`` (``<name>_f32``)."""
    return name + "_f32" if dtype == torch.float32 else name


def element_dtype(name: str, x: torch.Tensor, gate: torch.Tensor | None) -> torch.dtype:
    """The element type of a call on the card (the gate's when gated, x's
    otherwise), raising TypeError where the kernel does not take it:
    bfloat16 or float32 only, and a gated call's x float32."""
    elem = x.dtype if gate is None else gate.dtype
    if elem not in _DTYPES or (gate is not None and x.dtype != torch.float32):
        raise TypeError(f"{name}: dtype {x.dtype}"
                        f"{'' if gate is None else f' with a {gate.dtype} gate'}"
                        " not supported (bfloat16 or float32 rows)")
    return elem


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
    both (T, d) in x's dtype.

    ``gate`` (T, d), read in place through its row stride (unit last
    stride), gives the Mamba2 layer's gated norm rmsnorm(x * silu(gate), w)
    in the same launch: no residual, x float32 (or the gate's dtype on the
    CPU), the gate bfloat16 or float32 on the card; returns (normed, None),
    normed in the gate's dtype. Differentiable (:class:`_FusedRMSNorm`).
    The kernel takes bfloat16 or float32 rows."""
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
    if x.device.type == "meta":
        t, d = x.shape
        _build.meta_launch(fused_rmsnorm, lambda: cost.rmsnorm(
            t, d, "gated" if gate is not None else
            "plain" if residual is None else "residual",
            f32=(x.dtype if gate is None else gate.dtype) == torch.float32))
        return (torch.empty(t, d, dtype=gate.dtype if gate is not None else x.dtype,
                            device=x.device),
                None if gate is not None else torch.empty_like(x))
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm: no kernel for device {x.device}")
    elem = element_dtype("fused_rmsnorm", x, gate)
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
    y = torch.empty(t, d, dtype=elem, device=x.device)
    rout = torch.empty_like(x) if gate is None else None
    if t == 0:
        return y, rout
    rows = [u for u in (x, residual, gate, y, rout) if u is not None]
    vec = d % 8 == 0 and w.data_ptr() % 16 == 0 and all(
        _build.rows_aligned(u) for u in rows)
    widest = (MAX_D_SCALAR if not vec else MAX_D_GATED if gate is not None
              else MAX_D_F32 if elem == torch.float32 else MAX_D)
    if d > widest:
        raise ValueError(f"fused_rmsnorm: d {d} wider than the kernel takes here ({widest}: "
                         f"{MAX_D} with 16-byte rows ({MAX_D_F32} in float32), "
                         f"{MAX_D_GATED} gated, {MAX_D_SCALAR} otherwise)")
    fn = _build.bind("rmsnorm", _entry("rmsnorm_fwd", elem), [
        *[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    opt = [None if u is None else _build.ptr(u) for u in (residual, gate, rout)]
    err = fn(_build.ptr(x), opt[0], opt[1], _build.ptr(w), _build.ptr(y), opt[2],
             t, d, gate.stride(0) if gate is not None else 0, eps, int(vec),
             _build.stream_ptr(x.device))
    _build.check("rmsnorm", err)
    _build.launched(fused_rmsnorm, lambda: cost.rmsnorm(
        t, d, "gated" if gate is not None else
        "plain" if residual is None else "residual", f32=elem == torch.float32),
        _build.kind(elem))
    return y, rout


def plan(rows: int, d: int, gated: bool = False, vec: bool = True,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch a call of these shapes makes on the current card, as the
    kernel picks it: blocks, threads a block, vectors a thread and row,
    elements a vector."""
    fn = _build.bind("rmsnorm", _entry("rmsnorm_plan", dtype), [
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
    them. On the card: dh, dr, x and residual in the element type, bf16 or
    f32 (the gated form: f32 x, the gate in the element type read through
    its row stride), f32 w; dx = dresidual is one tensor of the element
    type, the gated dy f32 and dgate in the gate's dtype (contiguous), dw
    f32.
    One call is counted in ``fused_rmsnorm_bwd.launches``: the rows'
    kernel, then the kernel that sums dw's per-block shares in a fixed
    order (no atomics: two calls give the same bits)."""
    if x.device.type == "cpu":
        return fused_rmsnorm_bwd_ref(dh, dr, x, w, residual, eps, gate)
    if x.device.type == "meta":
        t, d = x.shape
        kind = "gated" if gate is not None else "plain" if residual is None else "residual"
        f32 = (x.dtype if gate is None else gate.dtype) == torch.float32
        _build.meta_launch(fused_rmsnorm_bwd, lambda: cost.rmsnorm_bwd(t, d, kind,
                                                                       dr is not None, f32))
        dx = torch.empty_like(x)
        second = (torch.empty_like(gate) if gate is not None
                  else dx if residual is not None else None)
        return dx, second, torch.empty(d, dtype=torch.float32, device=x.device)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm_bwd: no kernel for device {x.device}")
    gated = gate is not None
    if gated:
        _check_gate(x, gate, residual)
        if dr is not None:
            raise ValueError("fused_rmsnorm_bwd: a gated norm has no residual gradient")
    elem = element_dtype("fused_rmsnorm_bwd", x, gate)
    if dh.dtype != elem:
        raise TypeError(f"fused_rmsnorm_bwd: dh {dh.dtype} with {elem} rows not supported")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("fused_rmsnorm_bwd: x must be a contiguous (T, d) tensor")
    t, d = x.shape
    if w.shape != (d,) or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("fused_rmsnorm_bwd: w must be a contiguous float32 (d,)")
    for name, u in (("dh", dh), ("dr", dr), ("residual", residual)):
        if u is not None and (u.shape != x.shape or u.dtype != elem):
            raise ValueError(f"fused_rmsnorm_bwd: {name} must be {elem} of x's shape")
    if residual is not None and not residual.is_contiguous():
        raise ValueError("fused_rmsnorm_bwd: residual must be contiguous")
    if any(u is not None and u.device != x.device for u in (dh, dr, w, residual, gate)):
        raise ValueError("fused_rmsnorm_bwd: tensors on different devices")
    dh = dh.contiguous()
    dr = None if dr is None else dr.contiguous()
    dx = torch.empty(t, d, dtype=x.dtype, device=x.device)
    dz = torch.empty(t, d, dtype=elem, device=x.device) if gated else None
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
    fn = _build.bind("rmsnorm", _entry("rmsnorm_bwd", elem), [
        *[ctypes.c_void_p] * 10, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    opt = [None if u is None else _build.ptr(u) for u in (dr, residual, gate, dz)]
    err = fn(_build.ptr(dh), opt[0], _build.ptr(x), opt[1], opt[2], _build.ptr(w),
             _build.ptr(dx), opt[3], _build.ptr(part), _build.ptr(dw), t, d,
             gate.stride(0) if gated else 0, eps, int(vec), _build.stream_ptr(x.device))
    _build.check("rmsnorm", err)
    _build.launched(fused_rmsnorm_bwd, lambda: cost.rmsnorm_bwd(
        t, d, "gated" if gated else "plain" if residual is None else "residual",
        dr is not None, elem == torch.float32), _build.kind(elem))
    return dx, second, dw


def plan_bwd(rows: int, d: int, gated: bool = False, vec: bool = True,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    """The backward's launch for these shapes on the current card, as
    :func:`plan` gives the forward's."""
    fn = _build.bind("rmsnorm", _entry("rmsnorm_bwd_plan", dtype), [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 4)()
    _build.check("rmsnorm", fn(rows, d, int(gated), int(vec), out))
    return dict(zip(("grid", "threads", "vectors_per_thread", "vector"), out))


# ------------------------- split rows (a rank's block) -----------------------
#: The loads the split-row kernels take, in bytes, widest first: y, w, dh
#: and the outputs 16 or one element; the gate any of these down to its
#: element (a bf16 gate to 2, a float32 one to 4).
VECTOR_BYTES = (16, 8, 4, 2)
#: the split-row kernels' kinds, as ``rmsnorm_split_plan`` numbers them
SPLIT_KINDS = ("stat", "apply", "bwd_stat", "bwd_apply")


def vector_bytes(t: torch.Tensor) -> int:
    """The widest load of :data:`VECTOR_BYTES` (at least ``t``'s element)
    on which every row of ``t`` starts: its base address and every stride
    but the last (a unit one) are multiples of it."""
    size = t.element_size()
    for b in VECTOR_BYTES:
        if b >= size and t.data_ptr() % b == 0 and all(
                s * size % b == 0 for s in t.stride()[:-1]):
            return b
    return size


def split_widths(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                 dh: torch.Tensor | None = None) -> dict[str, int]:
    """Each tensor's load in a split-row launch, in bytes: y (``x``), w,
    dh and the outputs, contiguous, 16-byte vectors where d is a multiple of
    8 and each of them starts on 16 bytes (the outputs the wrapper
    allocates do), else one element; the gate the widest load its own base
    and row stride allow (:func:`vector_bytes`: Mamba2's 1804-wide bf16
    in_proj rows take 8), or one element where the others do."""
    rows = {"y": x, "w": w} | ({} if dh is None else {"dh": dh})
    vec = x.shape[-1] % 8 == 0 and all(vector_bytes(t) == 16 for t in rows.values())
    widths = {k: 16 if vec else t.element_size() for k, t in rows.items()}
    widths["gate"] = vector_bytes(gate) if vec else gate.element_size()
    return widths


def _split_checks(name: str, x, gate, w, dh=None) -> tuple[int, int, dict]:
    """The card's checks of a split-row launch: f32 x and a bf16 or f32
    gate of one (T, d) block (the gate read through its row stride), f32 w
    of d. Returns (T, d, :func:`split_widths`)."""
    _check_gate(x, gate, None)
    if x.dtype != torch.float32 or gate.dtype not in _DTYPES:
        raise TypeError(f"{name}: x {x.dtype} with a {gate.dtype} gate not supported")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (T, d) tensor")
    t, d = x.shape
    if w.shape != (d,) or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"{name}: w must be a contiguous float32 (d,)")
    if any(u.device != x.device for u in (gate, w, *([] if dh is None else [dh]))):
        raise ValueError(f"{name}: tensors on different devices")
    widths = split_widths(x, gate, w, dh)
    if d > (MAX_D_GATED if widths["y"] == 16 else MAX_D_SCALAR):
        raise ValueError(f"{name}: d {d} wider than the kernel takes here ({MAX_D_GATED} "
                         f"with 16-byte rows, {MAX_D_SCALAR} otherwise)")
    return t, d, widths


def _on_card(name: str, x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def _fwd_split(x, gate, w, y, stat_out, stats, t, d, dn, eps, widths):
    fn = _build.bind("rmsnorm_split", _entry("rmsnorm_fwd_split", gate.dtype), [
        *[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    opt = [None if u is None else _build.ptr(u) for u in (y, stat_out, stats)]
    err = fn(_build.ptr(x), _build.ptr(gate), _build.ptr(w), *opt, t, d, dn,
             gate.stride(0), eps, int(widths["y"] == 16), widths["gate"],
             _build.stream_ptr(x.device))
    _build.check("rmsnorm_split", err)


def plan_split(kind: str, rows: int, d: int, vec: bool = True, gate_bytes: int = 16,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch a split-row call of ``kind`` (:data:`SPLIT_KINDS`) makes
    at these shapes and widths on the current card (``vec`` the contiguous
    tensors' 16-byte vectors, ``gate_bytes`` the gate's load): blocks,
    threads a block, threads a row, chunks a thread, elements a chunk, the
    gate's load. Raises for a width the kernels do not take."""
    fn = _build.bind("rmsnorm_split", "rmsnorm_split_plan", [
        *[ctypes.c_int] * 6, ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 6)()
    _build.check("rmsnorm_split", fn(SPLIT_KINDS.index(kind), rows, d, int(vec), gate_bytes,
                                     int(dtype == torch.float32), out))
    return dict(zip(("grid", "threads", "threads_a_row", "chunks_a_thread", "chunk",
                     "gate_bytes"), out))


def gated_norm_stat(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The split-row gated norm's statistic launch over this rank's block
    (x f32 and gate bf16 or f32 (T, d), w (d,), read for the launch's plan
    only): each row's f32 sum of g² = (x·silu(gate))² over the block, (T,)."""
    f32 = gate.dtype == torch.float32
    if x.device.type == "meta":
        _build.meta_launch(gated_norm_stat, lambda: cost.rmsnorm(*x.shape, "gated_stat",
                                                                 f32=f32))
        return torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if not _on_card("gated_norm_stat", x):
        return gated_norm_stat_ref(x, gate)
    t, d, widths = _split_checks("gated_norm_stat", x, gate, w)
    out = torch.empty(t, dtype=torch.float32, device=x.device)
    if t:
        _fwd_split(x, gate, w, None, out, None, t, d, d, 0.0, widths)
        _build.launched(gated_norm_stat, lambda: cost.rmsnorm(t, d, "gated_stat", f32=f32),
                        _build.kind(gate.dtype))
    return out


def gated_norm_apply(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                     stats: torch.Tensor, dn: int, eps: float = 1e-6) -> torch.Tensor:
    """The split-row gated norm's apply launch: g normalised by the row's
    mean square over the full width ``dn`` (``stats``, (T,) f32, the sum of
    g² over every rank's block), times this block's ``w``; (T, d) in the
    gate's dtype."""
    f32 = gate.dtype == torch.float32
    if x.device.type == "meta":
        _build.meta_launch(gated_norm_apply, lambda: cost.rmsnorm(*x.shape, "gated_apply",
                                                                  f32=f32))
        return torch.empty(x.shape, dtype=gate.dtype, device=x.device)
    if not _on_card("gated_norm_apply", x):
        return gated_norm_apply_ref(x, gate, w, stats, dn, eps)
    t, d, widths = _split_checks("gated_norm_apply", x, gate, w)
    if stats.shape != (t,) or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError("gated_norm_apply: stats must be a contiguous float32 (T,)")
    y = torch.empty(t, d, dtype=gate.dtype, device=x.device)
    if t:
        _fwd_split(x, gate, w, y, None, stats, t, d, dn, eps, widths)
        _build.launched(gated_norm_apply, lambda: cost.rmsnorm(t, d, "gated_apply", f32=f32),
                        _build.kind(gate.dtype))
    return y


def _bwd_split(dh, x, gate, w, stat_out, stats, t, d, dn, eps, widths):
    dx = dz = part = dw = None
    if stat_out is None:
        dx = torch.empty(t, d, dtype=torch.float32, device=x.device)
        dz = torch.empty(t, d, dtype=gate.dtype, device=x.device)
        part = torch.empty(min(t, BWD_MAX_BLOCKS), d, dtype=torch.float32,
                           device=x.device)
        dw = torch.empty(d, dtype=torch.float32, device=x.device)
    fn = _build.bind("rmsnorm_split", _entry("rmsnorm_bwd_split", gate.dtype), [
        *[ctypes.c_void_p] * 10, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    opt = [None if u is None else _build.ptr(u)
           for u in (dx, dz, part, dw, stat_out, stats)]
    err = fn(_build.ptr(dh), _build.ptr(x), _build.ptr(gate), _build.ptr(w), *opt,
             t, d, dn, gate.stride(0), eps, int(widths["y"] == 16), widths["gate"],
             _build.stream_ptr(x.device))
    _build.check("rmsnorm_split", err)
    return dx, dz, dw


def _bwd_split_checks(name, dh, x, gate, w):
    if dh.shape != x.shape or dh.dtype != gate.dtype:
        raise ValueError(f"{name}: dh must be of x's shape in the gate's dtype")
    dh = dh.contiguous()
    t, d, widths = _split_checks(name, x, gate, w, dh)
    if d > (MAX_D_BWD if widths["y"] == 16 else MAX_D_SCALAR):
        raise ValueError(f"{name}: d {d} wider than the backward takes here")
    return dh, t, d, widths


def gated_norm_bwd_stat(dh: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """The split-row backward's statistic launch: each row's f32 sums over
    this block of g² and of w·dh·g, (T, 2)."""
    f32 = gate.dtype == torch.float32
    if x.device.type == "meta":
        _build.meta_launch(gated_norm_bwd_stat, lambda: cost.rmsnorm_bwd(
            *x.shape, "gated_stat", f32=f32))
        return torch.empty(x.shape[0], 2, dtype=torch.float32, device=x.device)
    if not _on_card("gated_norm_bwd_stat", x):
        return gated_norm_bwd_stat_ref(dh, x, gate, w)
    dh, t, d, widths = _bwd_split_checks("gated_norm_bwd_stat", dh, x, gate, w)
    out = torch.empty(t, 2, dtype=torch.float32, device=x.device)
    if t:
        _bwd_split(dh, x, gate, w, out, None, t, d, d, 0.0, widths)
        _build.launched(gated_norm_bwd_stat, lambda: cost.rmsnorm_bwd(
            t, d, "gated_stat", f32=f32), _build.kind(gate.dtype))
    return out


def gated_norm_bwd_apply(dh: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
                         w: torch.Tensor, stats: torch.Tensor, dn: int,
                         eps: float = 1e-6):
    """The split-row backward's apply launch, given both row sums over every
    block (``stats`` (T, 2) f32): (dx f32, dgate in the gate's dtype, dw
    f32 of this block's columns), as :func:`fused_rmsnorm_bwd`'s gated form
    over the whole row gives them."""
    f32 = gate.dtype == torch.float32
    if x.device.type == "meta":
        _build.meta_launch(gated_norm_bwd_apply, lambda: cost.rmsnorm_bwd(
            *x.shape, "gated_apply", f32=f32))
        return (torch.empty_like(x), torch.empty(x.shape, dtype=gate.dtype, device=x.device),
                torch.empty(x.shape[1], dtype=torch.float32, device=x.device))
    if not _on_card("gated_norm_bwd_apply", x):
        return gated_norm_bwd_apply_ref(dh, x, gate, w, stats, dn, eps)
    dh, t, d, widths = _bwd_split_checks("gated_norm_bwd_apply", dh, x, gate, w)
    if stats.shape != (t, 2) or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError("gated_norm_bwd_apply: stats must be a contiguous float32 (T, 2)")
    if t == 0:
        return (torch.empty(0, d, dtype=torch.float32, device=x.device),
                torch.empty(0, d, dtype=gate.dtype, device=x.device),
                torch.zeros(d, dtype=torch.float32, device=x.device))
    out = _bwd_split(dh, x, gate, w, None, stats, t, d, dn, eps, widths)
    _build.launched(gated_norm_bwd_apply, lambda: cost.rmsnorm_bwd(
        t, d, "gated_apply", f32=f32), _build.kind(gate.dtype))
    return out


def split_gated_rmsnorm(x: torch.Tensor, w: torch.Tensor, gate: torch.Tensor,
                        group, dn: int, eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm(x·silu(gate), w) of rows split over ``group``'s ranks: x, gate
    (T, d) and w (d,) this rank's block of columns, ``dn`` the full width.
    The row sums are all-reduced over ``group`` between the statistic and
    apply launches, forward and backward. Returns (T, d) in the gate's
    dtype. Differentiable (:class:`_SplitGatedNorm`)."""
    from ...parallel.dist import all_reduce
    _check_gate(x, gate, None)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, gate)):
        return _SplitGatedNorm.apply(x, w, gate, group, dn, eps)
    stats = all_reduce(gated_norm_stat(x, gate, w), group)
    return gated_norm_apply(x, gate, w, stats, dn, eps)


class _SplitGatedNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gate, group, dn, eps):
        from ...parallel.dist import all_reduce
        stats = all_reduce(gated_norm_stat(x, gate, w), group)
        ctx.save_for_backward(x, w, gate)
        ctx.group, ctx.dn, ctx.eps = group, dn, eps
        return gated_norm_apply(x, gate, w, stats, dn, eps)

    @staticmethod
    def backward(ctx, dh):
        from ...parallel.dist import all_reduce
        x, w, gate = ctx.saved_tensors
        stats = all_reduce(gated_norm_bwd_stat(dh, x, gate, w), ctx.group)
        dx, dz, dw = gated_norm_bwd_apply(dh, x, gate, w, stats, ctx.dn, ctx.eps)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None,
                dz if need[2] else None, None, None, None)


fused_rmsnorm.launches = 0
fused_rmsnorm_bwd.launches = 0
gated_norm_stat.launches = 0
gated_norm_apply.launches = 0
gated_norm_bwd_stat.launches = 0
gated_norm_bwd_apply.launches = 0
