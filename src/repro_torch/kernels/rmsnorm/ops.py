"""Wrapper of the fused residual add + RMSNorm kernel.

A CUDA tensor goes to the kernel in ``csrc/rmsnorm.cu``; a CPU tensor goes
to the plain version in :mod:`.ref`. ``fused_rmsnorm.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import fused_rmsnorm_ref


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor,
                  residual: torch.Tensor | None = None, eps: float = 1e-6):
    """x, residual: (T, d); w: (d,) float32. Returns (normed, new_residual),
    both (T, d) in x's dtype. The kernel takes bfloat16 x only."""
    if x.device.type == "cpu":
        return fused_rmsnorm_ref(x, w, residual, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm: no kernel for device {x.device}")
    _build.refuse_grad("fused_rmsnorm", x, w, residual)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_rmsnorm: dtype {x.dtype} not supported")
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
    y = torch.empty_like(x)
    rout = torch.empty_like(x)
    if t == 0:
        return y, rout
    vec = int(d * x.element_size() % 16 == 0
              and all(u.data_ptr() % 16 == 0 for u in (*tensors, y, rout)))
    fn = _build.bind("rmsnorm", "rmsnorm_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p])
    err = fn(_build.ptr(x),
             _build.ptr(residual) if residual is not None else None,
             _build.ptr(w), _build.ptr(y), _build.ptr(rout), t, d, eps, vec,
             _build.stream_ptr(x.device))
    _build.check("rmsnorm", err)
    _build.launched(fused_rmsnorm)
    return y, rout


fused_rmsnorm.launches = 0
