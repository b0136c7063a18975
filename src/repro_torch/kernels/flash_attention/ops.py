"""Wrapper of the flash-attention forward kernel.

A CUDA tensor goes to the kernel in ``csrc/flash_attention.cu``; a CPU
tensor goes to the plain version in :mod:`.ref`. ``flash_attention.launches``
counts the kernel's launches.

Q, K and V may be any strided views of shape (B, H, S, hd) with a unit last
stride, so the model passes its (B, S, H, hd) activations transposed. The
kernel's output has shape (B, H, Sq, hd) and the memory layout (B, Sq, H, hd),
which the model's output projection reads without a copy.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import flash_attention_ref

_HEAD_DIMS = (32, 64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd) -> (B, H, Sq, hd)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q (B, H, Sq, hd), "
                         "k = v (B, Hkv, Sk, hd)")
    b, h, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or h % hkv:
        raise ValueError("flash_attention: q and k disagree in B, hd or GQA")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: hd {hd} not in {_HEAD_DIMS}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("flash_attention: the kernel takes bfloat16 q, k, v")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: tensors on different devices")
    if not all(_build.rows_aligned(t) for t in (q, k, v)):
        raise ValueError("flash_attention: rows must start on 16 bytes")
    o = torch.empty((b, sq, h, hd), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    if b * h * sq == 0:
        return o
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *o.stride()[:3])
    fn = _build.bind("flash_attention", "flash_attention_fwd", [
        *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 7, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
             b, h, hkv, sq, sk, hd, int(causal),
             math.log2(math.e) / math.sqrt(hd), strides,
             _build.stream_ptr(q.device))
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
