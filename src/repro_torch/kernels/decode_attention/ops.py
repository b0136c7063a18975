"""Wrapper of the split-KV decode-attention kernel.

A CUDA tensor goes to the kernel in ``csrc/decode_attention.cu``; a CPU
tensor goes to the plain version in :mod:`.ref`. ``decode_attention.launches``
counts the kernel's launches (one per call: the split pass and the merge;
the kernel chooses the split count from its occupancy).

K and V may be any strided view of shape (B, Hkv, S, hd) with a unit last
stride: the model passes its (B, S, Hkv, hd) cache transposed, which the
kernel reads in place.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import decode_attention_ref

_HEAD_DIMS = (32, 64, 128)
_MAX_SPLIT = 64                     # room for partials per (b, h); the
                                    # kernel picks how many it writes


def supports(hd: int, n_rep: int) -> bool:
    """Whether the kernel takes head dim ``hd`` and GQA group ``n_rep``
    (H / Hkv): groups 1, 2, 3, 4 and 8 are compiled as they are, any other
    runs in chunks of 8 query heads per block."""
    return hd in _HEAD_DIMS and n_rep >= 1


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: int, return_lse: bool = True):
    """q: (B, H, hd); k, v: (B, Hkv, S, hd). Returns o [, lse]. The kernel
    takes bfloat16 only."""
    if q.device.type == "cpu":
        o, lse = decode_attention_ref(q, k, v, kv_len, return_lse=True)
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    _build.refuse_grad("decode_attention", q, k, v)
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention: q (B, H, hd), k = v (B, Hkv, S, hd)")
    b, h, hd = q.shape
    _, hkv, s, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError("decode_attention: q and k disagree in B or hd")
    if h % hkv or not supports(hd, h // hkv):
        raise ValueError(f"decode_attention: hd {hd} not in {_HEAD_DIMS} or "
                         f"{h} query heads not a multiple of {hkv} kv heads")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"decode_attention: dtypes q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype} not supported")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("decode_attention: tensors on different devices")
    if not all(_build.rows_aligned(t) for t in (q, k, v)):
        raise ValueError("decode_attention: rows must start on 16 bytes")
    kv_len = max(0, min(int(kv_len), s))
    o = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b * h * _MAX_SPLIT * hd,), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b * h * _MAX_SPLIT * 2,), dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_int64 * 8)(q.stride(0), q.stride(1), *k.stride()[:3],
                                   *v.stride()[:3])
    fn = _build.bind("decode_attention", "decode_attention_fwd", [
        *[ctypes.c_void_p] * 7, *[ctypes.c_int] * 6,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
             _build.ptr(lse), _build.ptr(part_acc), _build.ptr(part_ml),
             b, h, hkv, hd, kv_len, _MAX_SPLIT, strides,
             math.log2(math.e) / math.sqrt(hd), _build.stream_ptr(q.device))
    _build.check("decode_attention", err)
    decode_attention.launches += 1
    return (o, lse) if return_lse else o


decode_attention.launches = 0
