"""Wrapper of the decode-attention kernel.

A CUDA tensor goes to a kernel: bfloat16 to ``csrc/decode_attention.cu``,
float32 to ``csrc/decode_attention_f32.cu`` (CUDA cores, at float32
accuracy), each at head dims 16, 32, 64 and 128; any other dtype or head
dim raises. A CPU tensor goes to the plain version in :mod:`.ref`. Each
kernel is one launch per call that reads ``kv_len`` from device memory,
so a call captured into a CUDA graph stays right while the position
advances between replays; in both, a block serves every query head of a
kv head (one read of K/V a group), the blocks of a head group split
``[0, kv_len)`` among themselves and merge their partials in the same
launch through a thread-block cluster.
``decode_attention.launches`` counts the kernels' executions
(``.by_kind`` by dtype and head dim): one per eager call; a call made
while a stream is captured adds to the graph's tally instead, which each
replay adds to the counter (:func:`repro_torch.kernels._build.launched`).

K and V may be any strided view of shape (B, Hkv, S, hd) with a unit last
stride: the model passes its (B, S, Hkv, hd) cache transposed, which the
kernel reads in place.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, cost
from .ref import decode_attention_ref

_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)
_plans: dict[tuple, dict] = {}       # (B, H, Hkv, hd, cache) -> the kernel's launch plan
_scratch: dict[tuple, torch.Tensor] = {}  # (device, bytes) -> zeroed scratch


def supports(hd: int, n_rep: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the kernels take head dim ``hd``, GQA group ``n_rep`` (H /
    Hkv) and ``dtype``: in both dtypes groups 1, 2, 3, 4 and 8 are compiled
    as they are, any other runs in chunks of 8 query heads per head group,
    so any group."""
    return hd in _HEAD_DIMS and n_rep >= 1 and dtype in _DTYPES


def check_kv_len(kv_len: torch.Tensor, device: torch.device) -> None:
    """A tensor ``kv_len`` is one int32 on the query's device."""
    if kv_len.dtype != torch.int32:
        raise TypeError(f"decode_attention: kv_len must be int32, not {kv_len.dtype}")
    if kv_len.numel() != 1:
        raise ValueError(f"decode_attention: kv_len must hold one value, not "
                         f"{kv_len.numel()}")
    if kv_len.device != device:
        raise ValueError(f"decode_attention: kv_len on {kv_len.device}, q on {device}")


def plan(b: int, h: int, hkv: int, hd: int, cache: torch.dtype | None = None) -> dict:
    """The launch a call at this shape makes on the card, whatever kv_len:
    ``n_split`` blocks per head group (the cluster size), ``groups`` head
    groups, ``smem_bytes`` per block, ``cluster`` (the merge), the
    ``scratch_bytes`` the counter merge needs (0 for the cluster) and the
    ``clusters`` of that size the card runs at once. ``cache`` None: the
    bfloat16 kernel; a dtype: the float32 kernel over a cache of that dtype
    (float32 or bfloat16). Cached per shape."""
    key = (b, h, hkv, hd, cache)
    if cache is not None and key not in _plans:
        info = (ctypes.c_int64 * 4)()
        fn = _build.bind("decode_attention_f32", "decode_attention_f32_plan",
                         [*[ctypes.c_int] * 5, ctypes.POINTER(ctypes.c_int64)])
        _build.check("decode_attention_f32",
                     fn(b, h, hkv, hd, int(cache == torch.bfloat16), info))
        _plans[key] = dict(n_split=info[0], groups=info[1], smem_bytes=info[2],
                           cluster=True, scratch_bytes=0, clusters=info[3])
    if key not in _plans:
        info = (ctypes.c_int64 * 6)()
        fn = _build.bind("decode_attention", "decode_attention_plan",
                         [*[ctypes.c_int] * 4, ctypes.POINTER(ctypes.c_int64)])
        _build.check("decode_attention", fn(b, h, hkv, hd, info))
        _plans[key] = dict(n_split=info[0], groups=info[1], smem_bytes=info[2],
                           cluster=bool(info[3]), scratch_bytes=info[4],
                           clusters=info[5])
    return _plans[key]


def _scratch_for(device: torch.device, nbytes: int) -> torch.Tensor:
    """The counter merge's scratch: allocated and zeroed once per device and
    size; the kernel leaves its counters at zero after every launch."""
    key = (device, nbytes)
    if key not in _scratch:
        _scratch[key] = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    return _scratch[key]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernels do not take, the shapes and dtypes before
    the device: q (B, H, hd), k = v (B, Hkv, S, hd), hd in _HEAD_DIMS, H a
    multiple of Hkv; bf16 q with a bf16 cache, or a float32 q with a
    float32 cache or the bf16 cache a float32 model keeps."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention: q (B, H, hd), k = v (B, Hkv, S, hd)")
    b, h, hd = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError("decode_attention: q and k disagree in B or hd")
    if h % hkv or not supports(hd, h // hkv):
        raise ValueError(f"decode_attention: hd {hd} not in {_HEAD_DIMS} or "
                         f"{h} query heads not a multiple of {hkv} kv heads")
    cache_ok = k.dtype == v.dtype and k.dtype in (q.dtype, torch.bfloat16)
    if q.dtype not in _DTYPES or not cache_ok:
        raise TypeError(f"decode_attention: dtypes q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype} not supported (bfloat16, or a float32 q with a "
                        f"float32 or bfloat16 cache)")
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len, return_lse: bool = True):
    """q: (B, H, hd); k, v: (B, Hkv, S, hd); kv_len: the valid prefix, a
    one-element int32 tensor on q's device (the decode path's), or a Python
    int (turned into one). Returns o [, lse]. The kernels take a bfloat16 q
    with a bfloat16 cache, or a float32 q with a float32 cache or the bf16
    cache a float32 model keeps; they clamp kv_len to [0, S]."""
    if isinstance(kv_len, torch.Tensor):
        check_kv_len(kv_len, q.device)
    if q.device.type == "cpu":
        o, lse = decode_attention_ref(q, k, v, kv_len, return_lse=True)
        return (o, lse) if return_lse else o
    if q.device.type == "meta":     # the dry run: every key of the cache
        b, h, hd = q.shape
        _build.meta_launch(decode_attention, lambda: cost.decode_attention(
            b, h, k.shape[1], hd, k.shape[2], f32=q.dtype == torch.float32,
            cache_bytes=k.element_size()))
        o = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
        return (o, lse) if return_lse else o
    _check(q, k, v)
    _build.refuse_grad("decode_attention", q, k, v)
    b, h, hd = q.shape
    _, hkv, s, _ = k.shape
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("decode_attention: tensors on different devices")
    if not all(_build.rows_aligned(t) for t in (q, k, v)):
        raise ValueError("decode_attention: rows must start on 16 bytes")
    if not isinstance(kv_len, torch.Tensor):
        kv_len = torch.full((1,), max(0, min(int(kv_len), s)), dtype=torch.int32,
                            device=q.device)
    o = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    f32 = q.dtype == torch.float32
    strides = (ctypes.c_int64 * 8)(q.stride(0), q.stride(1), *k.stride()[:3],
                                   *v.stride()[:3])

    def work():
        return cost.decode_attention(b, h, hkv, hd, max(0, min(int(kv_len.item()), s)),
                                     f32=f32, cache_bytes=k.element_size())
    if f32:
        fn = _build.bind("decode_attention_f32", "decode_attention_f32_fwd", [
            *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 6,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])
        if b * h:
            err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
                     _build.ptr(lse), _build.ptr(kv_len), b, h, hkv, s, hd,
                     int(k.dtype == torch.bfloat16), strides,
                     math.log2(math.e) / math.sqrt(hd), _build.stream_ptr(q.device))
            _build.check("decode_attention_f32", err)
            _build.launched(decode_attention, work, _build.kind(q.dtype, hd))
        return (o, lse) if return_lse else o
    nbytes = plan(b, h, hkv, hd)["scratch_bytes"]
    scratch = _build.ptr(_scratch_for(q.device, nbytes)) if nbytes else None
    fn = _build.bind("decode_attention", "decode_attention_fwd", [
        *[ctypes.c_void_p] * 7, *[ctypes.c_int] * 5,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
             _build.ptr(lse), _build.ptr(kv_len), scratch, b, h, hkv, s, hd,
             strides, math.log2(math.e) / math.sqrt(hd),
             _build.stream_ptr(q.device))
    _build.check("decode_attention", err)
    _build.launched(decode_attention, work, _build.kind(q.dtype, hd))
    return (o, lse) if return_lse else o


decode_attention.launches = 0
