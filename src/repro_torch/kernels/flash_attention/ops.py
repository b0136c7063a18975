"""Wrappers of the flash-attention kernels: the forward, the forward with
LSE, and the two backward kernels, tied together for training by
:func:`flash_attention_train` (a ``torch.autograd.Function``).

A CUDA tensor goes to the kernels: bfloat16 to ``csrc/flash_attention.cu``
(tensor cores), float32 to ``csrc/flash_attention_f32.cu`` (at float32
accuracy: the forward, dK/dV and dQ on the TF32 tensor cores with each
operand split in two TF32 terms), each at head dims 16, 32, 64 and 128; any
other dtype or head dim raises. A CPU tensor goes to the plain versions in
:mod:`.ref`.
Each kernel's wrapper counts its launches in ``<wrapper>.launches``, and by
instantiation (``"bf16/hd128"``, ``"f32/hd16"``, ...) in
``<wrapper>.by_kind``.

Q, K, V (and dO) may be any strided views of shape (B, H, S, hd) with a
unit last stride, so the model passes its (B, S, H, hd) activations
transposed. Outputs (o, dq, dk, dv) have shape (B, heads, S, hd) and the
memory layout (B, S, heads, hd), which the model's projections read
without a copy; the LSE is (B, H, Sq) f32, contiguous.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, cost
from .ref import (attention_delta, flash_attention_bwd_dkv_ref,
                  flash_attention_bwd_dq_ref, flash_attention_fwd_lse_ref,
                  flash_attention_ref)

_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)
_LOG2E = math.log2(math.e)


def supports(hd: int, n_rep: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the forward, forward-with-LSE and backward kernels take head
    dim ``hd``, GQA group ``n_rep`` (H / Hkv) and ``dtype``: every kernel
    reads the kv head h // n_rep of query head h, so any group."""
    return hd in _HEAD_DIMS and n_rep >= 1 and dtype in _DTYPES


def _lib(q: torch.Tensor) -> tuple[str, str]:
    """(the library, the prefix of its entry points) for q's dtype."""
    if q.dtype == torch.float32:
        return "flash_attention_f32", "flash_attention_f32_"
    return "flash_attention", "flash_attention_"


def _work(fn, q, k, causal):
    """The launch's :class:`~..cost.Work`, from the shapes and the dtype."""
    b, h, sq, hd = q.shape
    return lambda: fn(b, h, k.shape[1], sq, k.shape[2], hd, causal,
                      f32=q.dtype == torch.float32)


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *more: torch.Tensor) -> None:
    """Raise on what the kernels do not take: q (B, H, Sq, hd), k = v
    (B, Hkv, Sk, hd), bf16 or f32 (all of one dtype) rows on 16 bytes on
    one card; ``more`` are further (B, H, Sq, hd) operands (dO). The
    shapes and dtypes are checked before the device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q (B, H, Sq, hd), k = v (B, Hkv, Sk, hd)")
    b, h, _, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"{name}: q and k disagree in B, hd or GQA")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: hd {hd} not in {_HEAD_DIMS}")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: dO must have q's shape")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, *more)):
        raise TypeError(f"{name}: the kernels take bfloat16 or float32 q, k, v (and "
                        f"dO) of one dtype, not {[str(t.dtype) for t in (q, k, v, *more)]}")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if any(t.device != q.device for t in (k, v, *more)):
        raise ValueError(f"{name}: tensors on different devices")
    if not all(_build.rows_aligned(t) for t in (q, k, v, *more)):
        raise ValueError(f"{name}: rows must start on 16 bytes")


def _rows(t: torch.Tensor, name: str, shape) -> None:
    """An f32 (B, H, Sq) row statistic (LSE, D) as the kernels read it."""
    if (t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous()
            or t.device.type != "cuda"):
        raise ValueError(f"{name}: lse and D must be contiguous float32 "
                         f"(B, H, Sq) on the card")


def _like_model(b: int, heads: int, s: int, hd: int, ref: torch.Tensor):
    """(B, heads, S, hd) with the (B, S, heads, hd) memory layout."""
    return torch.empty((b, s, heads, hd), dtype=ref.dtype,
                       device=ref.device).transpose(1, 2)


def _strides(*ts: torch.Tensor):
    return (ctypes.c_int64 * (3 * len(ts)))(
        *[s for t in ts for s in t.stride()[:3]])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd) -> (B, H, Sq, hd).
    Forward only: on the card it refuses inputs that want a gradient."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type == "meta":
        b, h, sq, hd = q.shape
        _build.meta_launch(flash_attention, _work(cost.flash_attention, q, k, causal))
        return _like_model(b, h, sq, hd, q)
    _check("flash_attention", q, k, v)
    _build.refuse_grad("flash_attention (forward only; "
                       "flash_attention_train differentiates)", q, k, v)
    b, h, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    o = _like_model(b, h, sq, hd, q)
    if b * h * sq == 0:
        return o
    lib, entry = _lib(q)
    fn = _build.bind(lib, entry + "fwd", [
        *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 7, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
             b, h, hkv, sq, sk, hd, int(causal), _LOG2E / math.sqrt(hd),
             _strides(q, k, v, o), _build.stream_ptr(q.device))
    _build.check(lib, err)
    _build.launched(flash_attention, _work(cost.flash_attention, q, k, causal),
                    _build.kind(q.dtype, hd))
    return o


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = True):
    """(o (B, H, Sq, hd) in q's dtype, lse (B, H, Sq) f32): the training
    forward. Takes no part in autograd itself (``flash_attention_train``
    calls it inside its ``forward``)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_ref(q, k, v, causal)
    if q.device.type == "meta":
        b, h, sq, hd = q.shape
        _build.meta_launch(flash_attention_fwd_lse,
                           _work(cost.flash_attention_fwd_lse, q, k, causal))
        return (_like_model(b, h, sq, hd, q),
                torch.empty((b, h, sq), dtype=torch.float32, device=q.device))
    _check("flash_attention_fwd_lse", q, k, v)
    b, h, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    o = _like_model(b, h, sq, hd, q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return o, lse
    lib, entry = _lib(q)
    fn = _build.bind(lib, entry + "fwd_lse", [
        *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 7, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
             _build.ptr(lse), b, h, hkv, sq, sk, hd, int(causal),
             _LOG2E / math.sqrt(hd), _strides(q, k, v, o),
             _build.stream_ptr(q.device))
    _build.check(lib, err)
    _build.launched(flash_attention_fwd_lse,
                    _work(cost.flash_attention_fwd_lse, q, k, causal),
                    _build.kind(q.dtype, hd))
    return o, lse


def flash_attention_bwd_dkv(q, k, v, do, lse, dd, causal: bool = True):
    """(dk, dv), each (B, Hkv, Sk, hd) in k's dtype, summed over the GQA
    group; ``lse`` from the forward, ``dd`` = rowsum(dO ∘ O), both
    (B, H, Sq) f32."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd, causal)
    if q.device.type == "meta":
        b, h, sq, hd = q.shape
        _, hkv, sk, _ = k.shape
        _build.meta_launch(flash_attention_bwd_dkv,
                           _work(cost.flash_attention_bwd_dkv, q, k, causal))
        return _like_model(b, hkv, sk, hd, k), _like_model(b, hkv, sk, hd, k)
    _check("flash_attention_bwd_dkv", q, k, v, do)
    b, h, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    for t in (lse, dd):
        _rows(t, "flash_attention_bwd_dkv", (b, h, sq))
    dk, dv = _like_model(b, hkv, sk, hd, k), _like_model(b, hkv, sk, hd, k)
    if b * hkv * sk == 0:
        return dk, dv
    if sq == 0:                     # no query: the gradients are zero
        return dk.zero_(), dv.zero_()
    lib, entry = _lib(q)
    fn = _build.bind(lib, entry + "bwd_dkv", [
        *[ctypes.c_void_p] * 8, *[ctypes.c_int] * 7, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    err = fn(*map(_build.ptr, (q, k, v, do, lse, dd, dk, dv)), b, h, hkv, sq,
             sk, hd, int(causal), 1.0 / math.sqrt(hd),
             _strides(q, k, v, do, dk, dv), _build.stream_ptr(q.device))
    _build.check(lib, err)
    _build.launched(flash_attention_bwd_dkv,
                    _work(cost.flash_attention_bwd_dkv, q, k, causal),
                    _build.kind(q.dtype, hd))
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, dd, causal: bool = True):
    """dq (B, H, Sq, hd) in q's dtype; arguments as for
    :func:`flash_attention_bwd_dkv`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, causal)
    if q.device.type == "meta":
        b, h, sq, hd = q.shape
        _build.meta_launch(flash_attention_bwd_dq,
                           _work(cost.flash_attention_bwd_dq, q, k, causal))
        return _like_model(b, h, sq, hd, q)
    _check("flash_attention_bwd_dq", q, k, v, do)
    b, h, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    for t in (lse, dd):
        _rows(t, "flash_attention_bwd_dq", (b, h, sq))
    dq = _like_model(b, h, sq, hd, q)
    if b * h * sq == 0:
        return dq
    if sk == 0:                     # no key: the gradient is zero
        return dq.zero_()
    lib, entry = _lib(q)
    fn = _build.bind(lib, entry + "bwd_dq", [
        *[ctypes.c_void_p] * 7, *[ctypes.c_int] * 7, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    err = fn(*map(_build.ptr, (q, k, v, do, lse, dd, dq)), b, h, hkv, sq, sk,
             hd, int(causal), 1.0 / math.sqrt(hd),
             _strides(q, k, v, do, dq), _build.stream_ptr(q.device))
    _build.check(lib, err)
    _build.launched(flash_attention_bwd_dq,
                    _work(cost.flash_attention_bwd_dq, q, k, causal),
                    _build.kind(q.dtype, hd))
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention_fwd_lse`: D = rowsum(dO ∘ O)
    in one elementwise pass, then the dK/dV and the dQ kernel."""
    if do.device.type == "cuda" and not _build.rows_aligned(do):
        do = do.contiguous()
    dd = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dd, causal)
    return flash_attention_bwd_dq(q, k, v, do, lse, dd, causal), dk, dv


class _FlashAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd_lse(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Differentiable attention (the reference's ``flash_attention_train``
    custom VJP): the forward with LSE, and a backward through the two
    backward kernels; no (Sq, Sk) tensor exists on the card in either
    direction. Shapes as :func:`flash_attention`."""
    return _FlashAttentionTrain.apply(q, k, v, causal)


flash_attention.launches = 0
flash_attention_fwd_lse.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0
