"""Wrapper of the SSD chunk-scan kernel, and the scan's gradient.

A CUDA tensor goes to the kernel in ``csrc/ssd.cu``; a CPU tensor goes to
the plain version in :mod:`.ref`. ``ssd_chunk.launches`` counts the
kernel's launches.

Where autograd records, the call goes through a ``torch.autograd.Function``
on either device: the same forward (the kernel on the card), and a backward
in plain tensor code by design (:func:`ssd_chunk_bwd_plain`): it recomputes
the scan through :func:`.ref.ssd_scan_ref` under autograd and takes the
gradients of x, dt, B, C and dA from it. No backward kernel exists yet
(ROADMAP.md queue 2); ``ssd_chunk_bwd_plain.calls`` counts the backward's
calls, on either device.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, cost
from .ref import ssd_scan_ref

#: Largest state width and state size whose tiles fit a block's shared memory.
MAX_P = MAX_N = 128


def stored_numel(t: torch.Tensor) -> int:
    """Elements a view reads from memory: its size along every dimension
    of non-zero stride (B/C shared by the heads have a head stride of 0)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


def _seq_head_pos(t: torch.Tensor, four_d: bool) -> tuple[int, int, int]:
    """Element strides (sequence, head, position) of a (B, S, H, ...)
    tensor, or of a (BH, S, ...) one read as one sequence of BH heads."""
    if four_d:
        return t.stride(0), t.stride(2), t.stride(1)
    return 0, t.stride(0), t.stride(1)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, dA: torch.Tensor):
    """The Mamba2 SSD scan over whole sequences, state from zero.

    Two layouts:
      model:  x (B, S, H, P), dt/dA (B, S, H), B/C (B, S, H, N);
      Pallas: x (BH, S, P), dt/dA (BH, S), B/C (BH, S, N).
    Inputs are read through their strides, so B/C shared by all heads may
    be passed with a head stride of 0 (``B[:, :, None].expand(...)``). x, B
    and C are float32 or bfloat16 (one dtype), dt and dA float32. Any
    S >= 1 is taken, not only the reference's S <= 128 or S % 128 == 0.

    Returns y, float32 and contiguous in x's shape (without the D skip),
    and the final state, float32, (B, H, P, N) or (BH, P, N): the model's
    orientation, the transpose of the Pallas kernel's (BH, N, P).
    Differentiable: where autograd records, through :class:`_SSDChunk`.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, B, C, dA)):
        return _SSDChunk.apply(x, dt, B, C, dA)
    return _forward(x, dt, B, C, dA)


class _SSDChunk(torch.autograd.Function):
    """:func:`ssd_chunk` with :func:`ssd_chunk_bwd_plain` as its backward.
    Saves the inputs as given (B/C at head stride 0 stay views)."""

    @staticmethod
    def forward(ctx, x, dt, B, C, dA):
        ctx.save_for_backward(x, dt, B, C, dA)
        ctx.set_materialize_grads(False)
        return _forward(x, dt, B, C, dA)

    @staticmethod
    def backward(ctx, gy, gh):
        return ssd_chunk_bwd_plain(ctx.saved_tensors, ctx.needs_input_grad, gy, gh)


def _plain(x, dt, B, C, dA):
    """:func:`.ref.ssd_scan_ref` in either layout: y (in x's shape, f32)
    and the final state (B, H, P, N) or (BH, P, N)."""
    if x.dim() != 4:
        return ssd_scan_ref(x, dt, B, C, dA)
    y, h = ssd_scan_ref(*(t.transpose(1, 2) for t in (x, dt, B, C, dA)))
    return y.transpose(1, 2), h


def ssd_chunk_bwd_plain(inputs, needs, gy, gh):
    """The scan's gradient in plain tensor code: (x, dt, B, C, dA) detached,
    the scan recomputed through :func:`.ref.ssd_scan_ref` under autograd,
    and ``torch.autograd.grad`` of y (gradient ``gy``) and of the final
    state (``gh``; None where unused) for the inputs in ``needs``. Each
    gradient comes back in its input's shape and dtype: B/C passed as
    head-stride-0 expands get one per head, summed by the expand's own
    backward outside."""
    ssd_chunk_bwd_plain.calls += 1
    outs = [(i, g) for i, g in enumerate((gy, gh)) if g is not None]
    if not outs or not any(needs):
        return (None,) * len(inputs)
    ins = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
    with torch.enable_grad():
        res = _plain(*ins)
    wanted = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad([res[i] for i, _ in outs], wanted,
                                   [g for _, g in outs], allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in ins)


def _forward(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, dA: torch.Tensor):
    """:func:`ssd_chunk` without autograd: the kernel on the card, the
    plain version on the CPU."""
    four_d = x.dim() == 4
    if x.device.type == "cpu":
        y, h = _plain(x, dt, B, C, dA)
        return y.contiguous(), h
    if x.device.type == "meta":
        lead, n, p = x.shape[:-1], B.shape[-1], x.shape[-1]
        nb, nh = (x.shape[0], x.shape[2]) if four_d else (1, x.shape[0])
        y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        h = torch.empty(*lead[:1], *lead[2:], p, n, dtype=torch.float32,
                        device=x.device)
        _build.meta_launch(ssd_chunk, lambda: cost.ssd(nb, x.shape[1], nh, p, n, cost.ssd_bytes(
            x.numel(), x.element_size(), dt.numel(), stored_numel(B),
            B.element_size(), h.numel())))
        return y, h
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {x.device}")
    if x.dim() not in (3, 4):
        raise ValueError("ssd_chunk: x must be (B, S, H, P) or (BH, S, P)")
    lead = x.shape[:-1]
    n = B.shape[-1]
    if (B.shape != (*lead, n) or C.shape != B.shape
            or dt.shape != lead or dA.shape != lead):
        raise ValueError(f"ssd_chunk: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, dA {tuple(dA.shape)} disagree")
    if x.dtype not in (torch.float32, torch.bfloat16) or not (
            B.dtype == C.dtype == x.dtype):
        raise TypeError(f"ssd_chunk: x, B, C must share float32 or bfloat16, "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or dA.dtype != torch.float32:
        raise TypeError("ssd_chunk: dt and dA must be float32")
    if any(t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("ssd_chunk: the last dimension of x, B, C must be "
                         "contiguous")
    if any(t.device != x.device for t in (dt, B, C, dA)):
        raise ValueError("ssd_chunk: tensors on different devices")
    nb, nh = (x.shape[0], x.shape[2]) if four_d else (1, x.shape[0])
    s, p = x.shape[1], x.shape[-1]
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_chunk: P = {p}, N = {n}; the kernel takes "
                         f"P <= {MAX_P} and N <= {MAX_N}")
    if s == 0:
        raise ValueError("ssd_chunk: empty sequence")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    h = torch.empty(*lead[:1], *lead[2:], p, n, dtype=torch.float32,
                    device=x.device)
    strides = [v for t in (x, dt, dA, B, C, y)
               for v in _seq_head_pos(t, four_d)]
    fn = _build.bind("ssd", "ssd_chunk_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    err = fn(_build.ptr(x), _build.ptr(dt), _build.ptr(dA), _build.ptr(B),
             _build.ptr(C), _build.ptr(y), _build.ptr(h), nb, nh, s, p, n,
             int(x.dtype == torch.bfloat16),
             (ctypes.c_longlong * len(strides))(*strides),
             _build.stream_ptr(x.device))
    _build.check("ssd", err)
    _build.launched(ssd_chunk, lambda: cost.ssd(nb, s, nh, p, n, cost.ssd_bytes(
        x.numel(), x.element_size(), dt.numel(), stored_numel(B),
        B.element_size(), h.numel())))
    return y, h


ssd_chunk.launches = 0
ssd_chunk_bwd_plain.calls = 0
