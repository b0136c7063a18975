"""Plain PyTorch version of the Mamba2 SSD chunk scan (arXiv:2405.21060).

Per chunk of Q positions, with csum the running sum of dA inside the chunk,
L[i,j] = exp(csum_i - csum_j) for i >= j and 0 above the diagonal:

  y = (C Bᵀ ⊙ L)(x·dt) + (C h)·exp(csum)
  h ← h·exp(csum_Q) + Bᵀ(x·dt·exp(csum_Q - csum))

All math in float32, as the reference casts every input to float32. The
result does not depend on the chunk length up to float32 rounding, so
:func:`ssd_scan_ref` uses the kernel's tile (``CHUNK``) and pads a ragged
tail with zeros, which is exact: a padded row has x·dt = 0 and dA = 0, so
it adds nothing to y or h and keeps the decay at 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: Rows per chunk in the CUDA kernel; the plain version uses the same.
CHUNK = 64


def ssd_chunk_ref(x, dt, B, C, dA, h_in):
    """One chunk. x (..., Q, P), dt/dA (..., Q), B/C (..., Q, N),
    h_in (..., N, P). Returns (y (..., Q, P), h_out (..., N, P)), f32."""
    x, dt, B, C, dA, h_in = (t.float() for t in (x, dt, B, C, dA, h_in))
    q = x.shape[-2]
    csum = torch.cumsum(dA, dim=-1)                          # (..., Q)
    diff = csum[..., :, None] - csum[..., None, :]           # (..., Q, Q)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    # exp only where i >= j: above the diagonal diff > 0 may overflow
    L = torch.exp(torch.where(causal, diff, torch.zeros_like(diff)))
    L = torch.where(causal, L, torch.zeros_like(L))
    xdt = x * dt[..., None]                                  # (..., Q, P)
    y = ((C @ B.transpose(-1, -2)) * L) @ xdt
    y = y + (C @ h_in) * torch.exp(csum)[..., None]
    decay_out = torch.exp(csum[..., -1:] - csum)[..., None]  # (..., Q, 1)
    h_out = (h_in * torch.exp(csum[..., -1])[..., None, None]
             + B.transpose(-1, -2) @ (xdt * decay_out))
    return y, h_out


def ssd_scan_ref(x, dt, B, C, dA):
    """The whole sequence, state carried across chunks from zero.

    x (..., S, P); dt/dA (..., S); B/C (..., S, N), any S >= 1. Returns
    y (..., S, P) and the final state h (..., P, N), both float32 (the
    state in the model's orientation: the Pallas kernel's is (..., N, P)).
    """
    s, p = x.shape[-2:]
    n = B.shape[-1]
    pad = -s % CHUNK
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (x, B, C))
        dt, dA = (F.pad(t, (0, pad)) for t in (dt, dA))
    lead = torch.broadcast_shapes(x.shape[:-2], dt.shape[:-1], B.shape[:-2],
                                  C.shape[:-2], dA.shape[:-1])
    h = torch.zeros(*lead, n, p, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s + pad, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        y, h = ssd_chunk_ref(x[..., sl, :], dt[..., sl], B[..., sl, :],
                             C[..., sl, :], dA[..., sl], h)
        ys.append(y)
    return torch.cat(ys, dim=-2)[..., :s, :], h.transpose(-1, -2)
